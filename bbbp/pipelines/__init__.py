"""CLI pipelines mirroring the reference's script entry points (SURVEY.md §5
config system rebuild): featurize, preprocess, train_regress, train_classify,
train_bert, screen — each a `python -m bbbp.pipelines.<name>` command with
a dataclass config, replacing the reference's hardcoded module-level paths.
"""
