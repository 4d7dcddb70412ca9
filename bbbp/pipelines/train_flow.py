"""CLI alias: `python -m bbbp.pipelines.train_flow` → bbbp.train.flow_pipeline."""

from bbbp.train.flow_pipeline import main

if __name__ == "__main__":
    main()
