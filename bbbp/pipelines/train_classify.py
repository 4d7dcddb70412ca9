"""CLI alias: `python -m bbbp.pipelines.train_classify` → bbbp.train.classification."""

from bbbp.train.classification import main

if __name__ == "__main__":
    main()
