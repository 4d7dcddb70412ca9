"""CLI alias: `python -m bbbp.pipelines.train_regress` → bbbp.train.regression."""

from bbbp.train.regression import main

if __name__ == "__main__":
    main()
