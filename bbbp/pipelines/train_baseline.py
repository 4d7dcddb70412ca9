"""CLI alias: `python -m bbbp.pipelines.train_baseline` → bbbp.train.baseline."""

from bbbp.train.baseline import main

if __name__ == "__main__":
    main()
