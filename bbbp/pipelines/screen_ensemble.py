"""CLI alias: `python -m bbbp.pipelines.screen_ensemble` → bbbp.train.weighted_ensemble."""

from bbbp.train.weighted_ensemble import main

if __name__ == "__main__":
    main()
