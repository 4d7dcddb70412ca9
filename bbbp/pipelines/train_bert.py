"""CLI alias: `python -m bbbp.pipelines.train_bert` → bbbp.train.bert_pipeline."""

from bbbp.train.bert_pipeline import main

if __name__ == "__main__":
    main()
