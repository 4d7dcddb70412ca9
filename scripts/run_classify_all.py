"""One-process tuned classification runs: 3 fingerprints x 2 protocols.
All fits share in-process compile caches (tree-search statics compile once)."""
import json
import sys
import time

sys.path.insert(0, "/root/repo")

import numpy as np

from bbbp.chem.featurize import fingerprints
from bbbp.data import load_b3db_classification
from bbbp.train.classification import (
    ClassificationTrainConfig, run_classification)

T0 = time.time()
data = load_b3db_classification()
for fp_kind in ("maccs",):
    fp = fingerprints(data.smiles, kind=fp_kind, workers=1)
    x = fp.features[fp.ok_mask]
    y = data.labels[fp.ok_mask]
    for protocol in ("reference", "honest"):
        print(f"[cls +{time.time()-T0:6.0f}s] {fp_kind} {protocol} "
              f"(tuned, n_iter=50)...", flush=True)
        cfg = ClassificationTrainConfig(
            fp_kind=fp_kind, protocol=protocol, tune=True, n_search_iter=30, search_folds=3,
            tune_models=("knn","logreg","svc","bnb","mlp","dt"),
            out_dir=f"/root/repo/results/cls_{fp_kind}_{protocol}")
        res = run_classification(cfg, x=x, y=y, verbose=True)
        out = (f"/root/repo/results/classification_{fp_kind}_{protocol}"
               f"_tuned.json")
        with open(out, "w") as f:
            json.dump(res.report, f, indent=1)
        s = res.report["stacking"]
        print(f"[cls +{time.time()-T0:6.0f}s] {fp_kind} {protocol}: "
              f"stack acc={s['accuracy']:.4f} mcc={s['mcc']:.4f} "
              f"auc={s['roc_auc']:.4f}", flush=True)
print("CLS ALL DONE", flush=True)
