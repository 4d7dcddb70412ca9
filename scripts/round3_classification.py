"""Round-3 classification campaign (VERDICT r2 item #3): full per-model
RandomizedSearchCV for ALL 10 models (deep forests included) on all three
fingerprints, reference protocol, plus an honest-protocol MACCS run and the
A1 baseline with its GridSearchCV stage.

ONE process: the shape-bucketed forest search programs compile once and serve
every fingerprint (batched_search._forest_cv buckets rows/val width).
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, "/root/repo")

import numpy as np

T0 = time.time()


def log(msg):
    print(f"[r3cls +{time.time()-T0:7.0f}s] {msg}", flush=True)


# first op doubles as the device check:
import jax
import jax.numpy as jnp

assert float(jnp.ones((64, 64)).sum()) == 4096.0
log(f"devices: {jax.devices()}")

from bbbp.chem.featurize import fingerprints
from bbbp.data import load_b3db_classification
from bbbp.train.classification import (ClassificationTrainConfig,
                                       run_classification)

data = load_b3db_classification()

summary = {}
for fp_kind in ("maccs", "morgan", "rdkit"):
    fp = fingerprints(data.smiles, kind=fp_kind, workers=1)
    x = fp.features[fp.ok_mask]
    y = data.labels[fp.ok_mask]
    # reference protocol only: the VERDICT target is "tuned >= 0.9256 on all
    # three fingerprints" (reference protocol); the honest-protocol tuned
    # MACCS run is committed from round 2. Learning curves on MACCS only
    # (the flagship artifact set) to bound forest fit count.
    for protocol in ("reference",):
        log(f"{fp_kind} {protocol} tuned run (all 10 models)...")
        cfg = ClassificationTrainConfig(
            fp_kind=fp_kind, protocol=protocol, tune=True,
            n_search_iter=30, n_search_iter_forest=8, search_folds=3,
            tune_models=None,            # ALL models, deep forests included
            with_learning_curves=(fp_kind == "maccs"),
            out_dir=f"/root/repo/results/cls_{fp_kind}_{protocol}_r3")
        res = run_classification(cfg, x=x, y=y, verbose=True)
        out = (f"/root/repo/results/classification_{fp_kind}_{protocol}"
               f"_tuned_r3.json")
        with open(out, "w") as f:
            json.dump(res.report, f, indent=1)
        s = res.report["stacking"]
        summary[f"{fp_kind}_{protocol}"] = {
            "acc": s["accuracy"], "mcc": s["mcc"], "auc": s["roc_auc"]}
        log(f"{fp_kind} {protocol}: stack acc={s['accuracy']:.4f} "
            f"mcc={s['mcc']:.4f} auc={s['roc_auc']:.4f}")

# ---- A1 baseline with its GridSearchCV stage (morgan like the reference) ---
from bbbp.train.baseline import BaselineConfig, run_baseline

for fp_kind in ("morgan",):
    log(f"A1 baseline grid-search run ({fp_kind})...")
    rep = run_baseline(BaselineConfig(
        fp_kind=fp_kind, tune=True,
        out_dir=f"/root/repo/results/baseline_{fp_kind}_r3"), verbose=True)
    with open(f"/root/repo/results/baseline_{fp_kind}_tuned_r3.json",
              "w") as f:
        json.dump(rep, f, indent=1)
    summary[f"baseline_{fp_kind}"] = {
        m: r["accuracy"] for m, r in rep.items() if not m.startswith("_")}

with open("/root/repo/results/r3_classification_summary.json", "w") as f:
    json.dump(summary, f, indent=1)
log("ALL DONE")
