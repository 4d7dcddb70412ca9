"""Emit the missing per-model learning curves for the morgan/rdkit tuned
classification runs (VERDICT r3 missing #3 / weak #5).

Round 3 set ``with_learning_curves=(fp_kind == "maccs")`` to bound forest fit
count, leaving cls_morgan_reference_r3/ and cls_rdkit_reference_r3/ with zero
curve files while the MACCS dir has all 10 (the reference emits one per base
model per run, Models/model_opt_20250130.py:589-591). This regenerates them
standalone: the run's x_tr/y_tr is reproduced deterministically (reference
protocol, seed 42 — scale+PCA on all rows, SMOTETomek, then split), and each
model's tuned params come from the run's own hyperparam_search_{m}.csv best
row (the argmax the run refit with, scoring=accuracy).

Run: python -u scripts/round4_curves.py
"""
import ast
import csv
import os
import sys
import time

sys.path.insert(0, "/root/repo")

import numpy as np

T0 = time.time()
OUT = "/root/repo/results"


def log(msg):
    print(f"[r4cv +{time.time()-T0:7.0f}s] {msg}", flush=True)


import jax
import jax.numpy as jnp

assert float(jnp.ones((64, 64)).sum()) == 4096.0
log(f"devices: {jax.devices()}")

from bbbp.chem.featurize import fingerprints
from bbbp.data import load_b3db_classification
from bbbp.ops import PCA, StandardScaler
from bbbp.ops.resample import smote_tomek
from bbbp.reporting import plots
from bbbp.train.classification import _factory_from_params
from bbbp.train.learning_curve import (learning_curve,
                                       save_learning_scores_csv)

MODELS = ("knn", "logreg", "svc", "bnb", "dt", "rf", "gb", "mlp", "xgb",
          "cat")
SEED = 42


def best_params_from_csv(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    parsed = []
    for r in rows:
        p = {}
        for k, v in r.items():
            try:
                p[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                p[k] = v
        parsed.append(p)
    best = max(parsed, key=lambda p: p["mean_accuracy"])
    return {k: v for k, v in best.items() if not k.startswith("mean_")}


data = load_b3db_classification()
for fp_kind in ("morgan", "rdkit"):
    d = f"{OUT}/cls_{fp_kind}_reference_r3"
    fp = fingerprints(data.smiles, kind=fp_kind, workers=1)
    x = fp.features[fp.ok_mask]
    y = data.labels[fp.ok_mask]
    # reference-protocol train split, exactly as run_classification builds it
    rng = np.random.default_rng(SEED)
    x = np.asarray(StandardScaler().fit_transform(x))
    x = np.asarray(PCA(30).fit_transform(x))
    xr, yr = smote_tomek(x, y, seed=SEED)
    perm = rng.permutation(len(yr))
    n_test = int(len(yr) * 0.2)
    tr = perm[n_test:]
    x_tr, y_tr = xr[tr], yr[tr]
    log(f"{fp_kind}: train split {x_tr.shape}")
    for m in MODELS:
        csv_path = os.path.join(d, f"hyperparam_search_{m}.csv")
        params = best_params_from_csv(csv_path)
        factory = _factory_from_params(m, params, SEED)
        t0 = time.time()
        sizes, trs, vas = learning_curve(factory, x_tr, y_tr, cv=3,
                                         train_sizes=(0.25, 0.5, 1.0),
                                         seed=SEED)
        save_learning_scores_csv(
            os.path.join(d, f"{m}_learning_scores.csv"), sizes, trs, vas)
        plots.learning_curve_plot(
            sizes, trs, vas, os.path.join(d, f"{m}_learning_curve.png"))
        log(f"{fp_kind} {m}: val@full={vas[-1].mean():.4f} "
            f"({time.time()-t0:.0f}s)")
log("DONE")
