"""Estimate (CPU, SCHED_IDLE) the one untested stack-diversity axis: TREE
legs on alternative fingerprint features (morgan / rdkit-path / avalon bits
+ descriptors) as extra meta columns. Kernel-level fp diversity measured flat
(estimate_kernel_kinds), but the committed tree legs all ride the single
maccs+counts+desc matrix (_tree_features_global) — a tree on a different bit
space sees different splits, so its OOF errors may decorrelate.
"""
import os
import pickle
import sys
import time

sys.path.insert(0, "/root/repo")
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("BBBP_TRANSFER_CACHE", "/root/repo/.bench_cache")

import numpy as np

T0 = time.time()


def log(m):
    print(f"[estfp +{time.time()-T0:6.0f}s] {m}", flush=True)


from sklearn.ensemble import HistGradientBoostingRegressor
from sklearn.linear_model import LinearRegression

from bbbp.chem.featurize import fingerprints
from bbbp.pipelines.preprocess import ProcessedData
from bbbp.train.loop import kfold_indices
from bbbp.train.transfer import raw_transfer_features

data = ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw0.pkl")
y = data.y
n = len(y)
folds = kfold_indices(n, 10, 42)
reg_desc, reg_maccs, reg_counts = raw_transfer_features(data.smiles)

d = pickle.load(open("results/reg_maccs_honest_r3/oof_predictions.pkl", "rb"))
base_legs = {}
for k, v in d.items():
    if k in ("y", "stacked"):
        continue
    base_legs[k] = v / 3.0 if k in ("rf", "gbdt", "cat") else v


def r2(p):
    return float(1 - ((y - p) ** 2).sum() / ((y - y.mean()) ** 2).sum())


def stack_r2(cols):
    X = np.stack(cols, 1)
    p = LinearRegression().fit(X, y).predict(X)
    out = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        out[te] = LinearRegression().fit(X[tr], y[tr]).predict(X[te])
    return r2(p), r2(out)


def hgb_oof(X, seed=0):
    oof = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        m = HistGradientBoostingRegressor(
            max_iter=300, learning_rate=0.06, max_depth=None,
            max_leaf_nodes=31, l2_regularization=1.0,
            random_state=seed).fit(X[tr], y[tr])
        oof[te] = m.predict(X[te])
    return oof


base_cols = list(base_legs.values())
b_in, b_cf = stack_r2(base_cols)
log(f"base stack: in={b_in:.4f} crossfit={b_cf:.4f} ({len(base_cols)} legs)")

variants = {}
for kind in ("morgan", "rdkit", "avalon"):
    t0 = time.time()
    fp = fingerprints(data.smiles, kind=kind, workers=1)
    bits = fp.features.astype(np.float32)
    log(f"{kind}: bits={bits.shape} ({time.time()-t0:.0f}s)")
    X = np.concatenate([bits, reg_desc], 1)
    col = hgb_oof(X)
    variants[kind] = col
    log(f"hgb({kind}+desc) leg R2={r2(col):.4f}")
    s_in, s_cf = stack_r2(base_cols + [col])
    log(f"  + stack: in={s_in:.4f} ({s_in-b_in:+.4f})  "
        f"crossfit={s_cf:.4f} ({s_cf-b_cf:+.4f})")

# all three at once
s_in, s_cf = stack_r2(base_cols + list(variants.values()))
log(f"all 3 fp-tree legs: in={s_in:.4f} ({s_in-b_in:+.4f})  "
    f"crossfit={s_cf:.4f} ({s_cf-b_cf:+.4f})")
log("DONE")
