"""Estimate (CPU, SCHED_IDLE) the stack-level gain from running the TREE
legs at 20-fold instead of 10-fold CV (more training rows per fold; measured
+0.012 on a lone HistGB leg in estimate_stack_gain). Proxy substitution
isolates the effect: the real OOF columns from the committed 0.6780 honest
run stay fixed, except gbdt/rf are replaced by the SAME proxy model computed
at 10-fold (arm A) vs 20-fold (arm B); delta(B, A) is the fold-count effect
for two of the three tree legs.
"""
import os
import sys
import time

sys.path.insert(0, "/root/repo")
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("BBBP_TRANSFER_CACHE", "/root/repo/.bench_cache")

import pickle

import numpy as np

T0 = time.time()


def log(m):
    print(f"[estt +{time.time()-T0:6.0f}s] {m}", flush=True)


from sklearn.ensemble import HistGradientBoostingRegressor, RandomForestRegressor
from sklearn.linear_model import LinearRegression

from bbbp.pipelines.preprocess import ProcessedData
from bbbp.train.loop import kfold_indices
from bbbp.train.regression import _tree_features_global

data = ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw0.pkl")
y = data.y
n = len(y)
folds10 = kfold_indices(n, 10, 42)

d = pickle.load(open("results/reg_maccs_honest_r3/oof_predictions.pkl", "rb"))
legs = {}
for k, v in d.items():
    if k in ("y", "stacked"):
        continue
    legs[k] = np.asarray(v, np.float64)
log(f"real legs: {sorted(legs)}")

xt = _tree_features_global(data)
log(f"tree features {xt.shape}")


def r2(p):
    return float(1 - ((y - p) ** 2).sum() / ((y - y.mean()) ** 2).sum())


def stack(cols):
    X = np.stack(cols, 1)
    p = LinearRegression().fit(X, y).predict(X)
    out = np.zeros(n)
    for i, te in enumerate(folds10):
        tr = np.concatenate([folds10[j] for j in range(10) if j != i])
        out[te] = LinearRegression().fit(X[tr], y[tr]).predict(X[te])
    return r2(p), r2(out)


def oof_proxy(model_fn, n_folds, seed=42):
    folds = kfold_indices(n, n_folds, seed)
    out = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(n_folds) if j != i])
        out[te] = model_fn().fit(xt[tr], y[tr]).predict(xt[te])
    return out


def hgb():
    return HistGradientBoostingRegressor(max_iter=300, learning_rate=0.05,
                                         random_state=0)


def rfp():
    return RandomForestRegressor(n_estimators=300, max_depth=30, n_jobs=1,
                                 random_state=0)


cols = {}
for name, fn in (("hgb", hgb), ("rfp", rfp)):
    for k in (10, 20):
        key = f"{name}{k}"
        cols[key] = oof_proxy(fn, k)
        log(f"{key}: leg OOF R2={r2(cols[key]):.4f}")

order = [k for k in ("nn", "smiles", "graph", "rf", "gbdt", "cat", "knn",
                     "ridge", "tknn", "tkrr", "ckrr", "transfer")
         if k in legs]
base_in, base_cv = stack([legs[k] for k in order])
log(f"control stack (real legs): in={base_in:.4f} cv={base_cv:.4f}")


def arm(n_folds):
    sub = dict(legs)
    sub["gbdt"] = cols[f"hgb{n_folds}"]
    sub["rf"] = cols[f"rfp{n_folds}"]
    return stack([sub[k] for k in order])


a_in, a_cv = arm(10)
b_in, b_cv = arm(20)
log(f"arm A (proxies@10): in={a_in:.4f} cv={a_cv:.4f}")
log(f"arm B (proxies@20): in={b_in:.4f} cv={b_cv:.4f}")
log(f"fold-count effect (2 of 3 tree legs): in {b_in-a_in:+.4f} "
    f"cv {b_cv-a_cv:+.4f}")
log("DONE")
