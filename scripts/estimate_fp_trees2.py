"""Estimate (CPU, SCHED_IDLE) whether an RF on morgan bits adds anything ON
TOP of the adopted morgan GBDT leg (estimate_fp_trees.py, fp_tree_legs) —
different algorithm, same bit space. Also: GBDT on morgan bits WITHOUT the
descriptor block (is the gain the bits or the pairing?)."""
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
    print(f"[estfp2 +{time.time()-T0:6.0f}s] {m}", flush=True)


from sklearn.ensemble import HistGradientBoostingRegressor, RandomForestRegressor
from sklearn.linear_model import LinearRegression

from bbbp.chem.featurize import fingerprints
from bbbp.pipelines.preprocess import ProcessedData
from bbbp.train.loop import kfold_indices
from bbbp.train.transfer import raw_transfer_features

data = ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw0.pkl")
y = data.y
n = len(y)
folds = kfold_indices(n, 10, 42)
reg_desc, _, _ = raw_transfer_features(data.smiles)

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


def oof_fit(make, X):
    oof = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        oof[te] = make().fit(X[tr], y[tr]).predict(X[te])
    return oof


bits = fingerprints(data.smiles, kind="morgan", workers=1).features.astype(
    np.float32)
Xd = np.concatenate([bits, reg_desc], 1)

base_cols = list(base_legs.values())
b_in, b_cf = stack_r2(base_cols)
log(f"base stack: in={b_in:.4f} crossfit={b_cf:.4f}")

hgb = lambda: HistGradientBoostingRegressor(
    max_iter=300, learning_rate=0.06, max_leaf_nodes=31,
    l2_regularization=1.0, random_state=0)
col_gbdt = oof_fit(hgb, Xd)
g_in, g_cf = stack_r2(base_cols + [col_gbdt])
log(f"+gbdt(morgan+desc): leg={r2(col_gbdt):.4f} in={g_in:.4f} cf={g_cf:.4f}")

col_gbdt_nodesc = oof_fit(hgb, bits)
s_in, s_cf = stack_r2(base_cols + [col_gbdt_nodesc])
log(f"+gbdt(morgan only): leg={r2(col_gbdt_nodesc):.4f} "
    f"in={s_in:.4f} ({s_in-b_in:+.4f}) cf={s_cf:.4f} ({s_cf-b_cf:+.4f})")

rf = lambda: RandomForestRegressor(
    n_estimators=300, max_depth=None, max_features=0.3, n_jobs=1,
    random_state=0)
col_rf = oof_fit(rf, Xd)
s_in, s_cf = stack_r2(base_cols + [col_gbdt, col_rf])
log(f"+rf(morgan+desc) on top of gbdt leg: leg={r2(col_rf):.4f} "
    f"in={s_in:.4f} ({s_in-g_in:+.4f} vs gbdt) cf={s_cf:.4f} "
    f"({s_cf-g_cf:+.4f} vs gbdt)")
log("DONE")
