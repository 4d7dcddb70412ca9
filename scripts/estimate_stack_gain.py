"""Estimate (CPU, SCHED_IDLE) two stack-level levers against the latest
honest OOF artifacts:
  A. per-kernel KRR legs (tan-MACCS / tan-bits / minmax-counts / rbf-desc
     as SEPARATE meta columns) vs the single combined ckrr column
  B. stronger GBDT settings on the true tree feature matrix (sklearn
     HistGradientBoosting proxy, honest per-fold OOF)
"""
import os
import sys
import time

sys.path.insert(0, "/root/repo")
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("BBBP_TRANSFER_CACHE", "/root/repo/.bench_cache")

import numpy as np
import pickle

T0 = time.time()


def log(m):
    print(f"[ests +{time.time()-T0:6.0f}s] {m}", flush=True)


from bbbp.train.transfer import raw_transfer_features
from bbbp.pipelines.preprocess import ProcessedData
from bbbp.train.loop import kfold_indices
from bbbp.train.regression import _tree_features_global
from sklearn.linear_model import LinearRegression

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
    # cross-fitted too
    out = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        out[te] = LinearRegression().fit(X[tr], y[tr]).predict(X[te])
    return r2(p), r2(out)


def tanimoto_K(b):
    i = b @ b.T
    u = b.sum(1)[:, None] + b.sum(1)[None] - i
    return i / np.maximum(u, 1e-9)


def minmax_K(c):
    tmax = int(c.max())
    mn = np.zeros((len(c), len(c)))
    for t in range(1, tmax + 1):
        b = (c >= t).astype(np.float64)
        mn += b @ b.T
    s = c.sum(1)
    mx = s[:, None] + s[None] - mn
    return mn / np.maximum(mx, 1e-9)


def rbf_K(x):
    from sklearn.preprocessing import StandardScaler
    xs = StandardScaler().fit_transform(x)
    sq = (xs ** 2).sum(1)
    d2 = np.maximum(sq[:, None] + sq[None] - 2 * xs @ xs.T, 0)
    return np.exp(-d2 / np.median(np.maximum(d2, 1e-9)))


def krr_oof(K, lam):
    oof = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        a = np.linalg.solve(K[np.ix_(tr, tr)] + lam * np.eye(len(tr)),
                            y[tr] - y[tr].mean())
        oof[te] = K[np.ix_(te, tr)] @ a + y[tr].mean()
    return oof


Ks = {"k_maccs": tanimoto_K((reg_maccs > 0).astype(np.float64)),
      "k_bits": tanimoto_K((reg_counts > 0).astype(np.float64)),
      "k_counts": minmax_K(reg_counts.astype(np.float64)),
      "k_desc": rbf_K(reg_desc)}
kl = {}
for name, K in Ks.items():
    kl[name] = krr_oof(K, 0.2 if name == "k_desc" else 0.06)
    log(f"{name} alone oof R2={r2(kl[name]):.4f}")

names = list(base_legs)
base_in, base_cv = stack_r2([base_legs[k] for k in names])
log(f"BASE stack ({len(names)} legs): in={base_in:.4f} cv={base_cv:.4f}")
plus_in, plus_cv = stack_r2([base_legs[k] for k in names] + list(kl.values()))
log(f"+4 per-kernel legs: in={plus_in:.4f} cv={plus_cv:.4f}")
repl = [base_legs[k] for k in names if k != "ckrr"] + list(kl.values())
ri, rc = stack_r2(repl)
log(f"replace ckrr with 4 kernels: in={ri:.4f} cv={rc:.4f}")

# ---- B: stronger GBDT on the true tree matrix ------------------------------
xt = _tree_features_global(data)
log(f"tree matrix: {xt.shape}")
from sklearn.ensemble import HistGradientBoostingRegressor


def hgb_oof(**kw):
    oof = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        m = HistGradientBoostingRegressor(random_state=0, **kw).fit(
            xt[tr], y[tr])
        oof[te] = m.predict(xt[te])
    return oof


for kw in (dict(max_iter=300, learning_rate=0.05, max_depth=None),
           dict(max_iter=1000, learning_rate=0.02, max_depth=None),
           dict(max_iter=1000, learning_rate=0.02, max_depth=6,
                l2_regularization=1.0),
           dict(max_iter=2000, learning_rate=0.01, max_leaf_nodes=63,
                l2_regularization=1.0),
           ):
    p = hgb_oof(**kw)
    log(f"hgb {kw}: oof R2={r2(p):.4f}")
    si, sc = stack_r2([base_legs[k] for k in names] + list(kl.values()) + [p])
    log(f"  stack with it: in={si:.4f} cv={sc:.4f}")
log("DONE")
