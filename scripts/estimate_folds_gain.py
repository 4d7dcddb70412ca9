"""Estimate (CPU, SCHED_IDLE) protocol-legitimate stack levers:
  A. split-repeat averaging of the kernel legs (2x/4x) — expectation for
     RegressionTrainConfig.split_repeats
  B. more folds per leg: 20-fold and exact LOO for the KRR legs (closed
     form), 20-fold for the HGB tree proxy
Stack estimates reuse the corrected followup OOF for the NN/graph/smiles
legs (those stay 10-fold)."""
import os
import sys
import time
import pickle

sys.path.insert(0, "/root/repo")
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("BBBP_TRANSFER_CACHE", "/root/repo/.bench_cache")

import numpy as np

T0 = time.time()


def log(m):
    print(f"[estf +{time.time()-T0:6.0f}s] {m}", flush=True)


from bbbp.train.transfer import raw_transfer_features
from bbbp.pipelines.preprocess import ProcessedData
from bbbp.train.loop import kfold_indices
from bbbp.train.regression import _tree_features_global
from sklearn.linear_model import LinearRegression

data = ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw0.pkl")
y = data.y
n = len(y)
folds10 = kfold_indices(n, 10, 42)
reg_desc, reg_maccs, reg_counts = raw_transfer_features(data.smiles)
d = pickle.load(open("results/reg_maccs_honest_r3/oof_predictions.pkl", "rb"))
base_legs = {k: (v / 3.0 if k in ("rf", "gbdt", "cat") else v)
             for k, v in d.items() if k not in ("y", "stacked")}


def r2(p):
    return float(1 - ((y - p) ** 2).sum() / ((y - y.mean()) ** 2).sum())


def stack_r2(cols):
    X = np.stack(cols, 1)
    p = LinearRegression().fit(X, y).predict(X)
    return r2(p)


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


def krr_oof(K, lam, folds):
    oof = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        a = np.linalg.solve(K[np.ix_(tr, tr)] + lam * np.eye(len(tr)),
                            y[tr] - y[tr].mean())
        oof[te] = K[np.ix_(te, tr)] @ a + y[tr].mean()
    return oof


def krr_loo(K, lam):
    """Exact LOO for centered KRR via the hat-matrix identity."""
    H = K @ np.linalg.inv(K + lam * np.eye(n))
    p = H @ (y - y.mean()) + y.mean()
    h = np.diag(H)
    return y - (y - p) / np.maximum(1 - h, 1e-9)


K = 0.25 * (tanimoto_K((reg_maccs > 0).astype(np.float64))
            + tanimoto_K((reg_counts > 0).astype(np.float64))
            + minmax_K(reg_counts.astype(np.float64)) + rbf_K(reg_desc))

ck10 = krr_oof(K, 0.06, folds10)
log(f"ckrr 10-fold: {r2(ck10):.4f}")
reps = [krr_oof(K, 0.06, kfold_indices(n, 10, 42 + 7700 * r))
        for r in range(4)]
for m in (2, 4):
    avg = np.mean(reps[:m], 0)
    log(f"ckrr {m}-split avg: {r2(avg):.4f}")
ck20 = krr_oof(K, 0.06, kfold_indices(n, 20, 42))
log(f"ckrr 20-fold: {r2(ck20):.4f}")
ckloo = krr_loo(K, 0.06)
log(f"ckrr LOO: {r2(ckloo):.4f}")

names = list(base_legs)
log(f"base stack in-sample: {stack_r2([base_legs[k] for k in names]):.4f}")
for label, ck in (("2-split ckrr", np.mean(reps[:2], 0)),
                  ("4-split ckrr", np.mean(reps, 0)),
                  ("20-fold ckrr", ck20), ("LOO ckrr", ckloo)):
    cols = [base_legs[k] if k != "ckrr" else ck for k in names]
    log(f"stack w/ {label}: {stack_r2(cols):.4f}")

# tree proxy at 20 folds + 2-split average
from sklearn.ensemble import HistGradientBoostingRegressor


def hgb_oof(folds):
    xt = _tree_features_global(data)
    oof = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        m = HistGradientBoostingRegressor(max_iter=300, learning_rate=0.05,
                                          random_state=0).fit(xt[tr], y[tr])
        oof[te] = m.predict(xt[te])
    return oof


h10 = hgb_oof(folds10)
h20 = hgb_oof(kfold_indices(n, 20, 42))
havg = np.mean([h10, hgb_oof(kfold_indices(n, 10, 42 + 7700))], 0)
log(f"hgb 10-fold {r2(h10):.4f} | 20-fold {r2(h20):.4f} | "
    f"2-split avg {r2(havg):.4f}")
log("DONE")
