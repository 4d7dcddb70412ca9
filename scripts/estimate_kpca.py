"""Estimate (CPU, SCHED_IDLE) three candidate legs against the committed
0.6780 honest OOF artifacts:
  A. kernel-PCA features appended to the tree matrix -> HistGB (does the
     chem kernel's power transfer into the boosted trees?)
  B. small MLP on kernel-PCA features as a NEW diversity leg in the stack
  C. minmax count-kernel at Morgan radius 3 vs the radius-2 one (0.610)
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
    print(f"[estp +{time.time()-T0:6.0f}s] {m}", flush=True)


from sklearn.ensemble import HistGradientBoostingRegressor
from sklearn.linear_model import LinearRegression
from sklearn.neural_network import MLPRegressor
from sklearn.preprocessing import StandardScaler

from bbbp.chem.featurize import fingerprints
from bbbp.pipelines.preprocess import ProcessedData
from bbbp.train.loop import kfold_indices
from bbbp.train.regression import _tree_features_global
from bbbp.train.transfer import raw_transfer_features

data = ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw0.pkl")
y = data.y.astype(np.float64)
n = len(y)
folds = kfold_indices(n, 10, 42)
desc, maccs, counts = raw_transfer_features(data.smiles)
xt = _tree_features_global(data)
d = pickle.load(open("results/reg_maccs_honest_r3/oof_predictions.pkl", "rb"))
legs = {k: np.asarray(v, np.float64) for k, v in d.items()
        if k not in ("y", "stacked")}


def r2(p, yy=y):
    return float(1 - ((yy - p) ** 2).sum() / ((yy - yy.mean()) ** 2).sum())


def tanimoto_K(b):
    b = b.astype(np.float64)
    i = b @ b.T
    u = b.sum(1)[:, None] + b.sum(1)[None] - i
    return i / np.maximum(u, 1e-9)


def minmax_K(c):
    c = c.astype(np.float64)
    tmax = int(c.max())
    mn = np.zeros((len(c), len(c)))
    for t in range(1, tmax + 1):
        b = (c >= t).astype(np.float64)
        mn += b @ b.T
    s = c.sum(1)
    mx = s[:, None] + s[None] - mn
    return mn / np.maximum(mx, 1e-9)


def rbf_K(x):
    xs = StandardScaler().fit_transform(x)
    sq = (xs ** 2).sum(1)
    d2 = sq[:, None] + sq[None] - 2 * xs @ xs.T
    gamma = 1.0 / (2 * np.median(d2[d2 > 0]))
    return np.exp(-gamma * np.maximum(d2, 0))


def krr_oof(K, lam):
    out = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(10) if j != i])
        a = np.linalg.solve(K[np.ix_(tr, tr)] + lam * np.eye(len(tr)), y[tr])
        out[te] = K[np.ix_(te, tr)] @ a
    return out


def stack(cols):
    X = np.stack(cols, 1)
    p = LinearRegression().fit(X, y).predict(X)
    out = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(10) if j != i])
        out[te] = LinearRegression().fit(X[tr], y[tr]).predict(X[te])
    return r2(p), r2(out)


log("building kernels (r2 counts + maccs + bits + desc)...")
K = (tanimoto_K(maccs > 0) + tanimoto_K(counts > 0) + minmax_K(counts)
     + rbf_K(desc)) / 4.0

# --- C: radius-3 count kernel ---------------------------------------------
c3 = fingerprints(data.smiles, kind="morgan_counts", radius=3,
                  workers=1).features.astype(np.float32)
K3 = minmax_K(c3)
for name, Kk in (("minmax_r2", minmax_K(counts)), ("minmax_r3", K3)):
    for lam in (0.03, 0.1):
        col = krr_oof(Kk, lam)
        log(f"KRR {name} lam={lam}: OOF R2={r2(col):.4f}")

# --- A/B: kernel PCA -------------------------------------------------------
w, V = np.linalg.eigh(K)
idx = np.argsort(w)[::-1][:128]
kpca = V[:, idx] * np.sqrt(np.maximum(w[idx], 0))
log(f"kpca features {kpca.shape}, top eig {w[idx][:3].round(2)}")

hgb = lambda: HistGradientBoostingRegressor(max_iter=300, learning_rate=0.05,
                                            random_state=0)


def oof_model(fn, X):
    out = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(10) if j != i])
        out[te] = fn().fit(X[tr], y[tr]).predict(X[te])
    return out


xt_k = np.concatenate([xt, kpca], 1)
col_a = oof_model(hgb, xt_k)
log(f"A: hgb(xt+kpca128) OOF R2={r2(col_a):.4f}  (xt-only baseline 0.6221)")


def mlp():
    return MLPRegressor(hidden_layer_sizes=(256, 64), alpha=1e-3,
                        learning_rate_init=3e-4, max_iter=600,
                        early_stopping=True, random_state=0)


col_b = oof_model(mlp, np.concatenate([kpca, StandardScaler().fit_transform(desc)], 1))
log(f"B: mlp(kpca+desc) OOF R2={r2(col_b):.4f}")

order = [k for k in ("nn", "smiles", "graph", "rf", "gbdt", "cat", "knn",
                     "ridge", "tknn", "tkrr", "ckrr", "transfer")]
base_in, base_cv = stack([legs[k] for k in order])
log(f"control stack: in={base_in:.4f} cv={base_cv:.4f}")
for name, col in (("hgb_kpca", col_a), ("mlp_kpca", col_b),
                  ("both", None)):
    cols = [legs[k] for k in order]
    if name == "both":
        cols += [col_a, col_b]
    else:
        cols += [col]
    s_in, s_cv = stack(cols)
    log(f"stack + {name}: in={s_in:.4f} cv={s_cv:.4f} "
        f"(d_in {s_in-base_in:+.4f} d_cv {s_cv-base_cv:+.4f})")
# also: replace gbdt with the kpca-enhanced one
cols = [legs[k] if k != "gbdt" else col_a for k in order]
s_in, s_cv = stack(cols)
log(f"stack gbdt->hgb_kpca: in={s_in:.4f} cv={s_cv:.4f}")
log("DONE")
