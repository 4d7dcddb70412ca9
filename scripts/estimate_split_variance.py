"""Estimate the fold-split-seed variance of the honest logBB stack (CPU).

The driver north star (R² ≈ 0.70, BASELINE.md) is a SINGLE-split number from
one reference artifact (stacked_predict_r2_07031_MSE_01567.png). Our honest
headline is likewise one split (seed 42). At N≈1,049 the stacked R² has real
split-seed variance; this harness measures it with a cheap proxy stack whose
legs rebuild per split seed (no cached-OOF reuse — cached OOF columns are
split-42-specific):

  ckrr  — combined chemistry-kernel ridge (kernels are split-independent,
          per-split work is only the fold solves; campaign leg ~0.64)
  hgb   — HistGB on [maccs, counts, desc] (sklearn proxy of the GBDT leg)
  tknn  — Tanimoto-kNN from the bit kernel
  ridge — ridge on standardized [maccs, counts, desc]

Proxy stack at seed 42 ties to the campaign base (full 12-leg stack is
~0.01-0.02 above the proxy); what transfers across seeds is the SPREAD.
Output: per-seed in-sample/crossfit stacked R², mean ± sd, min/max.
"""
import os
import sys
import time

sys.path.insert(0, "/root/repo")
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("BBBP_TRANSFER_CACHE", "/root/repo/.bench_cache")

import numpy as np

T0 = time.time()


def log(m):
    print(f"[estsv +{time.time()-T0:6.0f}s] {m}", flush=True)


from sklearn.ensemble import HistGradientBoostingRegressor
from sklearn.linear_model import LinearRegression, Ridge
from sklearn.preprocessing import StandardScaler

from bbbp.pipelines.preprocess import ProcessedData
from bbbp.train.loop import kfold_indices
from bbbp.train.transfer import raw_transfer_features

data = ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw0.pkl")
y = np.asarray(data.y, np.float64)
n = len(y)
reg_desc, reg_maccs, reg_counts = raw_transfer_features(data.smiles)
X_tree = np.concatenate([reg_maccs, reg_counts, reg_desc], 1).astype(np.float64)

# split-independent kernel blocks (IDF weighting as in the adopted ckrr_idf)
bits = (reg_counts > 0).astype(np.float64)
mkeys = (reg_maccs > 0).astype(np.float64)
idf_b = np.log(n / np.maximum(bits.sum(0), 1.0))
idf_k = np.log(n / np.maximum(mkeys.sum(0), 1.0))


def w_tanimoto(b, w):
    bw = b * w[None, :]
    i = bw @ b.T
    s = bw.sum(1)
    return i / np.maximum(s[:, None] + s[None] - i, 1e-9)


def w_minmax(c, w, tmax=8):
    mn = np.zeros((n, n))
    s = np.zeros(n)
    for t in range(1, tmax + 1):
        b = (c >= t).astype(np.float64)
        mn += (b * w[None, :]) @ b.T
        s += (b * w[None, :]).sum(1)
    return mn / np.maximum(s[:, None] + s[None] - mn, 1e-9)


K_maccs = w_tanimoto(mkeys, idf_k)
K_bits = w_tanimoto(bits, idf_b)
K_counts = w_minmax(reg_counts.astype(np.float64), idf_b)
K_plain_bits = w_tanimoto(bits, np.ones_like(idf_b))   # for tknn
log("kernels built")


def r2(p):
    return float(1 - ((y - p) ** 2).sum() / ((y - y.mean()) ** 2).sum())


def run_seed(seed):
    folds = kfold_indices(n, 10, seed)
    tr_of = [np.concatenate([folds[j] for j in range(10) if j != i])
             for i in range(10)]

    # --- ckrr (per-fold RBF desc block + combined kernel solve)
    ck = np.zeros(n)
    for i, te in enumerate(folds):
        tr = tr_of[i]
        sc = StandardScaler().fit(reg_desc[tr])
        xs = sc.transform(reg_desc)
        d2 = ((xs[:, None, :] - xs[None, tr, :]) ** 2).sum(-1)
        med = np.median(d2[tr][np.triu_indices(len(tr), 1)])
        Krb = np.exp(-d2 / max(med, 1e-9))
        Kf = 0.15 * K_maccs + 0.2 * K_bits + 0.45 * K_counts
        A = Kf[np.ix_(tr, tr)] + 0.2 * Krb[tr]
        B = Kf[np.ix_(te, tr)] + 0.2 * Krb[te]
        mean = y[tr].mean()
        alpha = np.linalg.solve(A + 0.06 * np.eye(len(tr)), y[tr] - mean)
        ck[te] = B @ alpha + mean

    # --- hgb proxy of the GBDT leg
    hg = np.zeros(n)
    for i, te in enumerate(folds):
        tr = tr_of[i]
        m = HistGradientBoostingRegressor(
            max_iter=200, learning_rate=0.06, max_leaf_nodes=31,
            l2_regularization=1.0, random_state=0)
        m.fit(X_tree[tr], y[tr])
        hg[te] = m.predict(X_tree[te])

    # --- Tanimoto-kNN (k=12, similarity-weighted)
    tk = np.zeros(n)
    for i, te in enumerate(folds):
        tr = tr_of[i]
        S = K_plain_bits[np.ix_(te, tr)]
        idx = np.argsort(-S, 1)[:, :12]
        w = np.take_along_axis(S, idx, 1)
        w = w / np.maximum(w.sum(1, keepdims=True), 1e-9)
        tk[te] = (w * y[tr][idx]).sum(1)

    # --- ridge
    rg = np.zeros(n)
    for i, te in enumerate(folds):
        tr = tr_of[i]
        sc = StandardScaler().fit(X_tree[tr])
        m = Ridge(alpha=10.0).fit(sc.transform(X_tree[tr]), y[tr])
        rg[te] = m.predict(sc.transform(X_tree[te]))

    cols = [ck, hg, tk, rg]
    X = np.stack(cols, 1)
    p_in = LinearRegression().fit(X, y).predict(X)
    p_cf = np.zeros(n)
    for i, te in enumerate(folds):
        tr = tr_of[i]
        p_cf[te] = LinearRegression().fit(X[tr], y[tr]).predict(X[te])
    return (r2(p_in), r2(p_cf),
            {"ckrr": r2(ck), "hgb": r2(hg), "tknn": r2(tk), "ridge": r2(rg)})


rows = []
for seed in range(42, 52):
    s_in, s_cf, legs = run_seed(seed)
    rows.append((seed, s_in, s_cf))
    log(f"seed {seed}: stack in={s_in:.4f} cf={s_cf:.4f} legs={ {k: round(v,3) for k,v in legs.items()} }")

arr_in = np.array([r[1] for r in rows])
arr_cf = np.array([r[2] for r in rows])
log(f"IN-SAMPLE: mean={arr_in.mean():.4f} sd={arr_in.std(ddof=1):.4f} "
    f"min={arr_in.min():.4f} max={arr_in.max():.4f}")
log(f"CROSSFIT : mean={arr_cf.mean():.4f} sd={arr_cf.std(ddof=1):.4f} "
    f"min={arr_cf.min():.4f} max={arr_cf.max():.4f}")
log("DONE")
