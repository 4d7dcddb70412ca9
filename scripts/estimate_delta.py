"""Estimate (CPU, SCHED_IDLE) a pairwise delta-learning leg: train a GBDT on
molecule PAIRS to predict logBB differences, then predict each held-out
molecule as the anchor-averaged (y_anchor + predicted delta). Pair training
data scales quadratically with fold-train size (~440k pairs from 944 rows), a
different inductive bias from every current leg. Honest per-fold protocol:
pairs are train x train only, anchors are train rows only.

Features per pair: [d_i - d_j, d_i + d_j] over a compact per-fold basis
(physchem descriptors + Morgan-count PCA), mirroring delta-learning practice.
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
    print(f"[estd2 +{time.time()-T0:6.0f}s] {m}", flush=True)


from bbbp.train.transfer import raw_transfer_features
from bbbp.pipelines.preprocess import ProcessedData
from bbbp.train.loop import kfold_indices
from sklearn.preprocessing import StandardScaler
from sklearn.decomposition import PCA
from sklearn.linear_model import LinearRegression
from sklearn.ensemble import HistGradientBoostingRegressor

data = ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw0.pkl")
y = np.asarray(data.y, np.float64)
n = len(y)
folds = kfold_indices(n, 10, 42)
reg_desc, reg_maccs, reg_counts = raw_transfer_features(data.smiles)


def r2(p):
    return float(1 - ((y - p) ** 2).sum() / ((y - y.mean()) ** 2).sum())


rng = np.random.default_rng(0)
MAX_PAIRS = 400_000
N_ANCHORS = 256          # per test molecule at prediction time

oof = np.zeros(n)
for i, te in enumerate(folds):
    tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
    sc = StandardScaler().fit(reg_desc[tr])
    dz = sc.transform(reg_desc)
    pca = PCA(n_components=64, random_state=0).fit(reg_counts[tr])
    cz = pca.transform(reg_counts)
    basis = np.hstack([dz, cz]).astype(np.float32)

    m = len(tr)
    ii, jj = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    mask = ii != jj
    ii, jj = ii[mask], jj[mask]
    if len(ii) > MAX_PAIRS:
        sel = rng.choice(len(ii), MAX_PAIRS, replace=False)
        ii, jj = ii[sel], jj[sel]
    a, b = tr[ii], tr[jj]
    Xp = np.hstack([basis[a] - basis[b], basis[a] + basis[b]])
    yp = (y[a] - y[b]).astype(np.float32)
    gb = HistGradientBoostingRegressor(learning_rate=0.1, max_iter=300,
                                       max_depth=None, max_leaf_nodes=31,
                                       l2_regularization=1.0, random_state=0)
    gb.fit(Xp, yp)

    # predict: for each test row, average y_anchor + delta(test, anchor)
    anchors = tr if len(tr) <= N_ANCHORS else rng.choice(tr, N_ANCHORS,
                                                         replace=False)
    preds = np.zeros(len(te))
    for k, t in enumerate(te):
        Xq = np.hstack([basis[t][None] - basis[anchors],
                        basis[t][None] + basis[anchors]])
        preds[k] = float(np.mean(y[anchors] + gb.predict(Xq)))
    oof[te] = preds
    log(f"fold {i+1}/10: {len(ii)} pairs, fold r2 so far n/a")

log(f"delta leg OOF R2={r2(oof):.4f}")

d = pickle.load(open("results/reg_maccs_honest_r3/oof_predictions.pkl", "rb"))
base_cols = {k: np.asarray(v) for k, v in d.items() if k not in ("y", "stacked")}


def stack_r2(cols):
    X = np.stack(cols, 1)
    p = LinearRegression().fit(X, y).predict(X)
    out = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        out[te] = LinearRegression().fit(X[tr], y[tr]).predict(X[te])
    return r2(p), r2(out)


cols = [base_cols[k] for k in sorted(base_cols)]
ins, cf = stack_r2(cols)
log(f"stack without delta: insample={ins:.4f} crossfit={cf:.4f}")
ins2, cf2 = stack_r2(cols + [oof])
log(f"stack WITH delta   : insample={ins2:.4f} crossfit={cf2:.4f}")
log("DONE")
