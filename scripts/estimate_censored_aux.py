"""Estimate (CPU, SCHED_IDLE) whether censored-label semi-supervision lifts the
combined-kernel leg: every B3DB classification molecule is a censored logBB
observation (BBB+ <=> logBB >= -1, BBB- <=> logBB < -1, the TSV's threshold
column where present is always -1). Per fold: fit KRR on fold-train, predict
the aux set, clip the predictions to the censor-consistent side, refit a
sample-weighted KRR on train+aux, predict test. Leak-free: aux molecules are
disjoint from the regression set (train/transfer.py exclusion screen) and
their binary labels are independent public data.
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
    print(f"[estc +{time.time()-T0:6.0f}s] {m}", flush=True)


from bbbp.train.transfer import raw_transfer_features, aux_classification_set
from bbbp.pipelines.preprocess import ProcessedData
from bbbp.train.loop import kfold_indices
from sklearn.linear_model import LinearRegression
from sklearn.preprocessing import StandardScaler

THRESH = -1.0

data = ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw0.pkl")
y = np.asarray(data.y, np.float64)
n = len(y)
folds = kfold_indices(n, 10, 42)
reg_desc, reg_maccs, reg_counts = raw_transfer_features(data.smiles)

aux_smiles, aux_labels, _ = aux_classification_set(verbose=True)
aux_desc, aux_maccs, aux_counts = raw_transfer_features(aux_smiles)
aux_pos = np.asarray(aux_labels, np.float64) > 0.5
log(f"aux: {len(aux_smiles)} molecules, {int(aux_pos.sum())} BBB+")

all_desc = np.vstack([reg_desc, aux_desc])
all_maccs = np.vstack([reg_maccs, aux_maccs]).astype(np.float64)
all_counts = np.vstack([reg_counts, aux_counts]).astype(np.float64)
N = len(all_desc)
AUX = np.arange(n, N)


def tanimoto_K(b, cols):
    i = b @ b[cols].T
    u = b.sum(1)[:, None] + b[cols].sum(1)[None] - i
    return i / np.maximum(u, 1e-9)


def minmax_K(c, cols):
    tmax = min(int(c.max()), 16)
    mn = np.zeros((len(c), len(cols)))
    for t in range(1, tmax + 1):
        b = (c >= t).astype(np.float64)
        mn += b @ b[cols].T
    s = np.minimum(c, tmax).sum(1)
    mx = s[:, None] + s[cols][None] - mn
    return mn / np.maximum(mx, 1e-9)


log("building full grams (fingerprint terms)...")
cols = np.arange(N)
Kf = (0.15 * tanimoto_K((all_maccs > 0).astype(np.float64), cols)
      + 0.2 * tanimoto_K((all_counts > 0).astype(np.float64), cols)
      + 0.45 * minmax_K(all_counts, cols)).astype(np.float64)
log("fingerprint grams done")


def r2(p):
    return float(1 - ((y - p) ** 2).sum() / ((y - y.mean()) ** 2).sum())


def fold_K(tr):
    """Combined kernel incl. per-fold desc RBF (scaler/gamma on fold-train)."""
    sc = StandardScaler().fit(all_desc[tr])
    xs = sc.transform(all_desc)
    d2tr = ((xs[tr, None, :] - xs[None, tr, :]) ** 2).sum(-1)
    med = np.median(d2tr[np.triu_indices(len(tr), 1)])
    g = 1.0 / max(med, 1e-9)
    # full NxN rbf is 56M doubles = fine
    sq = (xs ** 2).sum(1)
    d2 = sq[:, None] + sq[None, :] - 2 * xs @ xs.T
    return Kf + 0.2 * np.exp(-g * np.maximum(d2, 0))


def krr_solve(K, rows, yv, lam, w=None):
    A = K[np.ix_(rows, rows)].copy()
    if w is None:
        A[np.diag_indices_from(A)] += lam
    else:
        A[np.diag_indices_from(A)] += lam / np.maximum(w, 1e-9)
    m = np.average(yv, weights=w)
    alpha = np.linalg.solve(A, yv - m)
    return alpha, m


LAM = 0.06
results = {}
for aux_w, em_iters, mode in [(0.0, 0, "base"),
                              (0.1, 1, "all"), (0.3, 1, "all"),
                              (0.3, 2, "all"), (1.0, 1, "all"),
                              (0.3, 1, "violators")]:
    oof = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        K = fold_K(tr)
        alpha, m = krr_solve(K, tr, y[tr], LAM)
        if aux_w == 0.0:
            oof[te] = K[np.ix_(te, tr)] @ alpha + m
            continue
        rows, yv = tr, y[tr]
        for _ in range(em_iters):
            pred_aux = K[np.ix_(AUX, rows)] @ alpha + m
            # censor-consistent imputation
            imp = np.where(aux_pos, np.maximum(pred_aux, THRESH),
                           np.minimum(pred_aux, THRESH))
            if mode == "violators":
                viol = np.where(aux_pos, pred_aux < THRESH, pred_aux > THRESH)
                keep = AUX[viol]
                impk = imp[viol]
            else:
                keep = AUX
                impk = imp
            rows = np.concatenate([tr, keep])
            yv = np.concatenate([y[tr], impk])
            w = np.concatenate([np.ones(len(tr)), np.full(len(keep), aux_w)])
            alpha, m = krr_solve(K, rows, yv, LAM, w)
        oof[te] = K[np.ix_(te, rows)] @ alpha + m
        log(f"  w={aux_w} mode={mode} iters={em_iters} fold {i+1}: "
            f"aux rows used {len(rows)-len(tr)}")
    key = f"w={aux_w} mode={mode} iters={em_iters}"
    results[key] = r2(oof)
    log(f"{key}: ckrr OOF R2={results[key]:.4f}")

# stack impact of best variant
d = pickle.load(open("results/reg_maccs_honest_r3/oof_predictions.pkl", "rb"))
base_cols = {k: np.asarray(v) for k, v in d.items() if k not in ("y", "stacked")}
log("summary: " + str({k: round(v, 4) for k, v in results.items()}))
log("DONE")
