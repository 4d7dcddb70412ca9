"""Estimate round 3 (CPU, SCHED_IDLE): tune the combined chemistry kernel
(weights over tan_maccs / tan_morgan / minmax_counts / rbf_desc, ridge lam)
for the ckrr regression leg."""
import itertools
import json
import os
import sys
import time

sys.path.insert(0, "/root/repo")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("BBBP_TRANSFER_CACHE", "/root/repo/.bench_cache")

import numpy as np

T0 = time.time()


def log(m):
    print(f"[est3 +{time.time()-T0:6.0f}s] {m}", flush=True)


from bbbp.train.transfer import raw_transfer_features
from bbbp.pipelines.preprocess import ProcessedData
from bbbp.train.loop import kfold_indices

data = ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw0.pkl")
reg_desc, reg_maccs, reg_counts = raw_transfer_features(data.smiles)
y = data.y
n = len(y)
folds = kfold_indices(n, 10, 42)

from sklearn.preprocessing import StandardScaler as SkScaler


def tanimoto_K(b):
    i = b @ b.T
    u = b.sum(1)[:, None] + b.sum(1)[None] - i
    return i / np.maximum(u, 1e-9)


def minmax_K(c):
    N = len(c)
    K = np.zeros((N, N), np.float32)
    step = 128
    for a0 in range(0, N, step):
        ca = c[a0:a0+step, None, :]
        for b0 in range(0, N, step):
            cb = c[None, b0:b0+step, :]
            K[a0:a0+step, b0:b0+step] = (
                np.minimum(ca, cb).sum(-1) / np.maximum(
                    np.maximum(ca, cb).sum(-1), 1e-9))
    return K


mb = (reg_maccs > 0).astype(np.float32)
morb = (reg_counts > 0).astype(np.float32)
desc_s = SkScaler().fit_transform(reg_desc).astype(np.float32)
d2 = ((desc_s[:, None, :] - desc_s[None, :, :]) ** 2).sum(-1)
Ks = [tanimoto_K(mb), tanimoto_K(morb), minmax_K(reg_counts),
      np.exp(-d2 / (2 * np.median(d2)))]
names = ["tan_maccs", "tan_morgan", "minmax", "rbf_desc"]
log("kernels ready")


def krr_r2(K, lam):
    oof = np.zeros(n, np.float32)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        mu = y[tr].mean()
        a = np.linalg.solve(K[np.ix_(tr, tr)] + lam * np.eye(len(tr)),
                            y[tr] - mu)
        oof[te] = K[np.ix_(te, tr)] @ a + mu
    return 1 - ((y-oof)**2).sum() / ((y-y.mean())**2).sum(), oof


results = []
grids = [
    (0.25, 0.25, 0.25, 0.25), (0.2, 0.2, 0.4, 0.2), (0.1, 0.2, 0.5, 0.2),
    (0.0, 0.25, 0.5, 0.25), (0.15, 0.15, 0.55, 0.15), (0.0, 0.3, 0.5, 0.2),
    (0.2, 0.3, 0.5, 0.0), (0.0, 0.0, 0.7, 0.3), (0.1, 0.3, 0.4, 0.2),
    (0.0, 0.2, 0.6, 0.2),
]
for w in grids:
    K = sum(wi * Ki for wi, Ki in zip(w, Ks))
    for lam in (0.03, 0.06, 0.1, 0.2):
        r2, _ = krr_r2(K, lam)
        results.append((r2, w, lam))
        log(f"w={w} lam={lam:<4} R2={r2:.4f}")
results.sort(reverse=True)
best = results[0]
log(f"BEST: R2={best[0]:.4f} w={best[1]} lam={best[2]}")
with open("/root/repo/.bench_cache/ckrr_tuning.json", "w") as f:
    json.dump({"r2": float(best[0]), "weights": [float(v) for v in best[1]],
               "lam": float(best[2]), "names": names}, f, indent=1)
