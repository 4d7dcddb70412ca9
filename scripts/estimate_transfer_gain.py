"""CPU-side estimate of the cross-task transfer gain (run at SCHED_IDLE
priority beside a device job: chrt -i 0 python -u ...).

Phase 1 (this script):
  1. build + cache the leak-screened aux set's raw features
     (.bench_cache -> the device campaign reuses them, BBBP_TRANSFER_CACHE)
  2. sklearn HistGB aux classifier -> holdout AUC + P(BBB+) for the
     regression molecules (proxy for the framework's device forest engine)
  3. 10-fold CV on the honest features: HistGBR with vs without the
     transfer columns; Tanimoto-KRR lambda selection; transfer-only leg
  -> prints the expected per-leg deltas that decide the campaign config.

Uses sklearn ONLY as a cheap proxy for sizing; the committed pipeline runs
on the framework's own engines (train.transfer).
"""
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
    print(f"[est +{time.time()-T0:6.0f}s] {m}", flush=True)


from bbbp.train.transfer import (aux_classification_set,
                                 raw_transfer_features, _auc)

aux_smiles, aux_y, n_excl = aux_classification_set(verbose=True)
log(f"aux set ready ({n_excl} excluded)")
aux_desc, aux_maccs, aux_counts = raw_transfer_features(aux_smiles)
log(f"aux raw features cached: desc={aux_desc.shape}")

from bbbp.pipelines.preprocess import ProcessedData
from bbbp.train.regression import _tree_features_global
from bbbp.train.loop import kfold_indices

data = ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw0.pkl")
reg_desc, reg_maccs, reg_counts = raw_transfer_features(data.smiles)
log(f"regression raw features cached: desc={reg_desc.shape}")

# ---- sklearn proxy aux classifier -----------------------------------------
from sklearn.decomposition import PCA as SkPCA
from sklearn.ensemble import HistGradientBoostingClassifier, \
    HistGradientBoostingRegressor
from sklearn.preprocessing import StandardScaler as SkScaler

csc = SkScaler().fit(aux_counts)
pca = SkPCA(n_components=128, random_state=0).fit(csc.transform(aux_counts))
dsc = SkScaler().fit(aux_desc)


def assemble(desc, maccs, counts):
    return np.concatenate([dsc.transform(desc), maccs,
                           pca.transform(csc.transform(counts))],
                          axis=1).astype(np.float32)


aux_x = assemble(aux_desc, aux_maccs, aux_counts)
reg_x = assemble(reg_desc, reg_maccs, reg_counts)

rng = np.random.default_rng(7)
perm = rng.permutation(len(aux_y))
hold, tr = perm[:len(perm)//10], perm[len(perm)//10:]
clf = HistGradientBoostingClassifier(max_iter=400, random_state=0)
clf.fit(aux_x[tr], aux_y[tr])
auc = _auc(aux_y[hold], clf.predict_proba(aux_x[hold])[:, 1])
log(f"aux HistGB holdout AUC={auc:.4f}")
clf.fit(aux_x, aux_y)
t_gb = clf.predict_proba(reg_x)[:, 1].astype(np.float32)

# Tanimoto-kNN transfer proxy on MACCS bits
ab = (aux_maccs > 0).astype(np.float32)
rb = (reg_maccs > 0).astype(np.float32)
inter = rb @ ab.T
union = rb.sum(1, keepdims=True) + ab.sum(1)[None, :] - inter
sim = inter / np.maximum(union, 1e-9)
k = 25
idx = np.argpartition(-sim, k, axis=1)[:, :k]
w = np.take_along_axis(sim, idx, 1) ** 2
t_knn = (w * aux_y[idx]).sum(1) / np.maximum(w.sum(1), 1e-9)
T = np.stack([t_gb, t_knn], 1)
log(f"transfer columns ready; corr(gb,knn)={np.corrcoef(t_gb, t_knn)[0,1]:.3f}")

y = data.y
n = len(y)
folds = kfold_indices(n, 10, 42)
xt = _tree_features_global(data)
log(f"honest tree features {xt.shape}")


def cv_r2(x, model_fn):
    oof = np.zeros(n, np.float32)
    for i, te in enumerate(folds):
        tr_i = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        m = model_fn()
        m.fit(x[tr_i], y[tr_i])
        oof[te] = m.predict(x[te])
    ss = ((y - oof) ** 2).sum()
    return 1 - ss / ((y - y.mean()) ** 2).sum(), oof


r2_base, oof_base = cv_r2(xt, lambda: HistGradientBoostingRegressor(
    max_iter=400, random_state=0))
log(f"HistGBR base       R2={r2_base:.4f}")
r2_tr, oof_tr = cv_r2(np.concatenate([xt, T], 1),
                      lambda: HistGradientBoostingRegressor(
                          max_iter=400, random_state=0))
log(f"HistGBR +transfer  R2={r2_tr:.4f}  (delta {r2_tr-r2_base:+.4f})")

# transfer-only calibration leg
from sklearn.linear_model import LinearRegression as SkLin

r2_tonly, oof_tonly = cv_r2(T, SkLin)
log(f"transfer-only leg  R2={r2_tonly:.4f}")

# Tanimoto-KRR lambda selection on the regression bits
rbits = (reg_maccs > 0).astype(np.float32)
ri = rbits @ rbits.T
ru = rbits.sum(1, keepdims=True) + rbits.sum(1)[None, :] - ri
K = ri / np.maximum(ru, 1e-9)
for lam in (0.03, 0.1, 0.3, 1.0):
    oof = np.zeros(n, np.float32)
    for i, te in enumerate(folds):
        tr_i = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        Ktr = K[np.ix_(tr_i, tr_i)]
        mu = y[tr_i].mean()
        alpha = np.linalg.solve(Ktr + lam * np.eye(len(tr_i)), y[tr_i] - mu)
        oof[te] = K[np.ix_(te, tr_i)] @ alpha + mu
    r2 = 1 - ((y-oof)**2).sum() / ((y-y.mean())**2).sum()
    log(f"tanimoto-KRR lam={lam:<4} R2={r2:.4f}")

out = {"aux_auc": float(auc), "r2_histgbr_base": float(r2_base),
       "r2_histgbr_transfer": float(r2_tr),
       "r2_transfer_only": float(r2_tonly)}
np.save("/root/repo/.bench_cache/transfer_proxy_cols.npy", T)
with open("/root/repo/.bench_cache/transfer_estimate.json", "w") as f:
    json.dump(out, f, indent=1)
log(f"DONE {out}")
