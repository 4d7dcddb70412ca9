"""Estimate round 2 (CPU, SCHED_IDLE): which *form* of the new legs pays?

  A. transfer on the LOGIT scale (decision margin keeps the magnitude that
     P(BBB+) saturates away) — as tree feature and as calibration leg
  B. kernel-ridge leg variants: Tanimoto on MACCS/Morgan bits, min-max
     kernel on Morgan counts, RBF on descriptors, combined kernels
  C. stack simulation: HistGBR proxies for the tree legs + each candidate
     leg -> OOF-stacked R2 with the in-sample linear meta (the pipeline's
     headline), with vs without the candidates.
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
    print(f"[est2 +{time.time()-T0:6.0f}s] {m}", flush=True)


from bbbp.train.transfer import aux_classification_set, \
    raw_transfer_features, _auc
from bbbp.pipelines.preprocess import ProcessedData
from bbbp.train.regression import _tree_features_global
from bbbp.train.loop import kfold_indices

aux_smiles, aux_y, _ = aux_classification_set()
aux_desc, aux_maccs, aux_counts = raw_transfer_features(aux_smiles)
data = ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw0.pkl")
reg_desc, reg_maccs, reg_counts = raw_transfer_features(data.smiles)
y = data.y
n = len(y)
folds = kfold_indices(n, 10, 42)
xt = _tree_features_global(data)

from sklearn.decomposition import PCA as SkPCA
from sklearn.ensemble import (HistGradientBoostingClassifier,
                              HistGradientBoostingRegressor)
from sklearn.preprocessing import StandardScaler as SkScaler
from sklearn.linear_model import LinearRegression as SkLin

csc = SkScaler().fit(aux_counts)
pca = SkPCA(n_components=128, random_state=0).fit(csc.transform(aux_counts))
dsc = SkScaler().fit(aux_desc)


def assemble(desc, maccs, counts):
    return np.concatenate([dsc.transform(desc), maccs,
                           pca.transform(csc.transform(counts))],
                          axis=1).astype(np.float32)


aux_x = assemble(aux_desc, aux_maccs, aux_counts)
reg_x = assemble(reg_desc, reg_maccs, reg_counts)

clf = HistGradientBoostingClassifier(max_iter=400, random_state=0)
clf.fit(aux_x, aux_y)
t_logit = clf.decision_function(reg_x).astype(np.float32)
log(f"logit transfer: corr(logit, y)={np.corrcoef(t_logit, y)[0,1]:.4f} "
    f"(proba corr was ~sqrt(0.27))")

# second aux model on a different view for decorrelation: descriptors-only
clf_d = HistGradientBoostingClassifier(max_iter=300, random_state=1)
clf_d.fit(aux_x[:, :31], aux_y)
t_logit_d = clf_d.decision_function(reg_x[:, :31]).astype(np.float32)
T = np.stack([t_logit, t_logit_d], 1)


def cv_oof(x, model_fn):
    oof = np.zeros(n, np.float32)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        m = model_fn()
        m.fit(x[tr], y[tr])
        oof[te] = m.predict(x[te])
    return oof


def r2(oof):
    return 1 - ((y - oof) ** 2).sum() / ((y - y.mean()) ** 2).sum()


# A. logit transfer value
oof_tonly = cv_oof(T, SkLin)
log(f"transfer-logit-only leg R2={r2(oof_tonly):.4f}")
oof_base = cv_oof(xt, lambda: HistGradientBoostingRegressor(
    max_iter=400, random_state=0))
log(f"HistGBR base  R2={r2(oof_base):.4f}")
oof_tr = cv_oof(np.concatenate([xt, T], 1),
                lambda: HistGradientBoostingRegressor(
                    max_iter=400, random_state=0))
log(f"HistGBR +logitT R2={r2(oof_tr):.4f} (delta {r2(oof_tr)-r2(oof_base):+.4f})")


# B. kernel legs
def krr_oof(K, lam):
    oof = np.zeros(n, np.float32)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        mu = y[tr].mean()
        a = np.linalg.solve(K[np.ix_(tr, tr)] + lam * np.eye(len(tr)),
                            y[tr] - mu)
        oof[te] = K[np.ix_(te, tr)] @ a + mu
    return oof


def tanimoto_K(b):
    i = b @ b.T
    u = b.sum(1)[:, None] + b.sum(1)[None] - i
    return i / np.maximum(u, 1e-9)


def minmax_K(c):
    # sum min / sum max for count vectors, via sorting-free pairwise loop in
    # blocks (1049x1049x2048 too big at once)
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
kernels = {
    "tan_maccs": tanimoto_K(mb),
    "tan_morgan": tanimoto_K(morb),
    "minmax_counts": minmax_K(reg_counts),
    "rbf_desc": np.exp(-d2 / (2 * np.median(d2))),
}
kernels["combo_tm_rbf"] = 0.5 * kernels["tan_maccs"] + 0.5 * kernels["rbf_desc"]
kernels["combo_mm_rbf"] = 0.5 * kernels["minmax_counts"] + 0.5 * kernels["rbf_desc"]
kernels["combo_all"] = (kernels["tan_maccs"] + kernels["minmax_counts"]
                        + kernels["rbf_desc"]) / 3
best_k = {}
for name, K in kernels.items():
    rs = {}
    for lam in (0.03, 0.1, 0.3):
        o = krr_oof(K, lam)
        rs[lam] = (r2(o), o)
    lam = max(rs, key=lambda v: rs[v][0])
    best_k[name] = rs[lam]
    log(f"KRR {name:14s} lam={lam:<4} R2={rs[lam][0]:.4f}")

# C. stack simulation: proxies for current legs + candidates
oof_rf = cv_oof(xt, lambda: __import__("sklearn.ensemble", fromlist=["x"]
                                       ).RandomForestRegressor(
    n_estimators=200, max_depth=12, n_jobs=1, random_state=0))
log(f"RF proxy R2={r2(oof_rf):.4f}")
base_cols = {"gbdt": oof_base, "rf": oof_rf}
cand_cols = {"tkrr_combo": best_k["combo_all"][1],
             "tkrr_maccs": best_k["tan_maccs"][1],
             "transfer_logit": oof_tonly,
             "gbdt_T": oof_tr}


def stack_r2(cols):
    X = np.stack(list(cols), 1)
    m = SkLin().fit(X, y)
    return r2(m.predict(X).astype(np.float32))


log(f"stack base (gbdt+rf) R2={stack_r2(base_cols.values()):.4f}")
for nm, c in cand_cols.items():
    log(f"stack base+{nm:15s} R2={stack_r2(list(base_cols.values())+[c]):.4f}")
log(f"stack base+all cands R2="
    f"{stack_r2(list(base_cols.values())+list(cand_cols.values())):.4f}")
np.savez("/root/repo/.bench_cache/est2_cols.npz",
         logitT=T, **{k: v[1] for k, v in best_k.items()})
log("DONE")
