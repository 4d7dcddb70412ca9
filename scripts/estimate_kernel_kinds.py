"""Estimate (CPU, SCHED_IDLE) whether adding rdkit-path-fp and/or avalon
Tanimoto terms to the combined chemistry kernel (ckrr leg) buys honest-protocol
R². Uses the latest honest OOF artifacts for the stack columns and refits only
the kernel leg per fold — leak-free (all kernel blocks are label-independent
and the ridge solve is per-fold train-only).
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
    print(f"[estk +{time.time()-T0:6.0f}s] {m}", flush=True)


from bbbp.train.transfer import raw_transfer_features
from bbbp.pipelines.preprocess import ProcessedData
from bbbp.train.loop import kfold_indices
from bbbp.chem.featurize import fingerprints
from sklearn.linear_model import LinearRegression
from sklearn.preprocessing import StandardScaler

data = ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw0.pkl")
y = np.asarray(data.y, np.float64)
n = len(y)
folds = kfold_indices(n, 10, 42)
reg_desc, reg_maccs, reg_counts = raw_transfer_features(data.smiles)

log(f"N={n}; featurizing rdkit + avalon fps natively")
fp_rdkit = fingerprints(data.smiles, kind="rdkit").features.astype(np.float64)
fp_avalon = fingerprints(data.smiles, kind="avalon").features.astype(np.float64)
log(f"rdkit {fp_rdkit.shape} avalon {fp_avalon.shape}")

d = pickle.load(open("results/reg_maccs_honest_r3/oof_predictions.pkl", "rb"))
base_cols = {k: np.asarray(v) for k, v in d.items() if k not in ("y", "stacked")}


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


def tanimoto_K(b):
    i = b @ b.T
    u = b.sum(1)[:, None] + b.sum(1)[None] - i
    return i / np.maximum(u, 1e-9)


def minmax_K(c):
    tmax = min(int(c.max()), 16)
    mn = np.zeros((len(c), len(c)))
    for t in range(1, tmax + 1):
        b = (c >= t).astype(np.float64)
        mn += b @ b.T
    s = np.minimum(c, tmax).sum(1)
    mx = s[:, None] + s[None] - mn
    return mn / np.maximum(mx, 1e-9)


K_maccs = tanimoto_K((reg_maccs > 0).astype(np.float64))
K_bits = tanimoto_K((reg_counts > 0).astype(np.float64))
K_counts = minmax_K(reg_counts.astype(np.float64))
K_rdkit = tanimoto_K(fp_rdkit)
K_avalon = tanimoto_K(fp_avalon)
log("fingerprint kernels done")


# simpler: exact ChemKernelRidge semantics -> reuse combined gram + per-fold solve
def krr_oof2(weights, lam=0.06):
    """weights: dict name->w over {maccs,bits,counts,desc,rdkit,avalon}."""
    Kf = np.zeros((n, n))
    for name, w in weights.items():
        if not w or name == "desc":
            continue
        Kf += w * {"maccs": K_maccs, "bits": K_bits, "counts": K_counts,
                   "rdkit": K_rdkit, "avalon": K_avalon}[name]
    oof = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        K = Kf
        if weights.get("desc"):
            sc = StandardScaler().fit(reg_desc[tr])
            xs = sc.transform(reg_desc)
            tr_d2 = ((xs[tr, None, :] - xs[None, tr, :]) ** 2).sum(-1)
            med = np.median(tr_d2[np.triu_indices(len(tr), 1)])
            gamma = 1.0 / max(med, 1e-9)
            all_d2 = ((xs[:, None, :] - xs[None, tr, :]) ** 2).sum(-1)
            Krb = np.exp(-gamma * all_d2)
            A = K[np.ix_(tr, tr)] + weights["desc"] * Krb[tr]
            B = K[np.ix_(te, tr)] + weights["desc"] * Krb[te]
        else:
            A = K[np.ix_(tr, tr)]
            B = K[np.ix_(te, tr)]
        mean = y[tr].mean()
        alpha = np.linalg.solve(A + lam * np.eye(len(tr)), y[tr] - mean)
        oof[te] = B @ alpha + mean
    return oof


base_w = {"maccs": 0.15, "bits": 0.2, "counts": 0.45, "desc": 0.2}
oof_base = krr_oof2(base_w)
log(f"ckrr reproduction: R2={r2(oof_base):.4f} (campaign leg 0.6415)")

singles = {
    "rdkit_alone": {"rdkit": 1.0},
    "avalon_alone": {"avalon": 1.0},
}
for name, w in singles.items():
    log(f"{name}: R2={r2(krr_oof2(w)):.4f}")

cands = {
    "+rdkit0.15": {**{k: v * 0.85 for k, v in base_w.items()}, "rdkit": 0.15},
    "+rdkit0.25": {**{k: v * 0.75 for k, v in base_w.items()}, "rdkit": 0.25},
    "+avalon0.15": {**{k: v * 0.85 for k, v in base_w.items()}, "avalon": 0.15},
    "+both0.125": {**{k: v * 0.75 for k, v in base_w.items()},
                   "rdkit": 0.125, "avalon": 0.125},
}
best_name, best_oof, best_r2 = "base", oof_base, r2(oof_base)
for name, w in cands.items():
    o = krr_oof2(w)
    rr = r2(o)
    log(f"ckrr{name}: R2={rr:.4f}")
    if rr > best_r2:
        best_name, best_oof, best_r2 = name, o, rr

# stack impact: replace ckrr column with the best variant
cols = [base_cols[k] for k in sorted(base_cols)]
ins, cf = stack_r2(cols)
log(f"stack with current legs (sanity): insample={ins:.4f} crossfit={cf:.4f}")
cols2 = [best_oof if k == "ckrr" else base_cols[k] for k in sorted(base_cols)]
ins2, cf2 = stack_r2(cols2)
log(f"stack with ckrr->{best_name}: insample={ins2:.4f} crossfit={cf2:.4f}")
# and as an EXTRA column
cols3 = cols + [best_oof]
ins3, cf3 = stack_r2(cols3)
log(f"stack with extra col {best_name}: insample={ins3:.4f} crossfit={cf3:.4f}")
log("DONE")
