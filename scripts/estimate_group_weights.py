"""Estimate (CPU, nice-19) whether B3DB's label-quality ``group`` column
(A = multi-source consistent ... D = single-source/ranged, i.e. noisiest)
buys honest-protocol R² when used as TRAIN-side sample weights — a lever the
round-3 survey (results/ESTIMATES.md) never tested. The reference ignores
the column entirely (`B3DB/grouping/regression_grouping.py` only assigns it).

Three uses are measured, all leak-free (group labels are metadata fixed at
curation time, never functions of the test fold):
  1. weighted kernel-ridge leg: alpha = (K_tr + lam * diag(1/w_tr))^-1 y_tr
  2. weighted HistGB proxy leg (sklearn sample_weight)
  3. weighted linear meta over the committed OOF columns
Metric stays the campaign's UNWEIGHTED 10-fold OOF R² over all rows.
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
    print(f"[estg +{time.time()-T0:6.0f}s] {m}", flush=True)


from sklearn.ensemble import HistGradientBoostingRegressor
from sklearn.linear_model import LinearRegression
from sklearn.preprocessing import StandardScaler

from bbbp.data import load_b3db_regression
from bbbp.pipelines.preprocess import ProcessedData
from bbbp.train.loop import kfold_indices
from bbbp.train.regression import _tree_features_global
from bbbp.train.transfer import raw_transfer_features

data = ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw0.pkl")
y = np.asarray(data.y, np.float64)
n = len(y)
folds = kfold_indices(n, 10, 42)

reg = load_b3db_regression()
grp_by_no = dict(zip(reg.numbers.tolist(),
                     reg.frame["group"].astype(str).tolist()))
groups = np.array([grp_by_no.get(int(v), "B") for v in data.numbers])
log(f"N={n} groups: " + " ".join(f"{g}={int((groups==g).sum())}"
                                 for g in "ABCD"))

reg_desc, reg_maccs, reg_counts = raw_transfer_features(data.smiles)


def r2(p):
    return float(1 - ((y - p) ** 2).sum() / ((y - y.mean()) ** 2).sum())


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
base_w = {"maccs": 0.15, "bits": 0.2, "counts": 0.45, "desc": 0.2}
log("kernels done")


def krr_oof(gw, lam=0.06):
    """gw: dict group->weight (train-side); OOF over all rows unweighted."""
    w = np.array([gw.get(g, 1.0) for g in groups], np.float64)
    Kf = (base_w["maccs"] * K_maccs + base_w["bits"] * K_bits
          + base_w["counts"] * K_counts)
    oof = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        tr = tr[w[tr] > 0]
        sc = StandardScaler().fit(reg_desc[tr])
        xs = sc.transform(reg_desc)
        tr_d2 = ((xs[tr, None, :] - xs[None, tr, :]) ** 2).sum(-1)
        med = np.median(tr_d2[np.triu_indices(len(tr), 1)])
        gamma = 1.0 / max(med, 1e-9)
        all_d2 = ((xs[:, None, :] - xs[None, tr, :]) ** 2).sum(-1)
        Krb = np.exp(-gamma * all_d2)
        A = Kf[np.ix_(tr, tr)] + base_w["desc"] * Krb[tr]
        B = Kf[np.ix_(te, tr)] + base_w["desc"] * Krb[te]
        wt = w[tr]
        mean = float(np.average(y[tr], weights=wt))
        alpha = np.linalg.solve(A + lam * np.diag(1.0 / wt), y[tr] - mean)
        oof[te] = B @ alpha + mean
    return oof


oof_base = krr_oof({})
log(f"ckrr unweighted: R2={r2(oof_base):.4f} (campaign leg ~0.642)")
for name, gw in [
    ("D=0.7", {"D": 0.7}), ("D=0.5", {"D": 0.5}), ("D=0.3", {"D": 0.3}),
    ("drop-D", {"D": 0.0}),
    ("A=1.5", {"A": 1.5}), ("A=2,D=0.5", {"A": 2.0, "D": 0.5}),
]:
    log(f"ckrr {name}: R2={r2(krr_oof(gw)):.4f}")

# ---- HistGB proxy with sample weights --------------------------------------
xt = _tree_features_global(data)


def hgb_oof(gw):
    w = np.array([gw.get(g, 1.0) for g in groups], np.float64)
    oof = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        tr = tr[w[tr] > 0]
        m = HistGradientBoostingRegressor(max_iter=300, random_state=0)
        m.fit(xt[tr], y[tr], sample_weight=w[tr])
        oof[te] = m.predict(xt[te])
    return oof


hb = hgb_oof({})
log(f"hgb unweighted: R2={r2(hb):.4f}")
for name, gw in [("D=0.5", {"D": 0.5}), ("drop-D", {"D": 0.0}),
                 ("A=2,D=0.5", {"A": 2.0, "D": 0.5})]:
    log(f"hgb {name}: R2={r2(hgb_oof(gw)):.4f}")

# ---- weighted meta over committed OOF columns ------------------------------
d = pickle.load(open("results/reg_maccs_honest_r3/oof_predictions.pkl", "rb"))
cols = {k: np.asarray(v) for k, v in d.items() if k not in ("y", "stacked")}
X = np.stack(list(cols.values()), 1)


def stack_r2(weights=None):
    p_in = LinearRegression().fit(X, y, sample_weight=weights).predict(X)
    out = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        sw = None if weights is None else weights[tr]
        out[te] = LinearRegression().fit(X[tr], y[tr],
                                         sample_weight=sw).predict(X[te])
    return r2(p_in), r2(out)


log(f"meta unweighted: in/crossfit = {stack_r2()}")
for name, gw in [("D=0.5", {"D": 0.5}), ("A=2,D=0.5", {"A": 2.0, "D": 0.5})]:
    w = np.array([gw.get(g, 1.0) for g in groups])
    log(f"meta {name}: in/crossfit = {stack_r2(w)}")
log("DONE")
