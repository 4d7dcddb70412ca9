"""Estimate (CPU, SCHED_IDLE) Sort & Slice ECFP (arXiv:2403.17954) against
hash-folded Morgan counts: instead of folding substructure identifiers into
2048 buckets (collisions), take the top-K training-set identifiers as
dedicated count columns. Measured arms:
  - minmax count-kernel KRR on S&S counts vs folded counts (0.610 baseline)
  - combined chem kernel with the counts block swapped to S&S
  - HistGB on tree features with folded counts swapped for S&S counts
  - stack effect vs the committed 0.6780 honest OOF artifacts
"""
import os
import sys
import time

sys.path.insert(0, "/root/repo")
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("BBBP_TRANSFER_CACHE", "/root/repo/.bench_cache")

import pickle
from collections import Counter

import numpy as np

T0 = time.time()


def log(m):
    print(f"[estss +{time.time()-T0:6.0f}s] {m}", flush=True)


from sklearn.linear_model import LinearRegression
from sklearn.preprocessing import StandardScaler

from bbbp.chem.fingerprints import morgan_environments
from bbbp.chem.smiles import MolFromSmiles
from bbbp.pipelines.preprocess import ProcessedData
from bbbp.train.loop import kfold_indices
from bbbp.train.transfer import raw_transfer_features

data = ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw0.pkl")
y = data.y.astype(np.float64)
n = len(y)
folds = kfold_indices(n, 10, 42)
desc, maccs, counts = raw_transfer_features(data.smiles)

# ---- raw identifier multisets ---------------------------------------------
multisets = []
for smi in data.smiles:
    mol = MolFromSmiles(smi)
    cnt = Counter()
    if mol is not None:
        for h, _r, _bs in morgan_environments(mol, radius=2):
            cnt[h] += 1
    multisets.append(cnt)
log(f"identifier multisets done; unique ids="
    f"{len(set().union(*[set(c) for c in multisets]))}")

support = Counter()
for c in multisets:
    for h in c:
        support[h] += 1


def sort_slice(k):
    vocab = [h for h, _ in support.most_common(k)]
    col = {h: j for j, h in enumerate(vocab)}
    X = np.zeros((n, len(vocab)), np.float32)
    for i, c in enumerate(multisets):
        for h, v in c.items():
            j = col.get(h)
            if j is not None:
                X[i, j] = v
    return X


def r2(p):
    return float(1 - ((y - p) ** 2).sum() / ((y - y.mean()) ** 2).sum())


def minmax_K(c):
    c = np.asarray(c, np.float64)
    tmax = int(c.max())
    mn = np.zeros((len(c), len(c)))
    for t in range(1, tmax + 1):
        b = (c >= t).astype(np.float64)
        mn += b @ b.T
    s = c.sum(1)
    mx = s[:, None] + s[None] - mn
    return mn / np.maximum(mx, 1e-9)


def tanimoto_K(b):
    b = b.astype(np.float64)
    i = b @ b.T
    u = b.sum(1)[:, None] + b.sum(1)[None] - i
    return i / np.maximum(u, 1e-9)


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


K_fold = minmax_K(counts)
for lam in (0.03, 0.1):
    log(f"KRR minmax folded-2048 lam={lam}: R2={r2(krr_oof(K_fold, lam)):.4f}")

ss_mats = {k: sort_slice(k) for k in (1024, 2048, 4096)}
K_ss = {}
for k, X in ss_mats.items():
    K_ss[k] = minmax_K(X)
    for lam in (0.03, 0.1):
        log(f"KRR minmax S&S-{k} lam={lam}: R2={r2(krr_oof(K_ss[k], lam)):.4f}")

# combined chem kernel with the counts block swapped
K_base = (tanimoto_K(maccs > 0) + tanimoto_K(counts > 0) + K_fold
          + rbf_K(desc)) / 4.0
for lam in (0.06, 0.1):
    log(f"combined ckrr folded lam={lam}: R2={r2(krr_oof(K_base, lam)):.4f}")
best_k = 2048
K_comb_ss = (tanimoto_K(maccs > 0) + tanimoto_K(ss_mats[best_k] > 0)
             + K_ss[best_k] + rbf_K(desc)) / 4.0
for lam in (0.06, 0.1):
    log(f"combined ckrr S&S-{best_k} lam={lam}: "
        f"R2={r2(krr_oof(K_comb_ss, lam)):.4f}")

# HistGB arm: swap the folded-count block inside the tree features
from sklearn.ensemble import HistGradientBoostingRegressor

from bbbp.train.regression import _tree_features_global

xt = _tree_features_global(data)
hgb = lambda: HistGradientBoostingRegressor(max_iter=300, learning_rate=0.05,
                                            random_state=0)


def oof_model(X):
    out = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(10) if j != i])
        out[te] = hgb().fit(X[tr], y[tr]).predict(X[te])
    return out


log(f"hgb xt baseline: R2={r2(oof_model(xt)):.4f}")
xt_ss = np.concatenate([xt, ss_mats[2048]], 1)
log(f"hgb xt+S&S2048: R2={r2(oof_model(xt_ss)):.4f}")

# stack effect
d = pickle.load(open("results/reg_maccs_honest_r3/oof_predictions.pkl", "rb"))
legs = {k: np.asarray(v, np.float64) for k, v in d.items()
        if k not in ("y", "stacked")}
order = [k for k in ("nn", "smiles", "graph", "rf", "gbdt", "cat", "knn",
                     "ridge", "tknn", "tkrr", "ckrr", "transfer")]


def stack(cols):
    X = np.stack(cols, 1)
    p = LinearRegression().fit(X, y).predict(X)
    out = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(10) if j != i])
        out[te] = LinearRegression().fit(X[tr], y[tr]).predict(X[te])
    return r2(p), r2(out)


b_in, b_cv = stack([legs[k] for k in order])
log(f"control stack: in={b_in:.4f} cv={b_cv:.4f}")
ck_ss_col = krr_oof(K_comb_ss, 0.06)
cols = [legs[k] if k != "ckrr" else ck_ss_col for k in order]
s_in, s_cv = stack(cols)
log(f"stack ckrr->S&S-combined: in={s_in:.4f} cv={s_cv:.4f}")
cols = [legs[k] for k in order] + [ck_ss_col]
s_in, s_cv = stack(cols)
log(f"stack + S&S-combined as extra: in={s_in:.4f} cv={s_cv:.4f}")
log("DONE")
