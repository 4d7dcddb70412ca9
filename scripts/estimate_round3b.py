"""Estimate (CPU, SCHED_IDLE) four untried honest-stack levers against the
cached round-3 OOF matrix (results/reg_maccs_honest_r3/oof_predictions.pkl,
base 0.6780 in / 0.6677 crossfit):

  1. robust-loss tree legs: HistGB with absolute_error, and a quantile-trio
     (q25/q50/q75 averaged) — logBB tails may be dragging the L2 legs.
  2. IDF-weighted Tanimoto/minmax kernels: per-bit weights w_i =
     log(N/df_i) (label-free, so honest-protocol compliant computed on all
     rows) — rare substructures count more than common scaffolding bits.
  3. per-fold LOO-optimized kernel mixture: coordinate-descent the combined
     kernel's block weights + ridge lambda on train-fold closed-form LOO
     instead of the hand-set {maccs .15, bits .2, counts .45, desc .2}.
  4. nested residual stage-2: per crossfit fold, fit the linear meta on the
     other folds, fit a small HistGB on (features -> meta residual) on those
     same rows, apply both to the held-out fold. Fully nested, leak-free.
"""
import os
import pickle
import sys
import time

sys.path.insert(0, "/root/repo")
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("BBBP_TRANSFER_CACHE", "/root/repo/.bench_cache")

import numpy as np

T0 = time.time()


def log(m):
    print(f"[est3b +{time.time()-T0:6.0f}s] {m}", flush=True)


from sklearn.ensemble import HistGradientBoostingRegressor
from sklearn.linear_model import LinearRegression
from sklearn.preprocessing import StandardScaler

from bbbp.pipelines.preprocess import ProcessedData
from bbbp.train.loop import kfold_indices
from bbbp.train.transfer import raw_transfer_features

data = ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw0.pkl")
y = np.asarray(data.y, np.float64)
n = len(y)
folds = kfold_indices(n, 10, 42)
reg_desc, reg_maccs, reg_counts = raw_transfer_features(data.smiles)

d = pickle.load(open("results/reg_maccs_honest_r3/oof_predictions.pkl", "rb"))
base_legs = {k: np.asarray(v, np.float64) for k, v in d.items()
             if k not in ("y", "stacked")}
base_cols = list(base_legs.values())


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


b_in, b_cf = stack_r2(base_cols)
log(f"base stack: in={b_in:.4f} crossfit={b_cf:.4f} ({len(base_cols)} legs)")

# the tree-leg feature matrix the committed legs ride
X_tree = np.concatenate([reg_maccs, reg_counts, reg_desc], 1).astype(np.float64)


def oof_fit(fit_predict):
    oof = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        oof[te] = fit_predict(tr, te)
    return oof


# ---------------------------------------------------------------- lever 1
def hgb(loss, quantile=None, seed=0):
    def fp(tr, te):
        m = HistGradientBoostingRegressor(
            loss=loss, quantile=quantile, max_iter=300, learning_rate=0.06,
            max_leaf_nodes=31, l2_regularization=1.0, random_state=seed)
        m.fit(X_tree[tr], y[tr])
        return m.predict(X_tree[te])
    return oof_fit(fp)


lad = hgb("absolute_error")
log(f"lever1 LAD hgb leg R2={r2(lad):.4f}")
s_in, s_cf = stack_r2(base_cols + [lad])
log(f"  +LAD: in={s_in:.4f} ({s_in-b_in:+.4f}) cf={s_cf:.4f} ({s_cf-b_cf:+.4f})")
qtrio = (hgb("quantile", 0.25) + hgb("quantile", 0.5) + hgb("quantile", 0.75)) / 3.0
log(f"lever1 q-trio leg R2={r2(qtrio):.4f}")
s_in, s_cf = stack_r2(base_cols + [qtrio])
log(f"  +qtrio: in={s_in:.4f} ({s_in-b_in:+.4f}) cf={s_cf:.4f} ({s_cf-b_cf:+.4f})")

# ---------------------------------------------------------------- lever 2
def w_tanimoto(b, w):
    """weighted Tanimoto on binary b with per-bit weights w."""
    bw = b * w[None, :]
    i = bw @ b.T
    s = bw.sum(1)
    u = s[:, None] + s[None] - i
    return i / np.maximum(u, 1e-9)


def w_minmax(c, w, tmax=8):
    mn = np.zeros((len(c), len(c)))
    s = np.zeros(len(c))
    for t in range(1, tmax + 1):
        b = (c >= t).astype(np.float64)
        mn += (b * w[None, :]) @ b.T
        s += (b * w[None, :]).sum(1)
    mx = s[:, None] + s[None] - mn
    return mn / np.maximum(mx, 1e-9)


bits = (reg_counts > 0).astype(np.float64)
mkeys = (reg_maccs > 0).astype(np.float64)
df_bits = np.maximum(bits.sum(0), 1.0)
df_keys = np.maximum(mkeys.sum(0), 1.0)
idf_bits = np.log(n / df_bits)
idf_keys = np.log(n / df_keys)
ones_b = np.ones_like(idf_bits)
ones_k = np.ones_like(idf_keys)

K_maccs = w_tanimoto(mkeys, ones_k)
K_bits = w_tanimoto(bits, ones_b)
K_counts = w_minmax(reg_counts.astype(np.float64), ones_b)
K_maccs_idf = w_tanimoto(mkeys, idf_keys)
K_bits_idf = w_tanimoto(bits, idf_bits)
K_counts_idf = w_minmax(reg_counts.astype(np.float64), idf_bits)
log("kernels built")

# precompute the per-fold descriptor RBF blocks once (shared by all variants)
RBF = {}
for i, te in enumerate(folds):
    tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
    sc = StandardScaler().fit(reg_desc[tr])
    xs = sc.transform(reg_desc)
    tr_d2 = ((xs[tr, None, :] - xs[None, tr, :]) ** 2).sum(-1)
    med = np.median(tr_d2[np.triu_indices(len(tr), 1)])
    all_d2 = ((xs[:, None, :] - xs[None, tr, :]) ** 2).sum(-1)
    RBF[i] = np.exp(-all_d2 / max(med, 1e-9))
log("per-fold RBF blocks built")


def krr_oof(Kblocks, w, lam=0.06, w_desc=0.2):
    Kf = sum(wi * K for wi, K in zip(w, Kblocks))
    oof = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        Krb = RBF[i]
        A = Kf[np.ix_(tr, tr)] + w_desc * Krb[tr]
        B = Kf[np.ix_(te, tr)] + w_desc * Krb[te]
        mean = y[tr].mean()
        alpha = np.linalg.solve(A + lam * np.eye(len(tr)), y[tr] - mean)
        oof[te] = B @ alpha + mean
    return oof


base_w = (0.15, 0.2, 0.45)
ck_plain = krr_oof((K_maccs, K_bits, K_counts), base_w)
log(f"lever2 ckrr reproduction R2={r2(ck_plain):.4f} (campaign ~0.642)")
ck_idf = krr_oof((K_maccs_idf, K_bits_idf, K_counts_idf), base_w)
log(f"lever2 ckrr-IDF R2={r2(ck_idf):.4f}")
cols_no_ck = [v for k, v in base_legs.items() if k != "ckrr"]
for name, col in (("idf-as-extra", None), ("idf-replaces-ckrr", None)):
    pass
s_in, s_cf = stack_r2(base_cols + [ck_idf])
log(f"  +ckrr_idf extra: in={s_in:.4f} ({s_in-b_in:+.4f}) cf={s_cf:.4f} ({s_cf-b_cf:+.4f})")
s_in, s_cf = stack_r2(cols_no_ck + [ck_idf])
log(f"  idf replaces ckrr: in={s_in:.4f} ({s_in-b_in:+.4f}) cf={s_cf:.4f} ({s_cf-b_cf:+.4f})")

# ---------------------------------------------------------------- lever 3
def loo_press(Ktr, ytr, lam):
    """closed-form LOO mse for KRR (centered y)."""
    m = ytr.mean()
    yc = ytr - m
    A = Ktr + lam * np.eye(len(ytr))
    Ainv = np.linalg.inv(A)
    alpha = Ainv @ yc
    h = np.diag(Ainv)
    e = alpha / np.maximum(h, 1e-12)
    return float((e ** 2).mean())


def krr_oof_opt(Kblocks, lam_grid=(0.02, 0.04, 0.06, 0.1, 0.2),
                w_desc_grid=(0.0, 0.1, 0.2, 0.4)):
    """per fold: coordinate-descent block weights + lam on train LOO."""
    oof = np.zeros(n)
    chosen = []
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        Krb = RBF[i]
        blocks_tr = [K[np.ix_(tr, tr)] for K in Kblocks] + [Krb[tr]]
        blocks_te = [K[np.ix_(te, tr)] for K in Kblocks] + [Krb[te]]
        w = np.array([0.15, 0.2, 0.45, 0.2])
        lam = 0.06
        best = loo_press(sum(wi * B for wi, B in zip(w, blocks_tr)), y[tr], lam)
        for _sweep in range(2):
            for bi in range(len(w)):
                for cand in (0.0, 0.05, 0.1, 0.15, 0.2, 0.3, 0.45, 0.6, 0.8):
                    w2 = w.copy(); w2[bi] = cand
                    if w2.sum() < 1e-6:
                        continue
                    p = loo_press(sum(wi * B for wi, B in zip(w2, blocks_tr)),
                                  y[tr], lam)
                    if p < best:
                        best, w = p, w2
            for lcand in lam_grid:
                p = loo_press(sum(wi * B for wi, B in zip(w, blocks_tr)),
                              y[tr], lcand)
                if p < best:
                    best, lam = p, lcand
        chosen.append((list(np.round(w, 2)), lam))
        Ktr = sum(wi * B for wi, B in zip(w, blocks_tr))
        Kte = sum(wi * B for wi, B in zip(w, blocks_te))
        mean = y[tr].mean()
        alpha = np.linalg.solve(Ktr + lam * np.eye(len(tr)), y[tr] - mean)
        oof[te] = Kte @ alpha + mean
    log(f"  per-fold chosen (w_maccs,w_bits,w_counts,w_desc),lam: {chosen[:3]}...")
    return oof


ck_opt = krr_oof_opt((K_maccs, K_bits, K_counts))
log(f"lever3 LOO-opt ckrr R2={r2(ck_opt):.4f}")
s_in, s_cf = stack_r2(cols_no_ck + [ck_opt])
log(f"  opt replaces ckrr: in={s_in:.4f} ({s_in-b_in:+.4f}) cf={s_cf:.4f} ({s_cf-b_cf:+.4f})")
ck_opt_idf = krr_oof_opt((K_maccs_idf, K_bits_idf, K_counts_idf))
log(f"lever3 LOO-opt ckrr-IDF R2={r2(ck_opt_idf):.4f}")
s_in, s_cf = stack_r2(cols_no_ck + [ck_opt_idf])
log(f"  opt-idf replaces ckrr: in={s_in:.4f} ({s_in-b_in:+.4f}) cf={s_cf:.4f} ({s_cf-b_cf:+.4f})")

# ---------------------------------------------------------------- lever 4
def residual_stage2(cols, max_iter=150, lr=0.05, leaves=15):
    """crossfit with a nested residual HistGB on the tree feature matrix."""
    X = np.stack(cols, 1)
    out = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        meta = LinearRegression().fit(X[tr], y[tr])
        res_tr = y[tr] - meta.predict(X[tr])
        g = HistGradientBoostingRegressor(
            max_iter=max_iter, learning_rate=lr, max_leaf_nodes=leaves,
            l2_regularization=2.0, random_state=0).fit(X_tree[tr], res_tr)
        out[te] = meta.predict(X[te]) + g.predict(X_tree[te])
    return r2(out)


for mi, lr_, lv in ((100, 0.03, 7), (150, 0.05, 15), (300, 0.05, 31)):
    rr = residual_stage2(base_cols, mi, lr_, lv)
    log(f"lever4 residual-hgb(iter={mi},lr={lr_},leaves={lv}): "
        f"cf={rr:.4f} ({rr-b_cf:+.4f})")

log("DONE")
