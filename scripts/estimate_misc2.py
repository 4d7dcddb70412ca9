"""Estimate (CPU, SCHED_IDLE) four cheap stack-level levers against the
latest honest OOF artifacts:
  a. enriched-NN leg proxy: sklearn MLP on [desc_z, counts-PCA] (the kernel
     evidence says counts+desc carry the most signal; the flagship NN eats
     MACCS+image for reference parity)
  b. cross-fitted monotone/quadratic recalibration of the stacked prediction
     (does systematic extreme-shrinkage leave recoverable curvature?)
  c. residuals by B3DB label-quality group (where does the error live?)
  d. greedy leg-subset selection scored by crossfit stack R2
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
    print(f"[estm +{time.time()-T0:6.0f}s] {m}", flush=True)


from bbbp.train.transfer import raw_transfer_features
from bbbp.pipelines.preprocess import ProcessedData
from bbbp.train.loop import kfold_indices
from sklearn.preprocessing import StandardScaler
from sklearn.decomposition import PCA
from sklearn.linear_model import LinearRegression
from sklearn.neural_network import MLPRegressor
from sklearn.isotonic import IsotonicRegression

data = ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw0.pkl")
y = np.asarray(data.y, np.float64)
n = len(y)
folds = kfold_indices(n, 10, 42)
reg_desc, reg_maccs, reg_counts = raw_transfer_features(data.smiles)

d = pickle.load(open("results/reg_maccs_honest_r3/oof_predictions.pkl", "rb"))
legs = {k: np.asarray(v) for k, v in d.items() if k not in ("y", "stacked")}
stacked = np.asarray(d["stacked"])


def r2(p, m=None):
    m = np.ones(n, bool) if m is None else m
    return float(1 - ((y[m] - p[m]) ** 2).sum()
                 / ((y[m] - y[m].mean()) ** 2).sum())


def stack_r2(cols):
    X = np.stack(cols, 1)
    p = LinearRegression().fit(X, y).predict(X)
    out = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        out[te] = LinearRegression().fit(X[tr], y[tr]).predict(X[te])
    return r2(p), r2(out)


# --- a. enriched-NN proxy -------------------------------------------------
oof_mlp = np.zeros(n)
for i, te in enumerate(folds):
    tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
    sc = StandardScaler().fit(reg_desc[tr])
    pca = PCA(n_components=128, random_state=0).fit(reg_counts[tr])
    X = np.hstack([sc.transform(reg_desc), pca.transform(reg_counts)])
    Xs = StandardScaler().fit(X[tr]).transform(X)
    ms = [MLPRegressor(hidden_layer_sizes=(256, 128), alpha=1e-3,
                       learning_rate_init=1e-3, max_iter=400,
                       early_stopping=True, random_state=s).fit(Xs[tr], y[tr])
          for s in range(3)]
    oof_mlp[te] = np.mean([m.predict(Xs[te]) for m in ms], 0)
log(f"a. enriched-MLP leg OOF R2={r2(oof_mlp):.4f}")
cols = [legs[k] for k in sorted(legs)]
log(f"   stack base          : {stack_r2(cols)}")
log(f"   stack + enriched-MLP: {stack_r2(cols + [oof_mlp])}")

# --- b. recalibration -----------------------------------------------------
rec_iso, rec_quad = np.zeros(n), np.zeros(n)
for i, te in enumerate(folds):
    tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
    iso = IsotonicRegression(out_of_bounds="clip").fit(stacked[tr], y[tr])
    rec_iso[te] = iso.predict(stacked[te])
    P = np.stack([stacked, stacked ** 2], 1)
    rec_quad[te] = LinearRegression().fit(P[tr], y[tr]).predict(P[te])
log(f"b. stacked as-is {r2(stacked):.4f} | isotonic recal {r2(rec_iso):.4f} "
    f"| quadratic recal {r2(rec_quad):.4f}")

# --- c. residuals by quality group ---------------------------------------
try:
    from bbbp.data import load_b3db_regression
    ds = load_b3db_regression()
    smap = {}
    for s, g in zip(ds.smiles, getattr(ds, "groups", [None] * len(ds.smiles))):
        smap[s] = g
    groups = np.array([smap.get(s) for s in data.smiles])
    for g in sorted(set(groups.tolist()) - {None}):
        m = groups == g
        log(f"c. group {g}: n={int(m.sum())} stacked-R2(within)={r2(stacked, m):.3f} "
            f"mean|res|={float(np.abs(y - stacked)[m].mean()):.3f}")
except Exception as e:
    log(f"c. group analysis unavailable: {e}")
res = np.abs(y - stacked)
qs = np.quantile(y, [0, .1, .25, .75, .9, 1.0])
for lo, hi in zip(qs[:-1], qs[1:]):
    m = (y >= lo) & (y <= hi)
    log(f"c. y in [{lo:+.2f},{hi:+.2f}]: n={int(m.sum())} mean|res|="
        f"{float(res[m].mean()):.3f}")

# --- d. greedy leg subset (crossfit-scored) -------------------------------
names = sorted(legs)
chosen = []
best_cf = -9
while True:
    gains = []
    for nm in names:
        if nm in chosen:
            continue
        _, cf = stack_r2([legs[c] for c in chosen + [nm]])
        gains.append((cf, nm))
    gains.sort(reverse=True)
    if not gains or gains[0][0] <= best_cf + 1e-5:
        break
    best_cf, nm = gains[0]
    chosen.append(nm)
    log(f"d. +{nm}: crossfit={best_cf:.4f}")
ins_sel, cf_sel = stack_r2([legs[c] for c in chosen])
log(f"d. selected {chosen}: insample={ins_sel:.4f} crossfit={cf_sel:.4f} "
    f"(all-legs: {stack_r2(cols)})")
log("DONE")
