"""Offline meta-learner comparison over per-seed OOF member columns
(written by train/regression.py into <out_dir>/oof_predictions.pkl).

Usage: python scripts/analyze_perseed.py [oof_predictions.pkl]

Prints, for averaged-leg vs per-seed-member matrices: linear / ridge(alpha
sweep) / nnls metas, in-sample (the reference's protocol, :394-403) and
10-fold cross-fitted.
"""
import os
import pickle
import sys

sys.path.insert(0, "/root/repo")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np

PATH = sys.argv[1] if len(sys.argv) > 1 else \
    "/root/repo/results/reg_maccs_honest_push/oof_predictions.pkl"

with open(PATH, "rb") as f:
    d = pickle.load(f)
y = np.asarray(d["y"], np.float64)
n = len(y)

LEGS = [k for k in ("nn", "smiles", "graph", "rf", "gbdt", "cat", "knn",
                    "ridge", "tknn", "tkrr", "ckrr", "transfer") if k in d]
seed_keys = sorted(k for k in d if "_seed" in k)
member_cols, member_names = [], []
for leg in LEGS:
    sk = [k for k in seed_keys if k.startswith(leg + "_seed")]
    if sk:
        member_cols += [np.asarray(d[k], np.float64) for k in sk]
        member_names += sk
    else:
        member_cols.append(np.asarray(d[leg], np.float64))
        member_names.append(leg)
X_avg = np.stack([np.asarray(d[k], np.float64) for k in LEGS], 1)
X_mem = np.stack(member_cols, 1)
print(f"legs={LEGS}")
print(f"member columns ({X_mem.shape[1]}): {member_names}")

from sklearn.linear_model import LinearRegression, Ridge

from bbbp.ops.linear import NonNegativeLinearRegression
from bbbp.train.loop import kfold_indices

folds = kfold_indices(n, 10, 42)


def r2(p):
    return float(1 - ((y - p) ** 2).sum() / ((y - y.mean()) ** 2).sum())


def mse(p):
    return float(((y - p) ** 2).mean())


def evaluate(X, ctor):
    m = ctor().fit(X, y)
    p_in = np.asarray(m.predict(X))
    out = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        out[te] = ctor().fit(X[tr], y[tr]).predict(X[te])
    return p_in, out


metas = [("linear", LinearRegression), ("nnls", NonNegativeLinearRegression)]
metas += [(f"ridge{a}", (lambda a=a: Ridge(a))) for a in (0.1, 1.0, 3.0, 10.0)]

for label, X in (("averaged legs", X_avg), ("per-seed members", X_mem)):
    print(f"\n== {label} ({X.shape[1]} cols) ==")
    for name, ctor in metas:
        p_in, p_cv = evaluate(X, ctor)
        print(f"  {name:9s} in-sample R2={r2(p_in):.4f} MSE={mse(p_in):.4f}"
              f"   crossfit R2={r2(p_cv):.4f} MSE={mse(p_cv):.4f}")
