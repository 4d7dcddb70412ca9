"""Estimate (CPU, SCHED_IDLE) whether E-state indices + Moreau-Broto
autocorrelations added to the descriptor block move the honest-protocol
kernel/tree legs. Prototype descriptors computed inline; land them in
bbbp/chem only if the measured gain is real."""
import json
import os
import sys
import time

sys.path.insert(0, "/root/repo")
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("BBBP_TRANSFER_CACHE", "/root/repo/.bench_cache")

import numpy as np

T0 = time.time()


def log(m):
    print(f"[estd +{time.time()-T0:6.0f}s] {m}", flush=True)


from bbbp.chem.smiles import MolFromSmiles
from bbbp.chem.depict import graph_distances
from bbbp.chem.crippen import PARAMS, atom_type
from bbbp.train.transfer import raw_transfer_features
from bbbp.pipelines.preprocess import ProcessedData
from bbbp.train.loop import kfold_indices

_L = {1: 1, 6: 2, 7: 2, 8: 2, 9: 2, 14: 3, 15: 3, 16: 3, 17: 3, 35: 4, 53: 5}
_ZV = {5: 3, 6: 4, 7: 5, 8: 6, 9: 7, 14: 4, 15: 5, 16: 6, 17: 7, 35: 7, 53: 7}
_EN = {1: 2.2, 5: 2.04, 6: 2.55, 7: 3.04, 8: 3.44, 9: 3.98, 14: 1.9,
       15: 2.19, 16: 2.58, 17: 3.16, 35: 2.96, 53: 2.66}

# E-state aggregation buckets: (z, aromatic, has_h)
_BUCKETS = [(6, False), (6, True), (7, False), (7, True), (8, False),
            (8, True), (16, False), (16, True), (9, False), (17, False),
            (35, False), (53, False), (15, False)]


def estate_ats(smiles):
    """Per-molecule [estate sums per bucket (13) + hydrophobic/hydrophilic
    S-sums (2) + ATS logP/EN/I lag 1..6 (18)] = 33 dims."""
    out = np.zeros((len(smiles), 13 + 2 + 18), np.float32)
    for k, smi in enumerate(smiles):
        mol = MolFromSmiles(smi)
        if mol is None:
            continue
        heavy = [a for a in mol.atoms if a.z > 1]
        nH = len(heavy)
        if nH == 0:
            continue
        idx = [a.idx for a in heavy]
        # intrinsic state
        I = np.zeros(mol.num_atoms)
        for a in heavy:
            delta = max(1, sum(1 for j in mol.atom_neighbors(a.idx)
                               if mol.atoms[j].z > 1))
            h = mol.total_h(a.idx)
            dv = max(1, _ZV.get(a.z, 4) - h)
            L = _L.get(a.z, 2)
            I[a.idx] = ((2.0 / L) ** 2 * dv + 1.0) / delta
        d = graph_distances(mol)
        S = I.copy()
        for a in heavy:
            for b in heavy:
                if a.idx == b.idx:
                    continue
                S[a.idx] += (I[a.idx] - I[b.idx]) / (d[a.idx, b.idx] + 1.0) ** 2
        col = 0
        for z, arom in _BUCKETS:
            out[k, col] = sum(S[a.idx] for a in heavy
                              if a.z == z and a.aromatic == arom)
            col += 1
        # hydrophobic (S<=1.48 heuristic split) / hydrophilic sums
        sv = np.array([S[a.idx] for a in heavy])
        out[k, col] = float(sv[sv < 1.0].sum()); col += 1
        out[k, col] = float(sv[sv >= 1.0].sum()); col += 1
        # per-atom weights
        lp = np.zeros(mol.num_atoms)
        for a in heavy:
            lp[a.idx] = PARAMS[atom_type(mol, a.idx)][0]
        en = np.array([_EN.get(mol.atoms[i].z, 2.5) if mol.atoms[i].z > 1
                       else 0.0 for i in range(mol.num_atoms)])
        for w in (lp, en, I):
            for lag in range(1, 7):
                pairs = (d == lag)
                out[k, col] = float(np.log1p(abs((w[:, None] * w[None, :]
                                                  * pairs).sum() / 2.0)))
                col += 1
    return out


data = ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw0.pkl")
y = data.y
n = len(y)
folds = kfold_indices(n, 10, 42)
reg_desc, reg_maccs, reg_counts = raw_transfer_features(data.smiles)

cpath = "/root/repo/.bench_cache/estate_reg.npy"
if os.path.exists(cpath):
    extra = np.load(cpath)
else:
    t0 = time.time()
    extra = estate_ats(data.smiles)
    np.save(cpath, extra)
    log(f"estate/ats computed for {n} molecules ({time.time()-t0:.0f}s)")


def r2(p):
    return float(1 - ((y - p) ** 2).sum() / ((y - y.mean()) ** 2).sum())


def tanimoto_K(b):
    i = b @ b.T
    u = b.sum(1)[:, None] + b.sum(1)[None] - i
    return i / np.maximum(u, 1e-9)


def minmax_K(c):
    # min(a,b) = sum_t [a>=t][b>=t]: threshold-level bit matmuls instead of
    # the N x N x D broadcast (which would be ~17 GB here)
    tmax = int(c.max())
    mn = np.zeros((len(c), len(c)))
    for t in range(1, tmax + 1):
        b = (c >= t).astype(np.float64)
        mn += b @ b.T
    s = c.sum(1)
    mx = s[:, None] + s[None] - mn
    return mn / np.maximum(mx, 1e-9)


def rbf_K(x):
    from sklearn.preprocessing import StandardScaler
    xs = StandardScaler().fit_transform(x)
    sq = (xs ** 2).sum(1)
    d2 = sq[:, None] + sq[None] - 2 * xs @ xs.T
    gamma = 1.0 / np.median(np.maximum(d2, 1e-9))
    return np.exp(-gamma * d2)


def krr_oof(K, lam):
    oof = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        Ktr = K[np.ix_(tr, tr)]
        a = np.linalg.solve(Ktr + lam * np.eye(len(tr)), y[tr] - y[tr].mean())
        oof[te] = K[np.ix_(te, tr)] @ a + y[tr].mean()
    return oof


K_m = tanimoto_K((reg_maccs > 0).astype(np.float64))
K_c = minmax_K(reg_counts.astype(np.float64))
K_b = tanimoto_K((reg_counts > 0).astype(np.float64))
K_d = rbf_K(reg_desc)
K_d2 = rbf_K(np.concatenate([reg_desc, extra], 1))
K_e = rbf_K(extra)

log(f"rbf(desc31)      oof R2={r2(krr_oof(K_d, 0.06)):.4f}")
log(f"rbf(estate/ats)  oof R2={r2(krr_oof(K_e, 0.06)):.4f}")
log(f"rbf(desc64)      oof R2={r2(krr_oof(K_d2, 0.06)):.4f}")
base = 0.25 * (K_m + K_b + K_c + K_d)
enr = 0.25 * (K_m + K_b + K_c + K_d2)
for lam in (0.04, 0.06, 0.1):
    log(f"ckrr base lam={lam}: R2={r2(krr_oof(base, lam)):.4f}  "
        f"enriched: R2={r2(krr_oof(enr, lam)):.4f}")
# 5-block with estate as its own kernel
for w_e in (0.15, 0.25):
    w = (1 - w_e) / 4
    enr5 = w * (K_m + K_b + K_c + K_d) + w_e * K_e
    log(f"ckrr 5-block w_e={w_e}: R2={r2(krr_oof(enr5, 0.06)):.4f}")

# tree proxy: sklearn GBR on hstack features
from sklearn.ensemble import GradientBoostingRegressor


def gbr_oof(X):
    oof = np.zeros(n)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        m = GradientBoostingRegressor(n_estimators=300, learning_rate=0.05,
                                      max_depth=3, subsample=0.8,
                                      random_state=0).fit(X[tr], y[tr])
        oof[te] = m.predict(X[te])
    return oof


Xb = np.concatenate([reg_desc, reg_maccs, reg_counts], 1)
Xe = np.concatenate([Xb, extra], 1)
log(f"gbr base      oof R2={r2(gbr_oof(Xb)):.4f}")
log(f"gbr enriched  oof R2={r2(gbr_oof(Xe)):.4f}")
log("DONE")
