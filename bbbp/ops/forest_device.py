"""Fully on-device GBDT / random-forest TRAINING in one jitted program.

The reference trains XGBoost/CatBoost/RF on host CPUs
(Models/multi_input_data_regression_opt_transformer_cnn_20250113.py:262-391).
Here the entire boosting loop runs in ONE jit on the device:

- features are quantile-binned once on host (uint8, ≤64 bins);
- per level, gradient/hessian histograms come from one of two engines
  (``hist`` static arg): ``scatter`` (default) — one fused segment_sum per
  feature chunk, O(n·F) work, best for wide feature spaces; ``matmul`` —
  einsum('nk,nm->km') of the (g,h)-weighted node-assignment one-hot against
  the (feature×bin) one-hot, i.e. a matmul does the split search with ZERO
  scatters (see SCATTER_SEGMENT_BUDGET) at O(n·F·B·nodes) FLOPs — only
  worth it for narrow (post-PCA) matrices;
- trees use an implicit full-binary layout (level l = 2^l nodes) so every
  shape is static; dead nodes degrade to always-go-left;
- the scan over trees updates predictions in-place via the final node
  assignment (no traversal needed during training);
- row subsampling = Bernoulli mask on (g, h); RF bootstrap = Poisson(1)
  sample weights; column subsampling = per-tree feature mask on the gains;
  oblivious (CatBoost-style) mode sums gains over the level before argmax.

Inference reuses the same implicit layout: D gather/compare steps, batch-
parallel, mesh-shardable. Estimator classes mirror bbbp.ops.forest's API.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bbbp.ops.forest import BinMapper, MAX_BINS


@dataclass
class DenseTreeEnsemble:
    """Implicit-layout forest: level-l internal nodes at flat [2^l-1, 2^{l+1}-1)."""

    feat: jnp.ndarray     # [T, 2^D - 1] int32
    thr: jnp.ndarray      # [T, 2^D - 1] f32 — go right iff x[f] > thr
    leaf: jnp.ndarray     # [T, 2^D] f32
    depth: int
    base_score: float
    tree_scale: float

    def raw_predict(self, x: jnp.ndarray) -> jnp.ndarray:
        """Gather-free routing evaluation: one-hot feature selection as a
        matmul, then level-wise route products — pure matmul + elementwise.
        It was chosen over the gather traversal (``raw_predict_gather``) on
        an earlier build's accelerator and has not been re-measured on the
        GPU."""
        return _dense_predict_route(self.feat, self.thr, self.leaf,
                                    jnp.asarray(x, jnp.float32), self.depth,
                                    self.base_score, self.tree_scale)

    def raw_predict_gather(self, x: jnp.ndarray) -> jnp.ndarray:
        return _dense_predict(self.feat, self.thr, self.leaf,
                              jnp.asarray(x, jnp.float32), self.depth,
                              self.base_score, self.tree_scale)


@functools.partial(jax.jit, static_argnums=(4,))
def _dense_predict(feat, thr, leaf, x, depth, base_score, tree_scale):
    n = x.shape[0]
    T = feat.shape[0]
    pos = jnp.zeros((n, T), dtype=jnp.int32)
    t_idx = jnp.arange(T)[None, :]
    for l in range(depth):
        flat = (1 << l) - 1 + pos
        f = feat[t_idx, flat]                        # [n, T]
        t = thr[t_idx, flat]
        xv = jnp.take_along_axis(x, f, axis=1)
        pos = 2 * pos + (xv > t).astype(jnp.int32)
    vals = leaf[t_idx, pos]
    return base_score + tree_scale * jnp.sum(vals, axis=1)


@functools.partial(jax.jit, static_argnums=(4,))
def _dense_predict_route(feat, thr, leaf, x, depth, base_score, tree_scale):
    """Evaluate every internal node's comparison via one one-hot matmul, then
    route probabilities down the implicit tree with aligned slices — no
    gathers anywhere. Row-chunked to bound the [rows, T, 2^D] route tensor."""
    n, F = x.shape
    T, n_internal = feat.shape
    sel = jax.nn.one_hot(feat.reshape(-1), F, dtype=jnp.float32)  # [T*I, F]

    def eval_rows(xr):
        rows = xr.shape[0]
        # HIGHEST precision: a reduced-precision matmul (bf16, TF32) rounds
        # x, flipping comparisons for values near thresholds (quantile edges
        # ARE data values); full-f32 selection keeps parity with the gather
        # traversal
        xg = jnp.matmul(xr, sel.T,
                        precision=jax.lax.Precision.HIGHEST
                        ).reshape(rows, T, n_internal)
        go_right = (xg > thr[None]).astype(jnp.float32)     # [rows, T, I]
        route = jnp.ones((rows, T, 1), jnp.float32)
        off = 0
        for l in range(depth):
            width = 1 << l
            d = go_right[:, :, off:off + width]
            off += width
            route = jnp.stack([route * (1 - d), route * d], axis=-1
                              ).reshape(rows, T, 2 * width)
        vals = jnp.einsum("ntl,tl->nt", route, leaf,
                          precision=jax.lax.Precision.HIGHEST)
        return base_score + tree_scale * jnp.sum(vals, axis=1)

    chunk = 4096
    if n <= chunk:
        return eval_rows(x)
    pad = (-n) % chunk
    xp = jnp.pad(x, ((0, pad), (0, 0)))
    out = jax.lax.map(eval_rows, xp.reshape(-1, chunk, F))
    return out.reshape(-1)[:n]


F_CHUNK = 256


def _chunk_gains(gl, hl, mask_c, lam, min_child, oblivious, nodes, fc, B):
    """Shared gain/argmax tail of one chunk's split search.
    gl/hl: [nodes, FC, B] cumulative (over bins) gradient/hessian sums."""
    tg = gl[:, :, -1:]
    th = hl[:, :, -1:]
    gr = tg - gl
    hr = th - hl
    gain = (gl ** 2 / (hl + lam) + gr ** 2 / (hr + lam)
            - tg ** 2 / (th + lam))
    valid = (hl >= min_child) & (hr >= min_child) & mask_c[None, :, None]
    if oblivious:
        # sum GAIN over nodes, counting unsplittable (node, f, b) entries
        # as 0 rather than poisoning the whole level with -inf (real
        # oblivious trees keep growing past unsplittable nodes); features
        # invalid for EVERY node stay excluded
        node_gain = jnp.where(valid & (gain > 0), gain, 0.0)
        total = node_gain.sum(axis=0)                        # [FC, B]
        total = jnp.where(valid.any(axis=0), total, -jnp.inf)
        flat = total.reshape(fc * B)
        best = jnp.argmax(flat)
        bg = flat[best]
        return (jnp.full((nodes,), bg), jnp.full((nodes,), best,
                                                 dtype=jnp.int32))
    flat_gain = jnp.where(valid, gain, -jnp.inf).reshape(nodes, fc * B)
    best = jnp.argmax(flat_gain, axis=1)                     # [nodes]
    bg = jnp.take_along_axis(flat_gain, best[:, None], axis=1)[:, 0]
    return bg, best.astype(jnp.int32)


def _grow_level(pos, xb_chunks, g, h, l, B, lam, min_child, col_mask_chunks,
                oblivious, hist_mode: str = "scatter"):
    """One level of split search for all current nodes.

    pos: [n] node position within level (0..2^l)
    xb_chunks: [C, n, F_CHUNK] int32 binned features, padded to chunk multiple
    col_mask_chunks: [C, F_CHUNK] bool (False on padded features)
    returns (feat_l [2^l] GLOBAL feature ids, bin_l [2^l], has_split [2^l])

    Two histogram engines, same results:

    ``scatter`` (default): exact f32 histograms via ONE fused segment_sum per
    chunk ((g, h) stacked on a trailing axis) — O(n·F) work regardless of
    level width. The chunk loop is a lax.map, so the HLO stays one map body
    no matter how wide the feature space (50k+ features compile the same
    program), peak memory is one [nodes, F_CHUNK, B] histogram pair, and the
    gain argmax reduces per-chunk before a tiny [C] cross-chunk reduction.
    (An earlier python-unrolled many-scatter form corrupted the device
    runtime's state beyond ~8 chunks×levels; see the wide-feature
    regression test in the forest tests.)

    ``matmul``: SCATTER-FREE histograms as one matmul — the node-assignment
    one-hot weighted by (g, h) [n, 2·nodes] contracts against the per-bin
    one-hot [n, FC·B] in one f32 matmul. Costs O(n·F·B·nodes) FLOPs instead
    of O(n·F) scattered adds, so it only pays for narrow feature spaces
    (post-PCA search data, F ≤ a few hundred) — but it contains ZERO
    scatters, so a vmapped (trial × fold) lane axis around it stays clear of
    SCATTER_SEGMENT_BUDGET below, which is what the batched hyperparameter
    search needs.
    """
    nodes = 1 << l
    n = pos.shape[0]
    fc = xb_chunks.shape[2]

    if hist_mode == "matmul":
        a = jax.nn.one_hot(pos, nodes, dtype=jnp.float32)        # [n, nodes]
        agh = jnp.concatenate([a * g[:, None], a * h[:, None]], axis=1)

        def chunk_best(args):
            xb_c, mask_c = args                                  # [n,FC], [FC]
            oh = (xb_c[:, :, None]
                  == jnp.arange(B, dtype=xb_c.dtype)[None, None, :])
            oh = oh.reshape(n, fc * B).astype(jnp.float32)
            hist = jnp.einsum("nk,nm->km", agh, oh,
                              precision=jax.lax.Precision.HIGHEST)
            hist = hist.reshape(2, nodes, fc, B)
            gl = jnp.cumsum(hist[0], axis=2)
            hl = jnp.cumsum(hist[1], axis=2)
            return _chunk_gains(gl, hl, mask_c, lam, min_child, oblivious,
                                nodes, fc, B)
    else:
        local_off = (jnp.arange(fc, dtype=jnp.int32) * B)[None, :]  # [1, FC]
        gh = jnp.stack([g, h], axis=1)                               # [n, 2]

        def chunk_best(args):
            xb_c, mask_c = args                                  # [n,FC], [FC]
            keys = (pos[:, None] * (fc * B) + local_off + xb_c)  # [n, FC]
            vals = jnp.broadcast_to(gh[:, None, :], (n, fc, 2)).reshape(-1, 2)
            hist = jax.ops.segment_sum(vals, keys.ravel(),
                                       num_segments=nodes * fc * B)
            hist = hist.reshape(nodes, fc, B, 2)
            gl = jnp.cumsum(hist[..., 0], axis=2)
            hl = jnp.cumsum(hist[..., 1], axis=2)
            return _chunk_gains(gl, hl, mask_c, lam, min_child, oblivious,
                                nodes, fc, B)

    bg_c, best_c = jax.lax.map(chunk_best, (xb_chunks, col_mask_chunks))
    # cross-chunk reduction: [C, nodes] -> per-node winning chunk
    c_best = jnp.argmax(bg_c, axis=0)                            # [nodes]
    best_gain = jnp.take_along_axis(bg_c, c_best[None, :], axis=0)[0]
    local = jnp.take_along_axis(best_c, c_best[None, :], axis=0)[0]
    f_best = (c_best * fc + local // B).astype(jnp.int32)
    b_best = (local % B).astype(jnp.int32)
    has_split = jnp.isfinite(best_gain) & (best_gain > 0)
    # dead nodes: everything goes left (bin threshold = B-1)
    f_best = jnp.where(has_split, f_best, 0)
    b_best = jnp.where(has_split, b_best, B - 1)
    return f_best, b_best, has_split


# Cumulative scatter-OUTPUT budget per COMPILED PROGRAM. Chosen on an earlier
# build's accelerator, not re-derived for the H100: there, any program whose
# summed segment_sum
# OUTPUT sizes (Σ num_segments over all scatter executions) exceeded ~4e9
# faulted the runtime on the NEXT program (passing programs ≤3.8e9 total
# segments, failing ones ≥1.0e10). The fit splits its tree scan across
# program launches to stay under it; the GPU has not shown the fault.
SCATTER_SEGMENT_BUDGET = 1.5e9


def _tree_scan_segments(n: int, F: int, depth: int) -> float:
    """Per-tree cumulative scatter-output ELEMENT count (level-loop histogram
    scatters carry a trailing (g, h) pair channel, so segments × 2, plus the
    leaf sums). A vmapped sweep at ~4.0e9 elements/launch still crashed while
    ~2e9 passed, so the budget keeps ≥2.5× margin under the suspected 2^32
    wall counted in elements."""
    fc = min(F_CHUNK, _pad128(F))
    n_chunks = (_pad128(F) + fc - 1) // fc
    segs = sum((1 << l) * fc * MAX_BINS * n_chunks for l in range(depth))
    return float(2 * segs + 2 * (1 << depth))


def _pad128(F: int) -> int:
    return ((F + 127) // 128) * 128


def _fit_forest_device(xb, edge_vals, y, lr, lam, min_child, subsample,
                       colsample, base_score, key, row_w=None, preds0=None,
                       *, task: str, n_trees: int, depth: int,
                       oblivious: bool, rf: bool, hist: str = "scatter"):
    """One jit: scan over trees, python-unrolled levels (static depth).

    Hyperparameters (lr, lam, ..., base_score, key) are TRACED so per-fold /
    per-seed refits reuse one compilation — only (task, n_trees, depth,
    oblivious, rf) and array shapes trigger recompiles.

    row_w: optional [n] per-row weight. Rows with weight 0 contribute nothing
    to gradients/hessians — this is how the batched hyperparameter search
    trains one fold per vmap lane on the SHARED binned matrix (no per-fold
    data copies; bbbp.train.batched_search).

    preds0: optional [n] starting margin (for multi-launch fits that resume a
    boosting run — see SCATTER_SEGMENT_BUDGET). Returns (preds_final,
    feats, thrs, leaves).
    """
    n, F = xb.shape
    B = MAX_BINS
    n_internal = (1 << depth) - 1
    n_leaves = 1 << depth

    xb_i = xb.astype(jnp.int32)
    # pad the feature axis to a chunk multiple and pre-chunk for the lax.map
    # histogram (padded features carry bin 0 and a False column mask)
    fc = min(F_CHUNK, _pad128(F))
    pad_f = (-F) % fc
    n_chunks = (F + pad_f) // fc
    xb_pad = jnp.pad(xb_i, ((0, 0), (0, pad_f)))
    xb_chunks = xb_pad.reshape(n, n_chunks, fc).transpose(1, 0, 2)
    pad_mask = jnp.arange(F + pad_f) < F                          # [Fp]
    y = jnp.asarray(y, jnp.float32)

    w_rows = jnp.ones((n,), jnp.float32) if row_w is None else row_w

    def tree_step(carry, key):
        preds = carry
        k1, k2, k3 = jax.random.split(key, 3)
        if rf:
            w = jax.random.poisson(k1, 1.0, (n,)).astype(jnp.float32) * w_rows
            g = -y * w
            h = w
        else:
            if task == "reg":
                g = preds - y
                h = jnp.ones_like(y)
            else:
                p = jax.nn.sigmoid(preds)
                g = p - y
                h = jnp.maximum(p * (1 - p), 1e-6)
            # traced subsample rate: rate >= 1.0 keeps every row
            m = (jax.random.uniform(k2, (n,)) < subsample).astype(jnp.float32)
            g = g * m * w_rows
            h = h * m * w_rows
        col_mask = jax.random.uniform(k3, (F,)) < colsample
        # ensure ≥1 feature, scatter-free (a one-element .at[].set is a
        # scatter — the vmapped matmul path must contain none)
        col_mask = col_mask | (jnp.arange(F) == jnp.argmax(col_mask))
        col_mask_chunks = (jnp.pad(col_mask, (0, pad_f)) & pad_mask
                           ).reshape(n_chunks, fc)

        feat_flat = jnp.zeros((n_internal,), jnp.int32)
        bin_flat = jnp.zeros((n_internal,), jnp.int32)
        pos = jnp.zeros((n,), jnp.int32)
        for l in range(depth):
            f_l, b_l, _ = _grow_level(pos, xb_chunks, g, h, l, B, lam,
                                      min_child, col_mask_chunks, oblivious,
                                      hist_mode=hist)
            off = (1 << l) - 1
            feat_flat = jax.lax.dynamic_update_slice(feat_flat, f_l, (off,))
            bin_flat = jax.lax.dynamic_update_slice(bin_flat, b_l, (off,))
            xf = jnp.take_along_axis(xb_i, f_l[pos][:, None], axis=1)[:, 0]
            pos = 2 * pos + (xf > b_l[pos]).astype(jnp.int32)

        if hist == "matmul":
            oh_leaf = jax.nn.one_hot(pos, n_leaves, dtype=jnp.float32)
            sums = jnp.einsum("nc,nl->cl", jnp.stack([g, h], axis=1), oh_leaf,
                              precision=jax.lax.Precision.HIGHEST)
            gs, hs = sums[0], sums[1]
        else:
            gs = jax.ops.segment_sum(g, pos, num_segments=n_leaves)
            hs = jax.ops.segment_sum(h, pos, num_segments=n_leaves)
        leaf = -gs / (hs + lam)
        # accumulate predictions for RF too (scaled by 1/T at read time):
        # the vmapped search path reads fold-validation predictions straight
        # from preds_f instead of a separate traversal
        preds = preds + (leaf[pos] if rf else lr * leaf[pos])
        thr_flat = edge_vals[feat_flat, bin_flat]
        return preds, (feat_flat, thr_flat, leaf)

    keys = jax.random.split(key, n_trees)
    if preds0 is None:
        preds0 = jnp.full((n,), 1.0, jnp.float32) * base_score
    preds_f, (feats, thrs, leaves) = jax.lax.scan(tree_step, preds0, keys)
    return preds_f, feats, thrs, leaves


# jit once per (task, n_trees, depth, oblivious, rf, shapes); hyperparameters
# and the PRNG key are traced, so per-fold refits hit the compile cache
_fit_forest_jit = jax.jit(
    _fit_forest_device,
    static_argnames=("task", "n_trees", "depth", "oblivious", "rf", "hist"),
)


def fit_forest_launched(xb, edge_vals, y, lr, lam, min_child, subsample,
                        colsample, base_score, key, row_w=None, *, task: str,
                        n_trees: int, depth: int, oblivious: bool, rf: bool,
                        lanes: int = 1, hist: str = "scatter"):
    """Boosting/bagging fit split across program launches so each compiled
    program stays under SCATTER_SEGMENT_BUDGET (see comment above).
    ``lanes`` scales the budget accounting for
    vmapped callers (trials × folds). ``hist='matmul'`` programs contain no
    scatters at all, so the whole fit runs in one launch.
    Returns (feats, thrs, leaves)."""
    n, F = (int(xb.shape[-2]), int(xb.shape[-1]))
    if hist == "matmul":
        chunk = n_trees
    else:
        per_tree = _tree_scan_segments(n, F, depth) * max(1, lanes)
        chunk = max(1, int(SCATTER_SEGMENT_BUDGET // per_tree))
    preds = jnp.full((n,), 1.0, jnp.float32) * jnp.float32(base_score)
    feats_l, thrs_l, leaves_l = [], [], []
    done = 0
    launch = 0
    while done < n_trees:
        t = min(chunk, n_trees - done)
        k = jax.random.fold_in(key, launch)
        preds, feats, thrs, leaves = _fit_forest_jit(
            xb, edge_vals, y, lr, lam, min_child, subsample, colsample,
            base_score, k, row_w, preds, task=task, n_trees=t, depth=depth,
            oblivious=oblivious, rf=rf, hist=hist)
        feats_l.append(feats)
        thrs_l.append(thrs)
        leaves_l.append(leaves)
        done += t
        launch += 1
    if len(feats_l) == 1:
        return feats_l[0], thrs_l[0], leaves_l[0]
    return (jnp.concatenate(feats_l, axis=0), jnp.concatenate(thrs_l, axis=0),
            jnp.concatenate(leaves_l, axis=0))


def dense_to_tree_arrays(ens: DenseTreeEnsemble, background: np.ndarray):
    """Convert the implicit layout to explicit _TreeArrays (for exact
    TreeSHAP). Node cover comes from routing a background sample through each
    tree (interventional-style weighting; the dense layout stores no training
    hessian mass)."""
    from bbbp.ops.forest import _TreeArrays

    feat = np.asarray(ens.feat)
    thr = np.asarray(ens.thr)
    leaf = np.asarray(ens.leaf)
    T = feat.shape[0]
    D = ens.depth
    bg = np.asarray(background, np.float32)
    trees = []
    n_internal = (1 << D) - 1
    n_total = n_internal + (1 << D)
    for t in range(T):
        feature = np.full(n_total, -1, np.int32)
        threshold = np.zeros(n_total, np.float32)
        left = np.full(n_total, -1, np.int32)
        right = np.full(n_total, -1, np.int32)
        value = np.zeros(n_total, np.float32)
        # implicit flat index: internal node i at level l occupies 2^l-1+pos;
        # leaves come after all internals
        feature[:n_internal] = feat[t]
        threshold[:n_internal] = thr[t]
        for i in range(n_internal):
            l = int(np.floor(np.log2(i + 1)))
            pos = i - ((1 << l) - 1)
            if l + 1 < D:
                child_base = (1 << (l + 1)) - 1
                left[i] = child_base + 2 * pos
                right[i] = child_base + 2 * pos + 1
            else:
                left[i] = n_internal + 2 * pos
                right[i] = n_internal + 2 * pos + 1
        value[n_internal:] = leaf[t]
        # cover by routing the background
        counts = np.zeros(n_total, np.float64)
        node = np.zeros(len(bg), np.int64)
        counts[0] = len(bg)
        for l in range(D):
            f = feature[node]
            go_left = bg[np.arange(len(bg)), np.maximum(f, 0)] <= threshold[node]
            node = np.where(go_left, left[node], right[node])
            np.add.at(counts, node, 1)
        trees.append(_TreeArrays(feature, threshold, left, right, value,
                                 np.maximum(counts, 1e-6).astype(np.float32)))
    return trees


# pad estimator fits to power-of-2 row buckets (floor 256) so nearby train
# sizes reuse one compiled program; flip off to fit at exact row counts
ROW_BUCKETING = True


def _row_bucket(n: int) -> int:
    b = 256
    while b < n:
        b <<= 1
    return b


class _DeviceForestBase:
    def __init__(self, n_estimators=300, max_depth=6, learning_rate=0.1,
                 reg_lambda=1.0, min_child_weight=1.0, subsample=1.0,
                 colsample=1.0, oblivious=False, seed=0):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.reg_lambda = reg_lambda
        self.min_child_weight = min_child_weight
        self.subsample = subsample
        self.colsample = colsample
        self.oblivious = oblivious
        self.seed = seed
        self.ensemble_: Optional[DenseTreeEnsemble] = None

    def _prepare(self, x):
        x = np.asarray(x, dtype=np.float32)
        self.mapper_ = BinMapper().fit(x)
        xb = self.mapper_.transform(x)
        F = x.shape[1]
        edge_vals = np.full((F, MAX_BINS), np.inf, dtype=np.float32)
        for f, e in enumerate(self.mapper_.edges_):
            if len(e):
                edge_vals[f, : len(e)] = e
                edge_vals[f, len(e):] = np.inf
        return jnp.asarray(xb), jnp.asarray(edge_vals)

    def _fit(self, x, y, task: str, rf: bool, base_score: float,
             sample_weight=None):
        # sample_weight (sklearn-style) maps to the engine's row_w: weight-0
        # rows contribute nothing to any histogram/leaf, so holdout
        # evaluations can reuse the full-matrix compiled program instead of
        # paying a new static row shape (and compile) per subset.
        xb, edge_vals = self._prepare(x)
        y_fit = np.asarray(y, np.float32)
        row_w = (None if sample_weight is None
                 else jnp.asarray(sample_weight, jnp.float32))
        # ROW BUCKETING: pad the row axis to a power-of-2 bucket with
        # weight-0 rows so fits at nearby train sizes (CV folds, learning
        # curves, search subsets) share ONE compiled program per bucket —
        # weight-0 rows are exactly neutral in the kernel (g/h and Poisson
        # bootstrap weights all multiply row_w), so results match the
        # unpadded fit; only the RNG realization of row subsampling differs.
        n = int(xb.shape[0])
        nb = _row_bucket(n) if ROW_BUCKETING else n
        if nb != n:
            xb = jnp.pad(xb, ((0, nb - n), (0, 0)))
            y_fit = np.concatenate([y_fit, np.zeros(nb - n, np.float32)])
            w = (np.ones(n, np.float32) if sample_weight is None
                 else np.asarray(sample_weight, np.float32))
            row_w = jnp.asarray(
                np.concatenate([w, np.zeros(nb - n, np.float32)]))
        feats, thrs, leaves = fit_forest_launched(
            xb, edge_vals, y_fit,
            jnp.float32(self.learning_rate), jnp.float32(self.reg_lambda),
            jnp.float32(self.min_child_weight), jnp.float32(self.subsample),
            jnp.float32(self.colsample), jnp.float32(base_score),
            jax.random.PRNGKey(self.seed), row_w=row_w, task=task,
            n_trees=self.n_estimators, depth=self.max_depth,
            oblivious=self.oblivious, rf=rf)
        scale = (1.0 / self.n_estimators) if rf else self.learning_rate
        self.ensemble_ = DenseTreeEnsemble(feats, thrs, leaves, self.max_depth,
                                           base_score, scale)
        return self

    def get_params(self, deep=True):
        return {k: getattr(self, k) for k in
                ("n_estimators", "max_depth", "learning_rate", "reg_lambda",
                 "min_child_weight", "subsample", "colsample", "oblivious", "seed")}

    def set_params(self, **p):
        for k, v in p.items():
            setattr(self, k, v)
        return self


def _wmean(y, w):
    y = np.asarray(y, np.float64)
    if w is None:
        return float(y.mean())
    w = np.asarray(w, np.float64)
    return float((y * w).sum() / max(w.sum(), 1e-12))


class DeviceGBDTRegressor(_DeviceForestBase):
    def fit(self, x, y, sample_weight=None):
        return self._fit(x, y, "reg", rf=False,
                         base_score=_wmean(y, sample_weight),
                         sample_weight=sample_weight)

    def predict(self, x) -> np.ndarray:
        return np.asarray(self.ensemble_.raw_predict(jnp.asarray(x, jnp.float32)))


class DeviceGBDTClassifier(_DeviceForestBase):
    def fit(self, x, y, sample_weight=None):
        p0 = float(np.clip(_wmean(y, sample_weight), 1e-6, 1 - 1e-6))
        return self._fit(x, y, "cls", rf=False,
                         base_score=float(np.log(p0 / (1 - p0))),
                         sample_weight=sample_weight)

    def decision_function(self, x) -> np.ndarray:
        return np.asarray(self.ensemble_.raw_predict(jnp.asarray(x, jnp.float32)))

    def predict_proba(self, x) -> np.ndarray:
        p = 1.0 / (1.0 + np.exp(-self.decision_function(x)))
        return np.stack([1 - p, p], axis=1)

    def predict(self, x) -> np.ndarray:
        return (self.decision_function(x) > 0).astype(np.int32)


class DeviceRandomForestRegressor(_DeviceForestBase):
    def __init__(self, n_estimators=300, max_depth=10, colsample=1.0,
                 min_child_weight=1.0, **kw):
        kw.setdefault("reg_lambda", 1e-6)
        super().__init__(n_estimators=n_estimators, max_depth=max_depth,
                         colsample=colsample,
                         min_child_weight=min_child_weight, **kw)

    def fit(self, x, y, sample_weight=None):
        return self._fit(x, y, "reg", rf=True, base_score=0.0,
                         sample_weight=sample_weight)

    def predict(self, x) -> np.ndarray:
        return np.asarray(self.ensemble_.raw_predict(jnp.asarray(x, jnp.float32)))


class DeviceRandomForestClassifier(DeviceRandomForestRegressor):
    def __init__(self, n_estimators=300, max_depth=10, colsample=0.5, **kw):
        super().__init__(n_estimators=n_estimators, max_depth=max_depth,
                         colsample=colsample, **kw)

    def predict_proba(self, x) -> np.ndarray:
        p = np.clip(super().predict(x), 0.0, 1.0)
        return np.stack([1 - p, p], axis=1)

    def predict(self, x) -> np.ndarray:
        return (np.clip(super(DeviceRandomForestClassifier, self).predict(x), 0, 1)
                > 0.5).astype(np.int32)
