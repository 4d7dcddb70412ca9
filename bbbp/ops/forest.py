"""Tensorized decision-forest engine: histogram training, JAX inference.

Replaces the reference's RF / XGBoost / CatBoost / GradientBoosting legs
(reference: Models/multi_input_data_regression_opt_transformer_cnn_20250113.py:262-391,
Models/model_opt_20250130.py:413-457) with a single engine, per SURVEY.md §7:

- **Training** (host, vectorized numpy): LightGBM-style quantile binning +
  level-wise histogram split search with XGBoost gain
  (GL²/(HL+λ) + GR²/(HR+λ) − G²/(H+λ)); gradient boosting (squared loss /
  logloss) and random forests (bootstrap + feature subsampling) share it —
  an RF tree is the λ=0, g=−y, h=1 special case whose leaf value is mean(y).
- **Inference** (device, jit): trees packed into [n_trees, max_nodes] arrays;
  depth-synchronous gather/compare traversal — no data-dependent control flow,
  fully batched, vmap/pjit-friendly. Also used by the screening pipeline and
  exact TreeSHAP attribution.
- ``oblivious=True`` grows CatBoost-style symmetric trees (one (feature,
  threshold) per level) as the CatBoost surrogate.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

MAX_BINS = 64


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------

class BinMapper:
    """Quantile binning to uint8 codes; thresholds midway between bin edges."""

    def __init__(self, n_bins: int = MAX_BINS):
        self.n_bins = n_bins
        self.edges_: List[np.ndarray] = []

    def fit(self, x: np.ndarray) -> "BinMapper":
        x = np.asarray(x, dtype=np.float32)
        self.edges_ = []
        qs = np.linspace(0, 1, self.n_bins + 1)[1:-1]
        for f in range(x.shape[1]):
            e = np.unique(np.quantile(x[:, f], qs))
            self.edges_.append(e.astype(np.float32))
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32)
        out = np.empty(x.shape, dtype=np.uint8)
        for f, e in enumerate(self.edges_):
            # side='left': bin(x) = #{edges < x}, so "bin <= b" ⟺ "x <= e[b]"
            # exactly — keeps binned training and real-valued inference splits
            # consistent even when x equals a quantile edge.
            out[:, f] = np.searchsorted(e, x[:, f], side="left")
        return out

    def threshold_value(self, f: int, b: int) -> float:
        """Real-valued threshold for 'bin <= b' split on feature f."""
        e = self.edges_[f]
        if len(e) == 0:
            return np.inf
        return float(e[min(b, len(e) - 1)])


# ---------------------------------------------------------------------------
# Level-wise histogram tree growing (numpy)
# ---------------------------------------------------------------------------

@dataclass
class _TreeArrays:
    feature: np.ndarray    # [nodes] int32, -1 = leaf
    threshold: np.ndarray  # [nodes] float32 (x <= t goes left)
    left: np.ndarray       # [nodes] int32
    right: np.ndarray      # [nodes] int32
    value: np.ndarray      # [nodes] float32 (valid at leaves)
    cover: np.ndarray      # [nodes] float32 (sum of hessians; for TreeSHAP)


def _grow_tree(xb: np.ndarray, g: np.ndarray, h: np.ndarray, mapper: BinMapper,
               feat_ids: np.ndarray, max_depth: int, reg_lambda: float,
               min_child_weight: float, min_gain: float,
               oblivious: bool) -> _TreeArrays:
    """Level-wise growth. xb is pre-binned [n, F_sub] over feat_ids columns."""
    n, F = xb.shape
    B = MAX_BINS
    feature = [-1]
    threshold = [0.0]
    left = [-1]
    right = [-1]
    value = [0.0]
    cover = [float(h.sum())]
    # sample -> node index (into the arrays above)
    node_of = np.zeros(n, dtype=np.int64)
    active = [0]  # node ids still splittable at current level

    for depth in range(max_depth):
        if not active:
            break
        pos_of_node = {nid: i for i, nid in enumerate(active)}
        pos = np.array([pos_of_node.get(nid, -1) for nid in range(len(feature))])
        sample_pos = pos[node_of]                        # [n], -1 = frozen
        live = sample_pos >= 0
        if not live.any():
            break
        A = len(active)
        idx = (sample_pos[live][:, None] * F + np.arange(F)[None, :]) * B + xb[live]
        flat = idx.ravel()
        rep_g = np.repeat(g[live], F)
        rep_h = np.repeat(h[live], F)
        size = A * F * B
        hg = np.bincount(flat, weights=rep_g, minlength=size).reshape(A, F, B)
        hh = np.bincount(flat, weights=rep_h, minlength=size).reshape(A, F, B)
        # cumulative over bins: split 'bin <= b' left
        cg = np.cumsum(hg, axis=2)
        ch = np.cumsum(hh, axis=2)
        tg = cg[:, :, -1:]
        th = ch[:, :, -1:]
        gl, hl = cg, ch
        gr, hr = tg - cg, th - ch
        valid = (hl >= min_child_weight) & (hr >= min_child_weight)
        gain = (
            gl ** 2 / (hl + reg_lambda)
            + gr ** 2 / (hr + reg_lambda)
            - tg ** 2 / (th + reg_lambda)
        )
        gain = np.where(valid, gain, -np.inf)
        if oblivious:
            # one (feature, bin) for the whole level: maximize summed gain
            level_gain = gain.sum(axis=0)                # [F, B]
            level_gain = np.where(np.isfinite(gain).all(axis=0), level_gain, -np.inf)
            if not np.isfinite(level_gain).any():
                break
            f_best, b_best = np.unravel_index(np.argmax(level_gain), level_gain.shape)
            chosen = [(int(f_best), int(b_best))] * A
            gains = gain[:, f_best, b_best]
        else:
            flat_gain = gain.reshape(A, F * B)
            best = flat_gain.argmax(axis=1)
            gains = flat_gain[np.arange(A), best]
            chosen = [(int(b // B), int(b % B)) for b in best]

        new_active = []
        split_nodes = {}
        for a, nid in enumerate(active):
            f_sub, b = chosen[a]
            if not np.isfinite(gains[a]) or gains[a] <= min_gain:
                continue
            l_id = len(feature)
            r_id = l_id + 1
            feature[nid] = int(feat_ids[f_sub])
            threshold[nid] = mapper.threshold_value(int(feat_ids[f_sub]), b)
            left[nid] = l_id
            right[nid] = r_id
            for cid in (l_id, r_id):
                feature.append(-1)
                threshold.append(0.0)
                left.append(-1)
                right.append(-1)
                value.append(0.0)
                cover.append(0.0)
            split_nodes[nid] = (f_sub, b, l_id, r_id)
            new_active.extend([l_id, r_id])
        if not split_nodes:
            break
        # route samples
        for nid, (f_sub, b, l_id, r_id) in split_nodes.items():
            rows = node_of == nid
            goes_left = xb[:, f_sub] <= b
            node_of = np.where(rows & goes_left, l_id, node_of)
            node_of = np.where(rows & ~goes_left, r_id, node_of)
        active = new_active

    # leaf values: -G/(H+λ)
    feature_arr = np.asarray(feature, dtype=np.int32)
    value_arr = np.asarray(value, dtype=np.float32)
    cover_arr = np.asarray(cover, dtype=np.float32)
    gs = np.bincount(node_of, weights=g, minlength=len(feature))
    hs = np.bincount(node_of, weights=h, minlength=len(feature))
    leaf_mask = feature_arr < 0
    value_arr[leaf_mask] = (-gs[leaf_mask] / (hs[leaf_mask] + reg_lambda)).astype(np.float32)
    cover_arr[:] = 0.0
    # cover per node (hessian mass) by walking samples once more is costly;
    # compute from leaves upward: internal cover = child sums
    cov = np.bincount(node_of, weights=h, minlength=len(feature)).astype(np.float32)
    for nid in range(len(feature) - 1, -1, -1):
        if feature_arr[nid] >= 0:
            cov[nid] = cov[left[nid]] + cov[right[nid]]
    return _TreeArrays(
        feature_arr,
        np.asarray(threshold, dtype=np.float32),
        np.asarray(left, dtype=np.int32),
        np.asarray(right, dtype=np.int32),
        value_arr,
        cov,
    )


# ---------------------------------------------------------------------------
# Packed ensemble + JAX inference
# ---------------------------------------------------------------------------

@dataclass
class TreeEnsemble:
    """Forest packed to rectangular arrays for on-device traversal."""

    feature: jnp.ndarray    # [T, M] int32 (-1 leaf)
    threshold: jnp.ndarray  # [T, M] f32
    left: jnp.ndarray       # [T, M] int32
    right: jnp.ndarray      # [T, M] int32
    value: jnp.ndarray      # [T, M] f32
    cover: jnp.ndarray      # [T, M] f32
    max_depth: int
    base_score: float = 0.0
    tree_scale: float = 1.0   # learning rate (GBDT) or 1/T (RF)

    @staticmethod
    def pack(trees: List[_TreeArrays], max_depth: int, base_score: float,
             tree_scale: float) -> "TreeEnsemble":
        m = max(len(t.feature) for t in trees)
        T = len(trees)

        def pad(attr, fill, dtype):
            out = np.full((T, m), fill, dtype=dtype)
            for i, t in enumerate(trees):
                a = getattr(t, attr)
                out[i, : len(a)] = a
            return out

        return TreeEnsemble(
            feature=jnp.asarray(pad("feature", -1, np.int32)),
            threshold=jnp.asarray(pad("threshold", 0.0, np.float32)),
            left=jnp.asarray(pad("left", 0, np.int32)),
            right=jnp.asarray(pad("right", 0, np.int32)),
            value=jnp.asarray(pad("value", 0.0, np.float32)),
            cover=jnp.asarray(pad("cover", 0.0, np.float32)),
            max_depth=max_depth,
            base_score=base_score,
            tree_scale=tree_scale,
        )

    def raw_predict(self, x: jnp.ndarray) -> jnp.ndarray:
        """[N, d] → [N] margin. Depth-synchronous traversal, jit friendly."""
        return _ensemble_predict(
            self.feature, self.threshold, self.left, self.right, self.value,
            jnp.asarray(x, dtype=jnp.float32), self.max_depth,
            self.base_score, self.tree_scale,
        )


@functools.partial(jax.jit, static_argnums=(6,))
def _ensemble_predict(feature, threshold, left, right, value, x,
                      max_depth, base_score, tree_scale):
    T, M = feature.shape
    n = x.shape[0]
    node = jnp.zeros((n, T), dtype=jnp.int32)
    t_idx = jnp.arange(T)[None, :]

    def step(_, node):
        f = feature[t_idx, node]                 # [n, T]
        t = threshold[t_idx, node]
        is_leaf = f < 0
        xv = jnp.take_along_axis(x, jnp.maximum(f, 0), axis=1)  # [n, T]
        go_left = xv <= t
        nxt = jnp.where(go_left, left[t_idx, node], right[t_idx, node])
        return jnp.where(is_leaf, node, nxt)

    node = jax.lax.fori_loop(0, max_depth + 1, step, node)
    leaf_vals = value[t_idx, node]               # [n, T]
    return base_score + tree_scale * jnp.sum(leaf_vals, axis=1)


# ---------------------------------------------------------------------------
# sklearn-style estimators
# ---------------------------------------------------------------------------

class _BaseForest:
    def __init__(self, n_estimators=100, max_depth=6, learning_rate=0.1,
                 reg_lambda=1.0, min_child_weight=1.0, min_gain=1e-7,
                 subsample=1.0, colsample=1.0, oblivious=False, seed=0):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.reg_lambda = reg_lambda
        self.min_child_weight = min_child_weight
        self.min_gain = min_gain
        self.subsample = subsample
        self.colsample = colsample
        self.oblivious = oblivious
        self.seed = seed
        self.ensemble_: Optional[TreeEnsemble] = None
        self.mapper_: Optional[BinMapper] = None

    def _colsubset(self, rng, d: int) -> np.ndarray:
        k = max(1, int(round(self.colsample * d)))
        if k >= d:
            return np.arange(d)
        return np.sort(rng.choice(d, size=k, replace=False))

    def get_params(self, deep=True):
        return {
            k: getattr(self, k)
            for k in ("n_estimators", "max_depth", "learning_rate", "reg_lambda",
                      "min_child_weight", "min_gain", "subsample", "colsample",
                      "oblivious", "seed")
        }

    def set_params(self, **p):
        for k, v in p.items():
            setattr(self, k, v)
        return self


class GBDTRegressor(_BaseForest):
    """Gradient-boosted trees, squared loss — XGBoost/CatBoost/GB surrogate
    (reference: ...regression_opt_transformer_cnn_20250113.py:291-391)."""

    def fit(self, x, y) -> "GBDTRegressor":
        x = np.asarray(x, dtype=np.float32)
        y = np.asarray(y, dtype=np.float32)
        rng = np.random.default_rng(self.seed)
        self.mapper_ = BinMapper().fit(x)
        xb_full = self.mapper_.transform(x)
        base = float(y.mean())
        pred = np.full(len(y), base, dtype=np.float32)
        trees = []
        for _ in range(self.n_estimators):
            g = pred - y
            h = np.ones_like(y)
            rows = (
                rng.random(len(y)) < self.subsample
                if self.subsample < 1.0 else slice(None)
            )
            cols = self._colsubset(rng, x.shape[1])
            tree = _grow_tree(
                xb_full[rows][:, cols], g[rows], h[rows], self.mapper_, cols,
                self.max_depth, self.reg_lambda, self.min_child_weight,
                self.min_gain, self.oblivious,
            )
            trees.append(tree)
            pred += self.learning_rate * _numpy_tree_predict(tree, x)
        self._host_trees = trees
        self.ensemble_ = TreeEnsemble.pack(trees, self.max_depth, base,
                                           self.learning_rate)
        return self

    def predict(self, x) -> np.ndarray:
        return np.asarray(self.ensemble_.raw_predict(jnp.asarray(x, jnp.float32)))


class GBDTClassifier(_BaseForest):
    """Gradient-boosted trees, logistic loss — XGB/CatBoost classifier surrogate
    (reference: Models/model_opt_20250130.py:445-457)."""

    def fit(self, x, y) -> "GBDTClassifier":
        x = np.asarray(x, dtype=np.float32)
        y = np.asarray(y, dtype=np.float32)
        rng = np.random.default_rng(self.seed)
        self.mapper_ = BinMapper().fit(x)
        xb_full = self.mapper_.transform(x)
        p0 = float(np.clip(y.mean(), 1e-6, 1 - 1e-6))
        base = float(np.log(p0 / (1 - p0)))
        margin = np.full(len(y), base, dtype=np.float32)
        trees = []
        for _ in range(self.n_estimators):
            p = 1.0 / (1.0 + np.exp(-margin))
            g = p - y
            h = np.maximum(p * (1 - p), 1e-6)
            rows = (
                rng.random(len(y)) < self.subsample
                if self.subsample < 1.0 else slice(None)
            )
            cols = self._colsubset(rng, x.shape[1])
            tree = _grow_tree(
                xb_full[rows][:, cols], g[rows], h[rows], self.mapper_, cols,
                self.max_depth, self.reg_lambda, self.min_child_weight,
                self.min_gain, self.oblivious,
            )
            trees.append(tree)
            margin += self.learning_rate * _numpy_tree_predict(tree, x)
        self._host_trees = trees
        self.ensemble_ = TreeEnsemble.pack(trees, self.max_depth, base,
                                           self.learning_rate)
        return self

    def decision_function(self, x) -> np.ndarray:
        return np.asarray(self.ensemble_.raw_predict(jnp.asarray(x, jnp.float32)))

    def predict_proba(self, x) -> np.ndarray:
        p = 1.0 / (1.0 + np.exp(-self.decision_function(x)))
        return np.stack([1 - p, p], axis=1)

    def predict(self, x) -> np.ndarray:
        return (self.decision_function(x) > 0).astype(np.int32)


class RandomForestRegressor(_BaseForest):
    """Bagged variance-split trees (reference RF(300, depth 30):
    ...regression_opt_transformer_cnn_20250113.py:262-267)."""

    def __init__(self, n_estimators=100, max_depth=14, colsample=1.0,
                 min_child_weight=1.0, seed=0, **kw):
        super().__init__(n_estimators=n_estimators, max_depth=max_depth,
                         colsample=colsample, min_child_weight=min_child_weight,
                         reg_lambda=0.0, seed=seed, **kw)

    def fit(self, x, y) -> "RandomForestRegressor":
        x = np.asarray(x, dtype=np.float32)
        y = np.asarray(y, dtype=np.float32)
        rng = np.random.default_rng(self.seed)
        self.mapper_ = BinMapper().fit(x)
        xb_full = self.mapper_.transform(x)
        trees = []
        for _ in range(self.n_estimators):
            boot = rng.integers(0, len(y), size=len(y))
            cols = self._colsubset(rng, x.shape[1])
            # RF tree: fit y directly (g=-y, h=1 → leaf = mean y, variance gain)
            tree = _grow_tree(
                xb_full[boot][:, cols], -y[boot], np.ones(len(y), np.float32),
                self.mapper_, cols, self.max_depth, 1e-9,
                self.min_child_weight, self.min_gain, self.oblivious,
            )
            trees.append(tree)
        self._host_trees = trees
        self.ensemble_ = TreeEnsemble.pack(trees, self.max_depth, 0.0,
                                           1.0 / self.n_estimators)
        return self

    def predict(self, x) -> np.ndarray:
        return np.asarray(self.ensemble_.raw_predict(jnp.asarray(x, jnp.float32)))


class RandomForestClassifier(RandomForestRegressor):
    """RF on 0/1 targets: leaf value = class fraction → probability
    (variance split ≡ Gini for binary targets)."""

    def __init__(self, n_estimators=100, max_depth=14, colsample=0.5,
                 min_child_weight=1.0, seed=0, **kw):
        super().__init__(n_estimators=n_estimators, max_depth=max_depth,
                         colsample=colsample, min_child_weight=min_child_weight,
                         seed=seed, **kw)

    def predict_proba(self, x) -> np.ndarray:
        p = np.clip(super().predict(x), 0.0, 1.0)
        return np.stack([1 - p, p], axis=1)

    def predict(self, x) -> np.ndarray:
        return (super().predict(x) > 0.5).astype(np.int32)


def _numpy_tree_predict(tree: _TreeArrays, x: np.ndarray) -> np.ndarray:
    """Host-side single-tree traversal used inside the boosting loop."""
    n = len(x)
    node = np.zeros(n, dtype=np.int64)
    active = tree.feature[node] >= 0
    while active.any():
        f = tree.feature[node[active]]
        t = tree.threshold[node[active]]
        go_left = x[active, f] <= t
        node[active] = np.where(go_left, tree.left[node[active]],
                                tree.right[node[active]])
        active = tree.feature[node] >= 0
    return tree.value[node]
