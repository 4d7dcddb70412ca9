"""Tanimoto similarity as matmuls: bit-set intersections as matmuls.

The reference has no similarity search; its kNN legs use Euclidean distance
on scaled features (Models/model_opt_20250130.py:413-457 KNeighbors*). For
binary fingerprints the chemistry-standard metric is Tanimoto
|A∩B| / |A∪B|; on the device the [Nq, Nr] intersection matrix is ONE matmul of the
0/1 fingerprint matrices (popcounts are row sums), so the whole
neighbor search runs as matmuls with a single lax.top_k at the end.
Used as the regression stack's similarity leg and available for screening
nearest-neighbor lookups.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("k",))
def tanimoto_topk(q: jnp.ndarray, r: jnp.ndarray, k: int):
    """(similarities [Nq, k], indices [Nq, k]) of the k most similar
    reference rows per query. q, r are 0/1 float32 [N, d] matrices."""
    inter = q @ r.T                                    # [Nq, Nr]
    pop_q = q.sum(axis=1, keepdims=True)
    pop_r = r.sum(axis=1)[None, :]
    union = pop_q + pop_r - inter
    sim = inter / jnp.maximum(union, 1e-9)
    return jax.lax.top_k(sim, k)


class TanimotoKNNRegressor:
    """Similarity-weighted k-nearest-neighbor regression over binary
    fingerprints: pred = Σ sim_i·y_i / Σ sim_i over the top-k Tanimoto
    neighbors. sklearn-style fit/predict."""

    def __init__(self, n_neighbors: int = 10, power: float = 2.0):
        self.n_neighbors = n_neighbors
        self.power = power              # sim^power sharpens the weighting
        self._x: Optional[jnp.ndarray] = None
        self._y: Optional[jnp.ndarray] = None

    def fit(self, x, y) -> "TanimotoKNNRegressor":
        self._x = jnp.asarray((np.asarray(x) > 0), jnp.float32)
        self._y = jnp.asarray(y, jnp.float32)
        return self

    def predict(self, x) -> np.ndarray:
        q = jnp.asarray((np.asarray(x) > 0), jnp.float32)
        k = min(self.n_neighbors, self._x.shape[0])
        sim, idx = tanimoto_topk(q, self._x, k)
        w = jnp.maximum(sim, 1e-6) ** self.power
        return np.asarray((w * self._y[idx]).sum(1) / w.sum(1))


@jax.jit
def tanimoto_matrix(q: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """Full [Nq, Nr] Tanimoto similarity matrix (one matmul)."""
    inter = q @ r.T
    union = q.sum(1, keepdims=True) + r.sum(1)[None, :] - inter
    return inter / jnp.maximum(union, 1e-9)


class TanimotoKernelRidge:
    """Kernel ridge regression with the Tanimoto kernel (a valid PSD kernel
    on bit sets — Gower/Tanimoto). Unlike the top-k kNN leg this uses the
    FULL similarity structure: alpha = (K + lam*I)^-1 (y - mean),
    pred = K(q, X) @ alpha + mean. On the device the gram matrix is one bit-matmul
    and the solve is a tiny Cholesky — N is ~1k in the B3DB regression set."""

    def __init__(self, lam: float = 0.1):
        self.lam = lam
        self._x = None
        self._alpha = None
        self._mean = 0.0

    def fit(self, x, y) -> "TanimotoKernelRidge":
        self._x = jnp.asarray((np.asarray(x) > 0), jnp.float32)
        y = jnp.asarray(y, jnp.float32)
        self._mean = float(y.mean())
        k = tanimoto_matrix(self._x, self._x)
        n = k.shape[0]
        self._alpha = jax.scipy.linalg.solve(
            k + self.lam * jnp.eye(n, dtype=k.dtype), y - self._mean,
            assume_a="pos")
        return self

    def predict(self, x) -> np.ndarray:
        q = jnp.asarray((np.asarray(x) > 0), jnp.float32)
        return np.asarray(tanimoto_matrix(q, self._x) @ self._alpha
                          + self._mean)

    @staticmethod
    def full_gram(x) -> np.ndarray:
        """Label-independent full N x N Tanimoto gram (one device bit-matmul).
        Lets a caller run arbitrarily fine CV (50-fold ~ LOO) as cheap host
        sub-matrix solves instead of N gram recomputations."""
        b = jnp.asarray((np.asarray(x) > 0), jnp.float32)
        return np.asarray(tanimoto_matrix(b, b))


@functools.partial(jax.jit, static_argnames=("levels",))
def minmax_matrix(qc: jnp.ndarray, rc: jnp.ndarray,
                  levels: int = 16) -> jnp.ndarray:
    """Min-max (generalized Tanimoto) kernel for COUNT fingerprints:
    K = Σ_k min(a_k,b_k) / Σ_k max(a_k,b_k). There is no matmul identity for
    pairwise min directly, but for small integer counts clipped at L,
    Σ_k min(a_k,b_k) = Σ_{t=1..L} (a≥t)·(b≥t)ᵀ — a sum of L bit matmuls, so
    the whole kernel stays one matmul (L=16 covers Morgan counts; higher
    counts are clipped consistently on both sides)."""
    qc = jnp.minimum(qc, levels)
    rc = jnp.minimum(rc, levels)
    inter = jnp.zeros((qc.shape[0], rc.shape[0]), jnp.float32)
    for t in range(1, levels + 1):
        qa = (qc >= t).astype(jnp.float32)
        rb = (rc >= t).astype(jnp.float32)
        inter = inter + qa @ rb.T
    union = qc.sum(1, keepdims=True) + rc.sum(1)[None, :] - inter
    return inter / jnp.maximum(union, 1e-9)


@jax.jit
def tanimoto_matrix_w(q: jnp.ndarray, r: jnp.ndarray,
                      w: jnp.ndarray) -> jnp.ndarray:
    """Per-bit-weighted Tanimoto on binary matrices:
    K = Σ w_i a_i b_i / (Σ w_i a_i + Σ w_i b_i − Σ w_i a_i b_i).
    Still one matmul — the weight folds into the left operand; with
    w = log(N/df) this is the IDF-weighted kernel (rare substructures count
    more), measured +0.0014 crossfit R² over the unweighted combined kernel
    (scripts/estimate_round3b.py lever 2)."""
    qw = q * w[None, :]
    inter = qw @ r.T
    union = qw.sum(1, keepdims=True) + (r * w[None, :]).sum(1)[None, :] - inter
    return inter / jnp.maximum(union, 1e-9)


@functools.partial(jax.jit, static_argnames=("levels",))
def minmax_matrix_w(qc: jnp.ndarray, rc: jnp.ndarray, w: jnp.ndarray,
                    levels: int = 16) -> jnp.ndarray:
    """Per-bit-weighted min-max kernel on count vectors:
    K = Σ w_i min(a_i,b_i) / Σ w_i max(a_i,b_i). The level decomposition of
    minmax_matrix carries the weight through each bit-matmul (min/max are
    1-homogeneous in the per-level indicators)."""
    qc = jnp.minimum(qc, levels)
    rc = jnp.minimum(rc, levels)
    inter = jnp.zeros((qc.shape[0], rc.shape[0]), jnp.float32)
    for t in range(1, levels + 1):
        qa = (qc >= t).astype(jnp.float32) * w[None, :]
        rb = (rc >= t).astype(jnp.float32)
        inter = inter + qa @ rb.T
    union = ((qc * w[None, :]).sum(1, keepdims=True)
             + (rc * w[None, :]).sum(1)[None, :] - inter)
    return inter / jnp.maximum(union, 1e-9)


@jax.jit
def rbf_matrix(qd: jnp.ndarray, rd: jnp.ndarray,
               gamma: jnp.ndarray) -> jnp.ndarray:
    """RBF kernel on dense descriptor vectors (pairwise distances via the
    norm + cross-matmul identity)."""
    d2 = ((qd ** 2).sum(1, keepdims=True) + (rd ** 2).sum(1)[None, :]
          - 2.0 * qd @ rd.T)
    return jnp.exp(-gamma * jnp.maximum(d2, 0.0))


class ChemKernelRidge:
    """Kernel ridge over a weighted COMBINATION of chemistry kernels:
    w0·Tanimoto(MACCS bits) + w1·Tanimoto(Morgan bits) +
    w2·minmax(Morgan counts) + w3·RBF(physchem descriptors).

    Each term is PSD so the combination is a valid kernel; the mix sees
    substructure presence, substructure multiplicity, and global physchem
    geometry at once. CPU estimates on the honest B3DB protocol: combined
    R²≈0.63 OOF vs 0.58 for the best single kernel — competitive with the
    forest legs while decorrelated from them (different inductive bias).

    Everything is matmuls (see minmax_matrix for the count-kernel
    decomposition) plus one small Cholesky. The descriptor block is
    standardized on the FIT rows only and the RBF bandwidth is the median
    train pairwise distance — per-fold fits are leak-free by construction."""

    def __init__(self, lam: float = 0.06,
                 weights=(0.15, 0.2, 0.45, 0.2), levels: int = 16,
                 bit_weights=None):
        self.lam = lam
        self.weights = weights
        self.levels = levels
        # optional per-bit weights (w_maccs, w_bits, w_counts) for the three
        # fingerprint blocks — e.g. idf_weights() for IDF-weighted kernels
        self.bit_weights = bit_weights

    @staticmethod
    def idf_weights(maccs, counts) -> tuple:
        """IDF per-bit weights log(N / df) from the (label-independent)
        document frequency of each substructure bit over the given rows —
        valid to compute globally under the honest protocol for the same
        reason full_gram is. Returns (w_maccs, w_bits, w_counts) with
        w_counts sharing the binary-bits weights."""
        mk = (np.asarray(maccs) > 0).astype(np.float64)
        bt = (np.asarray(counts) > 0).astype(np.float64)
        n = float(len(mk))
        w_keys = np.log(n / np.maximum(mk.sum(0), 1.0)).astype(np.float32)
        w_bits = np.log(n / np.maximum(bt.sum(0), 1.0)).astype(np.float32)
        return (w_keys, w_bits, w_bits)

    def _kernel(self, q, r):
        qm, qb, qc, qd = q
        rm, rb, rc, rd = r
        w = self.weights
        bw = self.bit_weights or (None, None, None)
        k = jnp.zeros((qm.shape[0], rm.shape[0]), jnp.float32)
        if w[0]:
            k = k + w[0] * (tanimoto_matrix(qm, rm) if bw[0] is None else
                            tanimoto_matrix_w(qm, rm, jnp.asarray(bw[0])))
        if w[1]:
            k = k + w[1] * (tanimoto_matrix(qb, rb) if bw[1] is None else
                            tanimoto_matrix_w(qb, rb, jnp.asarray(bw[1])))
        if w[2]:
            k = k + w[2] * (minmax_matrix(qc, rc, self.levels)
                            if bw[2] is None else
                            minmax_matrix_w(qc, rc, jnp.asarray(bw[2]),
                                            self.levels))
        if w[3]:
            k = k + w[3] * rbf_matrix(qd, rd, self._gamma)
        return k

    def _blocks(self, maccs, counts, desc):
        return (jnp.asarray(np.asarray(maccs) > 0, jnp.float32),
                jnp.asarray(np.asarray(counts) > 0, jnp.float32),
                jnp.asarray(counts, jnp.float32),
                jnp.asarray((np.asarray(desc) - self._mu) * self._inv,
                            jnp.float32))

    def fit(self, maccs, counts, desc, y) -> "ChemKernelRidge":
        desc = np.asarray(desc, np.float32)
        self._mu = desc.mean(0)
        sd = desc.std(0)
        self._inv = (1.0 / np.where(sd < 1e-12, 1.0, sd)).astype(np.float32)
        self._train = self._blocks(maccs, counts, desc)
        if self.weights[3]:
            d = np.asarray(self._train[3])
            d2 = ((d[:, None, :] - d[None, :, :]) ** 2).sum(-1) \
                if len(d) <= 512 else None
            if d2 is None:
                # matmul identity for larger N (device-side)
                dd = self._train[3]
                d2 = np.asarray((dd ** 2).sum(1)[:, None]
                                + (dd ** 2).sum(1)[None, :]
                                - 2.0 * np.asarray(dd @ dd.T))
            self._gamma = jnp.float32(1.0 / (2.0 * max(np.median(d2), 1e-6)))
        else:
            self._gamma = jnp.float32(1.0)
        y = jnp.asarray(y, jnp.float32)
        self._mean = float(y.mean())
        k = self._kernel(self._train, self._train)
        n = k.shape[0]
        self._alpha = jax.scipy.linalg.solve(
            k + self.lam * jnp.eye(n, dtype=k.dtype), y - self._mean,
            assume_a="pos")
        return self

    def predict(self, maccs, counts, desc) -> np.ndarray:
        q = self._blocks(maccs, counts, desc)
        return np.asarray(self._kernel(q, self._train) @ self._alpha
                          + self._mean)

    def full_gram(self, maccs, counts, desc) -> np.ndarray:
        """Label-independent full N x N combined-kernel gram. Descriptor
        standardization and the RBF bandwidth are fit on ALL rows — valid
        under the honest protocol (unsupervised transforms are global) and
        it makes fine-grained CV (kernel_n_folds in train.regression) cost
        only host sub-matrix solves."""
        desc = np.asarray(desc, np.float32)
        self._mu = desc.mean(0)
        sd = desc.std(0)
        self._inv = (1.0 / np.where(sd < 1e-12, 1.0, sd)).astype(np.float32)
        blocks = self._blocks(maccs, counts, desc)
        if self.weights[3]:
            d = np.asarray(blocks[3])
            sq = (d ** 2).sum(1)
            d2 = sq[:, None] + sq[None, :] - 2.0 * np.asarray(d @ d.T)
            self._gamma = jnp.float32(1.0 / (2.0 * max(np.median(d2), 1e-6)))
        else:
            self._gamma = jnp.float32(1.0)
        return np.asarray(self._kernel(blocks, blocks))


class TanimotoKNNClassifier(TanimotoKNNRegressor):
    def fit(self, x, y):
        return super().fit(x, np.asarray(y, np.float32))

    def predict_proba(self, x) -> np.ndarray:
        p = np.clip(super().predict(x), 0.0, 1.0)
        return np.stack([1 - p, p], axis=1)

    def predict(self, x) -> np.ndarray:
        return (super().predict(x) > 0.5).astype(np.int32)
