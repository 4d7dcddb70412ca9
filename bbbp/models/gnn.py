"""Graph convolutional regressor/classifier over bbbp.chem.graph_features.

Beyond-parity model family: the reference's GPU featurizer (F3,
Descriptors/create_descriptors_gpu.py) produces DeepChem ConvMol atom features
but never trains a graph model on them; here a GCN consumes this framework's
equivalent featurization. Dense batched message passing — Â H W with
symmetric-normalized adjacency — maps straight onto matmuls (adjacency is a
[A, A] matmul per molecule), masked mean pooling, MLP head. Static shapes
(padded atoms) keep it jit/vmap/mesh friendly.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
from flax import linen as nn


class GCNLayer(nn.Module):
    dim: int
    dtype: jnp.dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, h, adj_norm):
        # h: [B, A, F]; adj_norm: [B, A, A] (D^-1/2 (A+I) D^-1/2)
        m = jnp.einsum("bij,bjf->bif", adj_norm.astype(self.dtype),
                       h.astype(self.dtype))
        m = nn.Dense(self.dim, dtype=self.dtype)(m)
        return nn.relu(m)


class MPNNRegressor(nn.Module):
    """Edge-conditioned message passing: per-bond-type dense transforms
    (messages for single/double/triple/aromatic bonds use separate weights),
    residual + LayerNorm updates, masked mean+max readout. Everything is a
    batched matmul over padded static shapes — one einsum per bond type per
    layer as matmuls. The stronger graph leg for the regression stack
    (GCNRegressor remains the plain-GCN variant)."""

    hidden: int = 128
    n_layers: int = 4
    head: Sequence[int] = (128, 64)
    n_out: int = 1
    dropout: float = 0.1
    dtype: jnp.dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, feats, adj_t, mask, train: bool = False):
        # adj_t: [B, T, A, A] bond-type adjacencies (no self loops)
        n_types = adj_t.shape[1]
        m3 = mask[:, :, None].astype(self.dtype)
        deg = jnp.maximum(adj_t.sum((1, 3)), 1.0)              # [B, A]
        dinv = (1.0 / deg)[:, None, :, None].astype(self.dtype)
        adj_n = adj_t.astype(self.dtype) * dinv                # row-normalized
        h = nn.Dense(self.hidden, dtype=self.dtype)(feats.astype(self.dtype))
        h = h * m3
        for _ in range(self.n_layers):
            msgs = 0.0
            for t in range(n_types):
                ht = nn.Dense(self.hidden, dtype=self.dtype)(h)
                msgs = msgs + jnp.einsum("bij,bjf->bif", adj_n[:, t], ht)
            self_h = nn.Dense(self.hidden, dtype=self.dtype)(h)
            upd = nn.relu(self_h + msgs)
            upd = nn.Dropout(self.dropout, deterministic=not train)(upd)
            h = nn.LayerNorm(dtype=self.dtype)(h + upd) * m3
        denom = jnp.maximum(mask.sum(1, keepdims=True), 1.0).astype(self.dtype)
        mean_pool = h.sum(1) / denom
        neg = (1.0 - m3) * jnp.asarray(-1e4, self.dtype)
        max_pool = (h + neg).max(1)
        x = jnp.concatenate([mean_pool, max_pool], axis=-1)
        for d in self.head:
            x = nn.Dense(d, dtype=self.dtype)(x)
            x = nn.relu(x)
            x = nn.Dropout(self.dropout, deterministic=not train)(x)
        out = nn.Dense(self.n_out, dtype=jnp.float32)(x.astype(jnp.float32))
        return out[..., 0] if self.n_out == 1 else out


class GCNRegressor(nn.Module):
    hidden: Sequence[int] = (128, 128, 128)
    head: Sequence[int] = (128, 64)
    n_out: int = 1
    dropout: float = 0.1
    dtype: jnp.dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, feats, adj, mask, train: bool = False):
        # symmetric normalization (adjacency already carries self-loops)
        deg = jnp.maximum(adj.sum(-1), 1e-6)
        dinv = jax.lax.rsqrt(deg)
        adj_norm = adj * dinv[:, :, None] * dinv[:, None, :]
        h = feats
        for d in self.hidden:
            h = GCNLayer(d, dtype=self.dtype)(h, adj_norm)
            h = h * mask[:, :, None].astype(self.dtype)
        # masked mean pool
        pooled = h.sum(1) / jnp.maximum(mask.sum(1, keepdims=True), 1.0).astype(self.dtype)
        x = pooled
        for d in self.head:
            x = nn.Dense(d, dtype=self.dtype)(x)
            x = nn.relu(x)
            x = nn.Dropout(self.dropout, deterministic=not train)(x)
        out = nn.Dense(self.n_out, dtype=jnp.float32)(x.astype(jnp.float32))
        return out[..., 0] if self.n_out == 1 else out
