"""Multimodal Transformer+CNN regressor — the flagship model (family B6/B7).

Reference architecture (Models/multi_input_data_regression_opt_transformer_cnn_20250113.py:48-119):
- fingerprint → nn.TransformerEncoder(d_model=fp_size, nhead=max divisor ≤ fp/8,
  6 layers) applied to the fingerprint as a seq-len-1 token (:75-78,110-111)
- image 128×128×3 → CNN 3→32→64 (conv/pool ×2) → FC 128 (:84-94)
- MultiHeadAttentionFusion over concat(fp_fc 128, img_fc 128) (:48-65)
- head 256→256→128→64→1 (:98-107)

Redesign: attention over one token is identity-weighted
(softmax of a 1×1 score = 1), so each reference encoder layer degenerates to
``x + Wo(Wv x)`` followed by the feed-forward residual (SURVEY.md §5,
long-context note). We keep the same parameter shapes/capacity but implement
that algebra directly as dense residual blocks — plain matmuls with no
wasted softmax — and optionally expose ``fp_tokens > 1`` to chunk the
fingerprint into real tokens with genuine self-attention. bfloat16 compute,
f32 params/head.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax.numpy as jnp
from flax import linen as nn

from bbbp.models.fusion import (
    AttentionFusion,
    MultiHeadAttentionFusion,
    MultiModalAttentionFusion,
)


class DegenerateEncoderLayer(nn.Module):
    """Exact algebra of a torch TransformerEncoderLayer at seq_len=1:
    self-attention collapses to x + Wo·Wv·x (per-head probabilities are all 1),
    then LayerNorm, then FFN residual, then LayerNorm."""

    d_model: int
    d_ff: int
    dropout: float
    dtype: jnp.dtype

    @nn.compact
    def __call__(self, x, train: bool):
        v = nn.Dense(self.d_model, dtype=self.dtype, name="value")(x)
        o = nn.Dense(self.d_model, dtype=self.dtype, name="out")(v)
        o = nn.Dropout(self.dropout, deterministic=not train)(o)
        x = nn.LayerNorm(dtype=self.dtype)(x + o)
        f = nn.Dense(self.d_ff, dtype=self.dtype, name="ff1")(x)
        f = nn.relu(f)
        f = nn.Dropout(self.dropout, deterministic=not train)(f)
        f = nn.Dense(self.d_model, dtype=self.dtype, name="ff2")(f)
        return nn.LayerNorm(dtype=self.dtype)(x + f)


class TokenEncoderLayer(nn.Module):
    """Real self-attention layer for fp_tokens > 1 mode."""

    d_model: int
    n_heads: int
    d_ff: int
    dropout: float
    dtype: jnp.dtype

    @nn.compact
    def __call__(self, x, train: bool):
        a = nn.MultiHeadDotProductAttention(
            num_heads=self.n_heads, dtype=self.dtype,
            dropout_rate=self.dropout, deterministic=not train)(x, x)
        x = nn.LayerNorm(dtype=self.dtype)(x + a)
        f = nn.Dense(self.d_ff, dtype=self.dtype)(x)
        f = nn.relu(f)
        f = nn.Dense(self.d_model, dtype=self.dtype)(f)
        return nn.LayerNorm(dtype=self.dtype)(x + f)


class ImageCNN(nn.Module):
    """3→32→64 conv/pool stack → FC (reference :84-94), NHWC."""

    out_dim: int = 128
    dtype: jnp.dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, img, train: bool):
        x = img.astype(self.dtype)                       # [B, H, W, 3]
        x = nn.Conv(32, (3, 3), padding="SAME", dtype=self.dtype)(x)
        x = nn.relu(x)
        x = nn.max_pool(x, (2, 2), strides=(2, 2))
        x = nn.Conv(64, (3, 3), padding="SAME", dtype=self.dtype)(x)
        x = nn.relu(x)
        x = nn.max_pool(x, (2, 2), strides=(2, 2))
        x = x.reshape((x.shape[0], -1))
        x = nn.Dense(self.out_dim, dtype=self.dtype)(x)
        return nn.relu(x)


class MultiModalRegressor(nn.Module):
    """Flagship multimodal model with selectable fusion
    ('multihead' B6 | 'gate' B10 | 'crossmodal' B11)."""

    fp_dim: int = 167
    n_layers: int = 6
    fp_tokens: int = 1          # 1 = faithful degenerate mode; >1 = real attention
    max_fp_width: int = 512     # project wider fingerprints (e.g. Morgan 2048)
                                # down before the encoder stack — the reference
                                # trains d_model=2048 encoders one fold at a
                                # time; with all folds batched that's ~30 GB of
                                # parameters+optimizer state, so we bound width
    d_ff_mult: int = 4
    emb_dim: int = 128
    fusion: str = "multihead"
    head_dims: Sequence[int] = (256, 128, 64)
    dropout: float = 0.1
    dtype: jnp.dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, fp, img, train: bool = False):
        fp = fp.astype(self.dtype)
        if self.fp_tokens <= 1:
            x = fp
            d_model = self.fp_dim
            if d_model > self.max_fp_width:
                d_model = self.max_fp_width
                x = nn.Dense(d_model, dtype=self.dtype, name="fp_in_proj")(x)
            for i in range(self.n_layers):
                x = DegenerateEncoderLayer(
                    d_model=d_model, d_ff=self.d_ff_mult * d_model,
                    dropout=self.dropout, dtype=self.dtype, name=f"enc{i}")(x, train)
        else:
            # chunk fingerprint into tokens (pad to multiple)
            t = self.fp_tokens
            d_tok = -(-self.fp_dim // t)
            pad = t * d_tok - self.fp_dim
            xt = jnp.pad(fp, ((0, 0), (0, pad))).reshape(fp.shape[0], t, d_tok)
            d_model = max(64, d_tok)
            xt = nn.Dense(d_model, dtype=self.dtype, name="tok_proj")(xt)
            pos = self.param("pos_emb", nn.initializers.normal(0.02),
                             (1, t, d_model), jnp.float32)
            xt = xt + pos.astype(self.dtype)
            for i in range(self.n_layers):
                xt = TokenEncoderLayer(
                    d_model=d_model, n_heads=max(1, d_model // 32),
                    d_ff=self.d_ff_mult * d_model, dropout=self.dropout,
                    dtype=self.dtype, name=f"enc{i}")(xt, train)
            x = xt.mean(axis=1)
        fp_emb = nn.Dense(self.emb_dim, dtype=self.dtype, name="fp_fc")(x)
        fp_emb = nn.relu(fp_emb)

        if img.ndim == 2:  # flattened 128*128*3 input, reference layout
            side = int(round((img.shape[-1] // 3) ** 0.5))
            img = img.reshape(img.shape[0], side, side, 3)
        img_emb = ImageCNN(self.emb_dim, dtype=self.dtype, name="cnn")(img, train)

        if self.fusion == "multihead":
            fused = MultiHeadAttentionFusion(out_dim=2 * self.emb_dim,
                                             dtype=self.dtype)(fp_emb, img_emb)
        elif self.fusion == "gate":
            fused = AttentionFusion(dtype=self.dtype)(fp_emb, img_emb)
        elif self.fusion == "crossmodal":
            fused = MultiModalAttentionFusion(dtype=self.dtype)(fp_emb, img_emb)
        else:
            raise ValueError(f"unknown fusion {self.fusion!r}")

        h = fused
        for d in self.head_dims:
            h = nn.Dense(d, dtype=self.dtype)(h)
            h = nn.relu(h)
            h = nn.Dropout(self.dropout, deterministic=not train)(h)
        out = nn.Dense(1, dtype=jnp.float32)(h.astype(jnp.float32))
        return out[..., 0]
