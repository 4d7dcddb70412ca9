"""Packed-bit fingerprint ops: 32× smaller host→device transfers.

The screening path ships fingerprints host→device each chunk; dense f32
2048-bit vectors are 8 KB/molecule. Packed uint32 words are 256 B/molecule —
the unpack happens on the device, in the same jitted program as the
scaler+PCA projection (algebra: for x ∈ {0,1},
z = ((x−μ)/σ − μ_p)·C = x·C′ + c0 with C′ = C/σ, c0 = −(μ/σ + μ_p)·C —
one matmul over unpacked bits plus a constant).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def pack_bits(dense: np.ndarray) -> np.ndarray:
    """[N, n_bits] {0,1} float/int → [N, n_bits/32] uint32 (little-endian bits)."""
    n, d = dense.shape
    assert d % 32 == 0, "bit width must be a multiple of 32"
    b = (np.asarray(dense) > 0.5).astype(np.uint8)
    # little-bit-order pack into uint32 words
    packed = np.packbits(b.reshape(n, d // 8, 8)[:, :, ::-1], axis=-1)
    return np.ascontiguousarray(packed.reshape(n, d // 8)).view(np.uint32)


def unpack_bits_jnp(packed: jnp.ndarray, n_bits: int) -> jnp.ndarray:
    """[N, W] uint32 → [N, n_bits] f32 (numerical reference)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (packed[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    return bits.reshape(packed.shape[0], -1)[:, :n_bits].astype(jnp.float32)


def project_weights(scaler_mean: np.ndarray, scaler_scale: np.ndarray,
                    pca_mean: np.ndarray, pca_components: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Fold scaler+PCA into (W' [d, k], c0 [k]) for binary inputs."""
    c = pca_components.T                               # [d, k]
    w = c / scaler_scale[:, None]
    c0 = -((scaler_mean / scaler_scale + pca_mean) @ c)
    return w.astype(np.float32), c0.astype(np.float32)


@jax.jit
def packed_project(packed: jnp.ndarray, w: jnp.ndarray,
                   c0: jnp.ndarray) -> jnp.ndarray:
    """[N, W] uint32 packed bits → [N, k] projected features.

    Plain jnp: XLA fuses the unpack into the producer of the matmul operand.
    ``HIGHEST`` keeps the f32 product out of TF32, whose ~1e-3 relative
    rounding of the folded weights would move PCA scores across tree
    thresholds and make the screen irreproducible across devices."""
    x = unpack_bits_jnp(packed, w.shape[0])
    return jnp.matmul(x, w, precision=jax.lax.Precision.HIGHEST) + c0
