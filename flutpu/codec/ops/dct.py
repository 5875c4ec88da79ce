"""8x8 block DCT ops — expressed as batched matmuls.

The 2-D DCT-II of an 8x8 block X is C @ X @ C^T with the orthonormal DCT
matrix C; batched over all blocks of all frames in a GOP as one einsum.
This replaces the per-block scalar DCT loops a CPU encoder (reference's
x264 delegate) would run. Every product runs at the platform's matmul
precision (flutpu.platform.matmul_precision).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ... import platform


@functools.lru_cache()
def dct_matrix(n: int = 8) -> np.ndarray:
    """Orthonormal DCT-II matrix: C[k, x] = s(k) cos((2x+1) k pi / 2n)."""
    k = np.arange(n)[:, None].astype(np.float64)
    x = np.arange(n)[None, :].astype(np.float64)
    c = np.cos((2 * x + 1) * k * np.pi / (2 * n))
    c *= np.sqrt(2.0 / n)
    c[0] *= np.sqrt(0.5)
    return c.astype(np.float32)


def blockize(plane: jax.Array, block: int = 8) -> jax.Array:
    """[..., H, W] → [..., H/block, W/block, block, block]."""
    *lead, h, w = plane.shape
    x = plane.reshape(*lead, h // block, block, w // block, block)
    return jnp.swapaxes(x, -3, -2)


def unblockize(blocks: jax.Array) -> jax.Array:
    """Inverse of blockize: [..., BH, BW, b, b] → [..., BH*b, BW*b]."""
    *lead, bh, bw, b, b2 = blocks.shape
    x = jnp.swapaxes(blocks, -3, -2)
    return x.reshape(*lead, bh * b, bw * b2)


def dct2(blocks: jax.Array) -> jax.Array:
    """2-D DCT-II over the trailing (8, 8) axes, any leading batch shape."""
    c = jnp.asarray(dct_matrix(blocks.shape[-1]))
    prec = platform.matmul_precision()
    # C @ X @ C^T — two batched matmuls
    y = jnp.einsum("ij,...jk->...ik", c, blocks.astype(jnp.float32),
                   precision=prec, preferred_element_type=jnp.float32)
    return jnp.einsum("...ik,jk->...ij", y, c,
                      precision=prec, preferred_element_type=jnp.float32)


def idct2(coefs: jax.Array) -> jax.Array:
    """Inverse 2-D DCT over trailing (8, 8) axes."""
    c = jnp.asarray(dct_matrix(coefs.shape[-1]))
    prec = platform.matmul_precision()
    y = jnp.einsum("ji,...jk->...ik", c, coefs.astype(jnp.float32),
                   precision=prec, preferred_element_type=jnp.float32)
    return jnp.einsum("...ik,kj->...ij", y, c,
                      precision=prec, preferred_element_type=jnp.float32)


def plane_dct(plane: jax.Array, block: int = 8) -> jax.Array:
    """Whole-plane blockized DCT: [..., H, W] → [..., H/8, W/8, 8, 8]."""
    return dct2(blockize(plane, block))


def plane_idct(coefs: jax.Array) -> jax.Array:
    """[..., BH, BW, 8, 8] coefficients → [..., H, W] plane."""
    return unblockize(idct2(coefs))


@functools.lru_cache()
def _bd_dct_matrix(dim: int) -> np.ndarray:
    """(dim, dim) block-diagonal matrix with the 8x8 DCT on the diagonal.

    One dense dim x dim matmul against the block-diagonal keeps data in
    plane layout (no (.., 8, 8) relayouts) at the cost of dim/8 times the
    FLOPs of dct2; the extra multiplies are zeros, exact under f32
    (x + 0 == x)."""
    c = dct_matrix(8)
    m = np.zeros((dim, dim), np.float32)
    for b in range(dim // 8):
        m[b * 8:(b + 1) * 8, b * 8:(b + 1) * 8] = c
    return m


def plane_dct_planar(plane: jax.Array) -> jax.Array:
    """[..., H, W] plane → [..., H, W] PLANE-LAYOUT DCT coefficients:
    block (by, bx)'s coefficient (u, v) sits at (8*by + u, 8*bx + v).
    Equals unblockize(plane_dct(plane)); see _bd_dct_matrix for why."""
    *_, h, w = plane.shape
    bh = jnp.asarray(_bd_dct_matrix(h))
    bw = jnp.asarray(_bd_dct_matrix(w))
    x = plane.astype(jnp.float32)
    prec = platform.matmul_precision()
    y = jnp.einsum("hk,...kw->...hw", bh, x, precision=prec,
                   preferred_element_type=jnp.float32)
    return jnp.einsum("...hw,vw->...hv", y, bw, precision=prec,
                      preferred_element_type=jnp.float32)


def plane_idct_planar(coefs: jax.Array) -> jax.Array:
    """Inverse of plane_dct_planar: plane-layout coefficients → plane."""
    *_, h, w = coefs.shape
    bh = jnp.asarray(_bd_dct_matrix(h))
    bw = jnp.asarray(_bd_dct_matrix(w))
    x = coefs.astype(jnp.float32)
    prec = platform.matmul_precision()
    y = jnp.einsum("kh,...kw->...hw", bh, x, precision=prec,
                   preferred_element_type=jnp.float32)
    return jnp.einsum("...hw,wv->...hv", y, bw, precision=prec,
                      preferred_element_type=jnp.float32)
