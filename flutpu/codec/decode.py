"""Decode path: entropy scan → coefficients (host C++) → pixels (device).

The mirror of the encode path: the native scan decoder
(flu_jpeg_decode_scan) recovers zigzagged quantized coefficients, and a
jitted device program performs de-zigzag → dequantize → IDCT → 4:2:0
upsample → RGB. Serves the FVC decoder element and self-verification
without external decoders.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import native, platform
from . import jpeg_tables as T
from .ops.colorspace import i420_to_rgb, ycbcr_to_rgb
from .ops.dct import plane_idct
from .ops.quant import dequantize, zigzag_unflatten


def decode_scan_to_coefs(scan: bytes, ybw: int, ybh: int, cbw: int, cbh: int,
                         subsample: bool, destuff: bool = True
                         ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Entropy scan → (y, cb, cr) zigzagged int16 blocks (absolute DC).
    Returns None when the native library is unavailable or the stream is
    corrupt."""
    lib = native.get_lib()
    if lib is None:
        return None
    c = ctypes
    y = np.zeros((ybh, ybw, 64), np.int16)
    cb = np.zeros((cbh, cbw, 64), np.int16)
    cr = np.zeros((cbh, cbw, 64), np.int16)
    buf = np.frombuffer(scan, dtype=np.uint8)

    def u8p(a):
        return a.ctypes.data_as(c.POINTER(c.c_uint8))

    def i16p(a):
        return a.ctypes.data_as(c.POINTER(c.c_int16))

    def tab(bits, vals):
        b = np.asarray(bits, np.uint8)
        v = np.asarray(vals, np.uint8)
        return b, v

    dclb, dclv = tab(T.DC_LUMA_BITS, T.DC_LUMA_VALS)
    aclb, aclv = tab(T.AC_LUMA_BITS, T.AC_LUMA_VALS)
    dccb, dccv = tab(T.DC_CHROMA_BITS, T.DC_CHROMA_VALS)
    accb, accv = tab(T.AC_CHROMA_BITS, T.AC_CHROMA_VALS)
    rc = lib.flu_jpeg_decode_scan(
        u8p(buf), len(scan), 1 if destuff else 0,
        i16p(y), ybw, ybh, i16p(cb), i16p(cr), cbw, cbh,
        1 if subsample else 0, 3,
        u8p(dclb), u8p(dclv), len(dclv), u8p(aclb), u8p(aclv), len(aclv),
        u8p(dccb), u8p(dccv), len(dccv), u8p(accb), u8p(accv), len(accv))
    if rc != 0:
        return None
    return y, cb, cr


@functools.partial(jax.jit, static_argnames=("h", "w", "subsample"))
def coefs_to_rgb(yq: jax.Array, cbq: jax.Array, crq: jax.Array,
                 qy: jax.Array, qc: jax.Array, h: int, w: int,
                 subsample: bool = True) -> jax.Array:
    """Quantized zigzag coefficient planes → (h, w, 3) uint8 RGB (device)."""
    def plane(q, qtab):
        if not platform.dct_planar():
            blocks = zigzag_unflatten(q.astype(jnp.float32))
            return plane_idct(dequantize(blocks, qtab)) + 128.0
        # planar idct (see dct.plane_dct_planar)
        from .ops.dct import plane_idct_planar, unblockize
        from .ops.quant import dequantize_planar
        cp = unblockize(zigzag_unflatten(q.astype(jnp.int32)))
        return plane_idct_planar(dequantize_planar(cp, qtab)) + 128.0

    y = plane(yq, qy)
    cb = plane(cbq, qc)
    cr = plane(crq, qc)
    if subsample:
        rgb = i420_to_rgb(y, cb, cr)
    else:
        rgb = ycbcr_to_rgb(jnp.stack([y, cb, cr], axis=-1))
    return jnp.clip(rgb + 0.5, 0, 255).astype(jnp.uint8)[:h, :w]
