"""Colorspace conversion ops — batched and fusable.

RGB↔YCbCr (BT.601 full-range, the JPEG/JFIF convention) as channel-planar
weighted sums that XLA fuses with neighbouring ops (and a 3x3 matmul on the
decode side); 4:2:0 chroma down/upsampling via reshape-mean / repeat.

Reference analog: the colorspace stage the reference delegates to
GStreamer's videoconvert in front of its encoders (hype/README.md pipeline);
here it is the first stage of the fused on-device encode path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ... import platform

# BT.601 full-range RGB -> YCbCr (JFIF)
_RGB2YCBCR = np.array(
    [[0.299, 0.587, 0.114],
     [-0.168735892, -0.331264108, 0.5],
     [0.5, -0.418687589, -0.081312411]], dtype=np.float32)
_YCBCR2RGB = np.linalg.inv(_RGB2YCBCR).astype(np.float32)
_CHROMA_OFFSET = np.array([0.0, 128.0, 128.0], dtype=np.float32)


def ycbcr_from_channels(r: jax.Array, g: jax.Array, b: jax.Array):
    """Three same-shaped RGB channel planes → (y, cb, cr) float32 planes.
    The planar core of rgb_to_ycbcr_planes; identical expression order, so
    the two entry points are bit-identical in f32."""
    r = r.astype(jnp.float32)
    g = g.astype(jnp.float32)
    b = b.astype(jnp.float32)
    m = _RGB2YCBCR
    y = m[0, 0] * r + m[0, 1] * g + m[0, 2] * b
    cb = m[1, 0] * r + m[1, 1] * g + m[1, 2] * b + 128.0
    cr = m[2, 0] * r + m[2, 1] * g + m[2, 2] * b + 128.0
    return y, cb, cr


def rgb_to_ycbcr_planes(rgb: jax.Array):
    """[..., H, W, 3] uint8/float RGB → (y, cb, cr) float32 planes.

    Channel-PLANAR linear combinations: three scalar-weighted plane sums
    fuse into one elementwise pass. Device-side pipelines carry channel
    planes end to end and use ycbcr_from_channels / planes_to_i420, so
    the interleaved [..., 3]-minor layout is never read on the device."""
    x = rgb.astype(jnp.float32)
    return ycbcr_from_channels(x[..., 0], x[..., 1], x[..., 2])


def rgb_to_ycbcr(rgb: jax.Array) -> jax.Array:
    """[..., H, W, 3] uint8/float RGB → float32 YCbCr (Y in [0,255],
    Cb/Cr centred at 128)."""
    y, cb, cr = rgb_to_ycbcr_planes(rgb)
    return jnp.stack([y, cb, cr], axis=-1)


def ycbcr_to_rgb(ycbcr: jax.Array) -> jax.Array:
    """[..., H, W, 3] float YCbCr → float32 RGB in [0,255] (unclipped)."""
    x = ycbcr.astype(jnp.float32) - jnp.asarray(_CHROMA_OFFSET)
    m = jnp.asarray(_YCBCR2RGB.T)
    return jnp.matmul(x, m, precision=platform.matmul_precision())


def subsample_420(plane: jax.Array) -> jax.Array:
    """[..., H, W] → [..., H/2, W/2] by 2x2 box mean (JPEG-style chroma
    subsampling). H and W must be even."""
    *lead, h, w = plane.shape
    x = plane.reshape(*lead, h // 2, 2, w // 2, 2)
    return x.mean(axis=(-3, -1))


def upsample_420(plane: jax.Array) -> jax.Array:
    """[..., H/2, W/2] → [..., H, W] by nearest-neighbour replication."""
    x = jnp.repeat(plane, 2, axis=-2)
    return jnp.repeat(x, 2, axis=-1)


def rgb_to_i420(rgb: jax.Array):
    """[..., H, W, 3] RGB → (Y [...,H,W], Cb [...,H/2,W/2], Cr) planes."""
    y, cb, cr = rgb_to_ycbcr_planes(rgb)
    return y, subsample_420(cb), subsample_420(cr)


def planes_to_i420(r: jax.Array, g: jax.Array, b: jax.Array):
    """Channel-planar variant of rgb_to_i420: (r, g, b) planes →
    (Y, Cb/2, Cr/2). Bit-identical to rgb_to_i420 on the stacked input,
    without ever touching the interleaved layout."""
    y, cb, cr = ycbcr_from_channels(r, g, b)
    return y, subsample_420(cb), subsample_420(cr)


def i420_to_rgb(y: jax.Array, cb: jax.Array, cr: jax.Array) -> jax.Array:
    """I420 planes → [..., H, W, 3] float RGB in [0,255] (unclipped)."""
    ycc = jnp.stack([y, upsample_420(cb), upsample_420(cr)], axis=-1)
    return ycbcr_to_rgb(ycc)


def scale_bilinear(img: jax.Array, out_h: int, out_w: int) -> jax.Array:
    """Bilinear resize of [..., H, W] or [..., H, W, C] (align_corners=False,
    half-pixel centres). Static output shape — jit/XLA friendly."""
    has_c = img.ndim >= 3 and img.shape[-1] <= 4
    x = img if has_c else img[..., None]
    *lead, h, w, c = x.shape
    x = x.reshape(-1, h, w, c)
    out = jax.image.resize(
        x.astype(jnp.float32),
        (x.shape[0], out_h, out_w, c), method="bilinear")
    out = out.reshape(*lead, out_h, out_w, c)
    return out if has_c else out[..., 0]
