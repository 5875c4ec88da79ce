"""Device instance compositor — renders a TTML interval from a z-ordered
instance stream against the glyph atlas, entirely on the accelerator.

Device-first replacement for the reference's per-glyph cairo drawing loop
(plugins/ttml/gstttmlrender.c show_layout :941-1176 and show_regions
:1235-1385): instead of host-side pixel blending, the host emits a compact
instance table (tile index, destination, size, color, clip rect) and one
jitted program source-over-blends every instance into the window in order.

Shape discipline (XLA: traced once, static shapes):
  - atlas tiles are fixed (TILE_H, TILE_W); big runs arrive pre-split
  - the instance count is padded to the next power of two with no-op
    instances (alpha 0), so programs are reused across intervals
  - per-instance placement uses dynamic_slice + dynamic_update_slice on
    the f32 window carry — dynamic *starts*, static *sizes*

Instance encoding:
  ints  (N, 9) int32: tile, x, y, w, h, clip_x0, clip_y0, clip_x1, clip_y1
        (x/y may be negative: the slice start is clamped and the clip rect
        carries the true geometry)
  cols  (N, 4) float32: r, g, b, effective_alpha (style alpha × region
        opacity), 0..1
Clip rects implement region overflow semantics: hidden clips to the region
box, visible clips to the window (reference overflow switch :1235-1385).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np

from .atlas import TILE_H, TILE_W


def _composite_core(atlas, ints, cols, window_h: int, window_w: int,
                    imgatlas=None):
    """Blend N instances into a transparent (window_h, window_w, 4) BGRA
    frame. atlas: (T, TILE_H, TILE_W) uint8. ``imgatlas`` (M, TILE_H,
    TILE_W, 4) uint8 serves instances with NEGATIVE tile ids (-idx-1):
    per-pixel-color RGBA tiles (SMPTE background images); absent, the
    image arm is not traced at all. See module doc for encoding."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    n = ints.shape[0]
    # working window padded by a tile on every side so clamped
    # dynamic_update_slice windows never wrap or clip content reads
    ph, pw = window_h + 2 * TILE_H, window_w + 2 * TILE_W
    frame = jnp.zeros((ph, pw, 4), jnp.float32)

    yy = lax.broadcasted_iota(jnp.int32, (TILE_H, TILE_W), 0)
    xx = lax.broadcasted_iota(jnp.int32, (TILE_H, TILE_W), 1)

    def blend(i, frame):
        tile_idx = ints[i, 0]
        x = ints[i, 1] + TILE_W  # into padded coords
        y = ints[i, 2] + TILE_H
        w, h = ints[i, 3], ints[i, 4]
        cx0 = ints[i, 5] + TILE_W
        cy0 = ints[i, 6] + TILE_H
        cx1 = ints[i, 7] + TILE_W
        cy1 = ints[i, 8] + TILE_H
        if imgatlas is None:
            tile = lax.dynamic_slice(
                atlas, (tile_idx, 0, 0), (1, TILE_H, TILE_W))[0]
            alpha = tile.astype(jnp.float32) / 255.0
            src_rgb = cols[i, :3]
        else:
            is_img = tile_idx < 0
            a_idx = jnp.where(is_img, 0, tile_idx)
            i_idx = jnp.where(is_img, -tile_idx - 1, 0)
            tile = lax.dynamic_slice(
                atlas, (a_idx, 0, 0), (1, TILE_H, TILE_W))[0]
            img = lax.dynamic_slice(
                imgatlas, (i_idx, 0, 0, 0), (1, TILE_H, TILE_W, 4))[0]
            alpha = jnp.where(is_img, img[..., 3], tile) \
                .astype(jnp.float32) / 255.0
            src_rgb = jnp.where(is_img, img[..., :3].astype(jnp.float32)
                                / 255.0, cols[i, :3])
        # valid-extent mask + clip-rect mask in window coordinates
        gx = xx + x
        gy = yy + y
        mask = ((xx < w) & (yy < h) &
                (gx >= cx0) & (gx < cx1) & (gy >= cy0) & (gy < cy1))
        sa = alpha * cols[i, 3]
        sa = jnp.where(mask, sa, 0.0)[..., None]
        dst = lax.dynamic_slice(frame, (y, x, 0), (TILE_H, TILE_W, 4))
        da = dst[..., 3:]
        out_a = sa + da * (1 - sa)
        rgb = (src_rgb * sa + dst[..., :3] * da * (1 - sa)) \
            / jnp.maximum(out_a, 1e-6)
        new = jnp.concatenate([rgb, out_a], axis=-1)
        return lax.dynamic_update_slice(frame, new, (y, x, 0))

    frame = lax.fori_loop(0, n, blend, frame)
    frame = frame[TILE_H:TILE_H + window_h, TILE_W:TILE_W + window_w]
    rgba = jnp.clip(frame * 255.0 + 0.5, 0, 255).astype(jnp.uint8)
    return rgba[..., jnp.array([2, 1, 0, 3])]  # BGRA (reference caps)


@functools.partial(__import__("jax").jit,
                   static_argnames=("window_h", "window_w"))
def composite_instances(atlas, ints, cols, window_h: int, window_w: int,
                        imgatlas=None):
    return _composite_core(atlas, ints, cols, window_h, window_w, imgatlas)


@functools.partial(__import__("jax").jit,
                   static_argnames=("window_h", "window_w", "unstack"))
def composite_instances_batch(atlas, ints, cols, window_h: int,
                              window_w: int, unstack: bool = False,
                              imgatlas=None):
    """Composite a whole batch of intervals in ONE device program.

    ints: (K, N, 9) int32, cols: (K, N, 4) float32 — K intervals, each
    padded to a common instance cap. Returns (K, window_h, window_w, 4)
    uint8 BGRA. lax.map keeps the working set at one frame: intervals
    render sequentially on-device, but the host pays a single upload +
    dispatch for the lot (the high-latency-link lesson of
    _fvc_gop_program_v1/v2, reproduced for the renderer).

    unstack=True returns a K-tuple of per-interval arrays instead — K
    independent output buffers from the SAME single dispatch, so handing
    each interval its own device array costs no extra dispatches (a
    post-hoc frames[i] slice would be one tiny chained dispatch per
    interval — pathological on a high-latency link)."""
    from jax import lax

    def one(ic):
        return _composite_core(atlas, ic[0], ic[1], window_h, window_w,
                               imgatlas)

    out = lax.map(one, (ints, cols))
    if unstack:
        return tuple(out[i] for i in range(out.shape[0]))
    return out


@functools.partial(__import__("jax").jit,
                   static_argnames=("window_h", "window_w", "unstack"))
def composite_instances_batch_vmap(atlas, ints, cols, window_h: int,
                                   window_w: int, unstack: bool = False):
    """Variant of composite_instances_batch vectorized ACROSS intervals:
    one fori_loop over the instance cap, each step blending instance i of
    every interval simultaneously (vmapped dynamic slices become batched
    gathers/scatters). Sequential chain length drops from K*N to N; the
    VPU sees K tiles per step instead of one."""
    import jax
    from jax import lax
    import jax.numpy as jnp

    k = ints.shape[0]
    n = ints.shape[1]
    ph, pw = window_h + 2 * TILE_H, window_w + 2 * TILE_W
    frames = jnp.zeros((k, ph, pw, 4), jnp.float32)

    yy = lax.broadcasted_iota(jnp.int32, (TILE_H, TILE_W), 0)
    xx = lax.broadcasted_iota(jnp.int32, (TILE_H, TILE_W), 1)

    def blend_one(inst, col, frame):
        tile_idx = inst[0]
        x = inst[1] + TILE_W
        y = inst[2] + TILE_H
        w, h = inst[3], inst[4]
        cx0, cy0 = inst[5] + TILE_W, inst[6] + TILE_H
        cx1, cy1 = inst[7] + TILE_W, inst[8] + TILE_H
        tile = lax.dynamic_slice(
            atlas, (tile_idx, 0, 0), (1, TILE_H, TILE_W))[0]
        gx = xx + x
        gy = yy + y
        mask = ((xx < w) & (yy < h) &
                (gx >= cx0) & (gx < cx1) & (gy >= cy0) & (gy < cy1))
        sa = (tile.astype(jnp.float32) / 255.0) * col[3]
        sa = jnp.where(mask, sa, 0.0)[..., None]
        dst = lax.dynamic_slice(frame, (y, x, 0), (TILE_H, TILE_W, 4))
        da = dst[..., 3:]
        out_a = sa + da * (1 - sa)
        rgb = (col[:3] * sa + dst[..., :3] * da * (1 - sa)) \
            / jnp.maximum(out_a, 1e-6)
        new = jnp.concatenate([rgb, out_a], axis=-1)
        return lax.dynamic_update_slice(frame, new, (y, x, 0))

    def step(i, frames):
        return jax.vmap(lambda it, co, fr: blend_one(it[i], co[i], fr))(
            ints, cols, frames)

    frames = lax.fori_loop(0, n, step, frames)
    frames = frames[:, TILE_H:TILE_H + window_h, TILE_W:TILE_W + window_w]
    rgba = jnp.clip(frames * 255.0 + 0.5, 0, 255).astype(jnp.uint8)
    out = rgba[..., jnp.array([2, 1, 0, 3])]
    if unstack:
        return tuple(out[i] for i in range(out.shape[0]))
    return out


@functools.partial(__import__("jax").jit,
                   static_argnames=("window_h", "window_w"))
def composite_instances_over(atlas, ints, cols, base_bgra,
                             window_h: int, window_w: int, imgatlas=None):
    """Like composite_instances but blending OVER an existing BGRA window
    (host-layer fallback content below the instance stream)."""
    import jax.numpy as jnp
    top = composite_instances(atlas, ints, cols, window_h, window_w,
                              imgatlas)
    t = top.astype(jnp.float32) / 255.0
    b = base_bgra.astype(jnp.float32) / 255.0
    ta = t[..., 3:]
    out_a = ta + b[..., 3:] * (1 - ta)
    rgb = (t[..., :3] * ta + b[..., :3] * b[..., 3:] * (1 - ta)) \
        / jnp.maximum(out_a, 1e-6)
    out = jnp.concatenate([rgb, out_a], axis=-1)
    return jnp.clip(out * 255.0 + 0.5, 0, 255).astype(jnp.uint8)


class InstanceList:
    """Host-side builder for the instance stream of one interval."""

    def __init__(self):
        self.ints: List[Tuple[int, ...]] = []
        self.cols: List[Tuple[float, float, float, float]] = []

    def add_entry(self, entry, x: int, y: int, color, alpha_scale: float,
                  clip: Tuple[int, int, int, int]):
        """All tiles of an atlas entry placed with its top-left at (x, y)."""
        for (tile, dx, dy, w, h) in entry.tiles:
            self.add_tile(tile, x + dx, y + dy, w, h, color, alpha_scale,
                          clip)

    def add_tile(self, tile: int, x: int, y: int, w: int, h: int, color,
                 alpha_scale: float, clip: Tuple[int, int, int, int]):
        a = (color[3] / 255.0) * alpha_scale
        if a <= 0.0 or w <= 0 or h <= 0:
            return
        # clamp placement into the padded working range: starts may not be
        # more than one tile outside the window (clip rect keeps geometry)
        self.ints.append((tile, int(x), int(y), int(w), int(h),
                          int(clip[0]), int(clip[1]),
                          int(clip[2]), int(clip[3])))
        self.cols.append((color[0] / 255.0, color[1] / 255.0,
                          color[2] / 255.0, a))

    def add_rect(self, x: int, y: int, w: int, h: int, color,
                 alpha_scale: float, clip: Tuple[int, int, int, int]):
        """Solid rectangle via the reserved all-255 tile 0 (backgrounds,
        underline/strike/overline decoration rects)."""
        for ty in range(0, h, TILE_H):
            for tx in range(0, w, TILE_W):
                self.add_tile(0, x + tx, y + ty,
                              min(TILE_W, w - tx), min(TILE_H, h - ty),
                              color, alpha_scale, clip)

    def filtered(self, window_h: int, window_w: int):
        """(ints, cols) lists with out-of-window instances dropped and
        starts clamped to the one-tile padding margin."""
        out_i: List[Tuple[int, ...]] = []
        out_c = []
        for (t, x, y, w, h, cx0, cy0, cx1, cy1), c in zip(self.ints,
                                                          self.cols):
            if (x + w <= -TILE_W or y + h <= -TILE_H or x >= window_w
                    or y >= window_h):
                continue
            x = max(-TILE_W, min(x, window_w))
            y = max(-TILE_H, min(y, window_h))
            cx0, cy0 = max(cx0, -TILE_W), max(cy0, -TILE_H)
            cx1 = min(cx1, window_w + TILE_W)
            cy1 = min(cy1, window_h + TILE_H)
            out_i.append((t, x, y, w, h, cx0, cy0, cx1, cy1))
            out_c.append(c)
        return out_i, out_c

    def arrays(self, window_h: int, window_w: int):
        """Padded (ints, cols) numpy arrays, instance count rounded to the
        next power of two (no-op padding keeps compiled programs
        reusable)."""
        out_i, out_c = self.filtered(window_h, window_w)
        return pad_instances(out_i, out_c)


def pad_instances(out_i, out_c, cap: Optional[int] = None):
    """Instance lists → (cap, 9) int32 / (cap, 4) float32 arrays padded
    with no-op instances (zero size, zero alpha)."""
    n = max(1, len(out_i))
    if cap is None:
        cap = 1
        while cap < n:
            cap *= 2
    ints = np.zeros((cap, 9), np.int32)
    cols = np.zeros((cap, 4), np.float32)
    if out_i:
        ints[:len(out_i)] = np.asarray(out_i, np.int32)
        cols[:len(out_c)] = np.asarray(out_c, np.float32)
    return ints, cols
