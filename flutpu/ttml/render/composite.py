"""Device compositing kernels — the pixel-heavy half of the renderer.

Rebuild of the per-pixel work in plugins/ttml/gstttmlrender.c (show_regions
:1235-1385, cairo surface fills and blits) as batched jnp programs: region
layers are alpha-over-composited into the output window, and subtitle
overlays are burned into whole video-frame batches (premultiplied alpha,
one fused program per GOP — the benchmark-5 path). All shapes static per
window size so XLA compiles once per geometry.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("window_h", "window_w"))
def compose_window(layers: jax.Array, boxes: jax.Array, opacities: jax.Array,
                   window_h: int, window_w: int) -> jax.Array:
    """Composite R region layers into a transparent window.

    layers: (R, window_h, window_w, 4) uint8 RGBA — each layer already
    positioned at the origin of its box and zero elsewhere (host places
    region content; device does the ordered blending).
    boxes: (R, 4) int32 [x, y, w, h] — kept for masking sanity.
    opacities: (R,) float32.
    Returns (window_h, window_w, 4) uint8 BGRA (the reference's output
    format, gstttmlrender.c caps video/x-raw BGRA).
    """
    r = layers.shape[0]
    frame = jnp.zeros((window_h, window_w, 4), jnp.float32)

    def blend(i, frame):
        src = layers[i].astype(jnp.float32) / 255.0
        sa = src[..., 3:] * opacities[i]
        out_a = sa + frame[..., 3:] * (1 - sa)
        rgb = (src[..., :3] * sa + frame[..., :3] * frame[..., 3:]
               * (1 - sa)) / jnp.maximum(out_a, 1e-6)
        return jnp.concatenate([rgb, out_a], axis=-1)

    frame = jax.lax.fori_loop(0, r, blend, frame)
    rgba = jnp.clip(frame * 255.0 + 0.5, 0, 255).astype(jnp.uint8)
    # BGRA output
    return rgba[..., jnp.array([2, 1, 0, 3])]


@jax.jit
def overlay_on_frames(frames: jax.Array, overlay_bgra: jax.Array) -> jax.Array:
    """Burn a BGRA overlay into a batch of RGB video frames.

    frames: (F, H, W, 3) uint8 RGB; overlay: (H, W, 4) uint8 BGRA.
    The subtitle burn-in kernel of the full pipeline (BASELINE config 5):
    one fused elementwise program over the whole GOP.
    """
    ov_rgb = overlay_bgra[..., jnp.array([2, 1, 0])].astype(jnp.float32)
    a = overlay_bgra[..., 3:4].astype(jnp.float32) / 255.0
    out = (frames.astype(jnp.float32) * (1 - a) + ov_rgb * a)
    return jnp.clip(out + 0.5, 0, 255).astype(jnp.uint8)


@jax.jit
def overlay_on_planes(r: jax.Array, g: jax.Array, b: jax.Array,
                      overlay_bgra: jax.Array):
    """Channel-planar overlay_on_frames: (r, g, b) uint8 planes (F, H, W)
    + (H, W, 4) uint8 BGRA overlay → blended (r, g, b) uint8 planes.

    Per-channel math identical to overlay_on_frames (same blend
    expression, clip, cast), so the two formulations are byte-identical —
    but the frames never enter the interleaved [..., 3]-minor layout (see
    colorspace.rgb_to_ycbcr_planes). The fused encode+burn-in GOP program
    uses this form."""
    a = overlay_bgra[..., 3].astype(jnp.float32) / 255.0
    out = []
    for plane, c in ((r, 2), (g, 1), (b, 0)):   # BGRA channel order
        ov_c = overlay_bgra[..., c].astype(jnp.float32)
        o = plane.astype(jnp.float32) * (1 - a) + ov_c * a
        out.append(jnp.clip(o + 0.5, 0, 255).astype(jnp.uint8))
    return tuple(out)


def place_layers(region_layers, window_h: int, window_w: int):
    """Host helper: position each RegionLayout's layer into a window-sized
    canvas and stack for compose_window."""
    stacked = []
    boxes = []
    ops = []
    for rl in region_layers:
        canvas = np.zeros((window_h, window_w, 4), np.uint8)
        x0, y0 = max(0, rl.x), max(0, rl.y)
        x1 = min(window_w, rl.x + rl.layer.shape[1])
        y1 = min(window_h, rl.y + rl.layer.shape[0])
        if x1 > x0 and y1 > y0:
            canvas[y0:y1, x0:x1] = rl.layer[y0 - rl.y:y1 - rl.y,
                                            x0 - rl.x:x1 - rl.x]
        stacked.append(canvas)
        boxes.append([rl.x, rl.y, rl.layer.shape[1], rl.layer.shape[0]])
        ops.append(rl.opacity)
    if not stacked:
        stacked = [np.zeros((window_h, window_w, 4), np.uint8)]
        boxes = [[0, 0, 0, 0]]
        ops = [0.0]
    return (np.stack(stacked), np.asarray(boxes, np.int32),
            np.asarray(ops, np.float32))
