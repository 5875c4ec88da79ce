"""Motion estimation/compensation — block matching as device math.

The device take on a codec's motion search: instead of per-macroblock
scalar loops, the full search evaluates every candidate displacement as a
whole-frame vector op (roll → absolute difference → per-macroblock box
reduction) with static shapes. Predictions
use wrap-around semantics (jnp.roll) — a valid predictor as long as the
decoder mirrors it, which ours does.

16x16 luma macroblocks; chroma (4:2:0) is compensated with the luma vector
halved on an 8x8 grid.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

MB = 16  # luma macroblock


def _mb_sums(diff: jnp.ndarray, mb: int) -> jnp.ndarray:
    """(H, W) → per-macroblock sums (H/mb, W/mb)."""
    h, w = diff.shape
    return diff.reshape(h // mb, mb, w // mb, mb).sum(axis=(1, 3))


@functools.partial(jax.jit, static_argnames=("search_range", "mb"))
def motion_search(cur_y: jnp.ndarray, prev_y: jnp.ndarray,
                  search_range: int = 7, mb: int = MB):
    """Full-search motion estimation.

    cur_y/prev_y: (H, W) float luma (H, W multiples of mb).
    Returns mv (mbh, mbw, 2) int32 — per-macroblock (dy, dx) minimizing SAD
    over the ±search_range window (ties → first candidate scanned).
    """
    h, w = cur_y.shape
    mbh, mbw = h // mb, w // mb
    n = 2 * search_range + 1

    def body(c, state):
        best_cost, best_mv = state
        dy = c // n - search_range
        dx = c % n - search_range
        shifted = jnp.roll(prev_y, (dy, dx), axis=(0, 1))
        sad = _mb_sums(jnp.abs(cur_y - shifted), mb)
        # center-preferring tie bias: on flat content many candidates SAD
        # equal and the winner is summation-order noise; a small |mv|
        # penalty makes every formulation pick small vectors, which also
        # compresses the vector field far better. Integer-scaled so it is
        # EXACT in f32 (SAD <= 65280, *64 + 14 < 2^24): a fractional bias
        # falls below one ulp once SAD > ~8192 and silently disappears.
        cost = sad * 64 + (abs(dy) + abs(dx))
        better = cost < best_cost
        best_cost = jnp.where(better, cost, best_cost)
        mv_c = jnp.stack([jnp.full_like(cost, dy, dtype=jnp.int32),
                          jnp.full_like(cost, dx, dtype=jnp.int32)], axis=-1)
        best_mv = jnp.where(better[..., None], mv_c, best_mv)
        return best_cost, best_mv

    # data-derived init (not jnp.full/zeros) so the loop carry keeps the
    # inputs' varying-manual-axes under shard_map
    z = cur_y[::mb, ::mb].astype(jnp.float32) * 0  # (mbh, mbw)
    init = (z + jnp.inf, jnp.stack([z, z], axis=-1).astype(jnp.int32))
    _, mv = jax.lax.fori_loop(0, n * n, body, init)
    return mv


@functools.partial(jax.jit, static_argnames=("search_range", "mb"))
def motion_compensate(prev: jnp.ndarray, mv: jnp.ndarray,
                      search_range: int = 7, mb: int = MB):
    """Build the prediction: each mb×mb block of the output comes from
    ``prev`` displaced by its motion vector (wrap-around edges).

    prev: (H, W); mv: (H/mb_l, W/mb_l, 2) on the LUMA grid — for chroma
    pass mb=8 and the same mv (vectors are halved internally when
    mb != MB). One flat gather per output pixel.
    """
    del search_range   # the gather needs no candidate window
    h, w = prev.shape
    scale = MB // mb  # 1 luma, 2 chroma
    dy = mv[..., 0] if scale == 1 else mv[..., 0] // 2
    dx = mv[..., 1] if scale == 1 else mv[..., 1] // 2
    dy_full = jnp.repeat(jnp.repeat(dy, mb, axis=0), mb, axis=1)
    dx_full = jnp.repeat(jnp.repeat(dx, mb, axis=0), mb, axis=1)
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    # jnp.roll(a, s) places a[(i - s) % n] at out[i]
    sy = (yy - dy_full) % h
    sx = (xx - dx_full) % w
    return prev.reshape(-1)[sy * w + sx]


# ---------------------------------------------------------------------------
# Spatially-sharded (sequence-parallel) formulations.
#
# A frame row-striped over a mesh axis needs its neighbors' edge rows to
# search/compensate near stripe boundaries. The halo travels as a
# RING ppermute: stripe s receives stripe s-1's bottom r rows and stripe
# s+1's top r rows, with ring wrap-around — which reproduces jnp.roll's
# whole-frame wrap semantics EXACTLY, so per-pixel results match the
# unsharded formulation bit for bit (the per-frame mode decision reduces
# via psum of stripe sums, whose f32 ordering may differ from a
# whole-frame sum on exact ties — see fvc_mc_encode_chunk).
# ---------------------------------------------------------------------------

def exchange_row_halos(plane: jnp.ndarray, r: int, axis_name: str,
                       n_shards: int) -> jnp.ndarray:
    """(Hs, W) stripe → (Hs + 2r, W) with ring-neighbor halos attached
    (two ppermutes over ``axis_name``)."""
    down = [(j, (j + 1) % n_shards) for j in range(n_shards)]
    up = [(j, (j - 1) % n_shards) for j in range(n_shards)]
    halo_top = jax.lax.ppermute(plane[-r:], axis_name, down)
    halo_bot = jax.lax.ppermute(plane[:r], axis_name, up)
    return jnp.concatenate([halo_top, plane, halo_bot], axis=0)


def motion_search_striped(cur_s: jnp.ndarray, prev_haloed: jnp.ndarray,
                          search_range: int = 7, mb: int = MB):
    """motion_search on a row stripe: ``prev_haloed`` carries ±r halo rows
    (exchange_row_halos). Same candidate order, cost and tie semantics as
    motion_search — bit-identical vectors for this stripe's macroblocks."""
    hs, w = cur_s.shape
    r = search_range
    n = 2 * r + 1

    def body(c, state):
        best_cost, best_mv = state
        dy = c // n - r
        dx = c % n - r
        sx = jnp.roll(prev_haloed, dx, axis=1)     # x wrap is stripe-local
        shifted = jax.lax.dynamic_slice_in_dim(sx, r - dy, hs, axis=0)
        sad = _mb_sums(jnp.abs(cur_s - shifted), mb)
        cost = sad * 64 + (abs(dy) + abs(dx))
        better = cost < best_cost
        best_cost = jnp.where(better, cost, best_cost)
        mv_c = jnp.stack([jnp.full_like(cost, dy, dtype=jnp.int32),
                          jnp.full_like(cost, dx, dtype=jnp.int32)],
                         axis=-1)
        best_mv = jnp.where(better[..., None], mv_c, best_mv)
        return best_cost, best_mv

    z = cur_s[::mb, ::mb].astype(jnp.float32) * 0
    init = (z + jnp.inf, jnp.stack([z, z], axis=-1).astype(jnp.int32))
    _, mv = jax.lax.fori_loop(0, n * n, body, init)
    return mv


def motion_compensate_striped(prev_haloed: jnp.ndarray, mv: jnp.ndarray,
                              halo: int, search_range: int = 7,
                              mb: int = MB):
    """motion_compensate on a row stripe (candidate-enumeration form).
    ``prev_haloed`` carries ±halo rows; for chroma pass mb=8, the
    chroma-haloed plane with halo=(search_range+1)//2 and the LUMA-grid
    vectors (halved internally). Bit-identical to the unsharded
    motion_compensate for this stripe's rows."""
    hs = prev_haloed.shape[0] - 2 * halo
    scale = MB // mb
    if scale != 1:
        lo = -((search_range + 1) // 2)
        hi = search_range // 2
        m = hi - lo + 1
        dyh = mv[..., 0] // 2
        dxh = mv[..., 1] // 2

        def body_c(c, pred):
            sdy = c // m + lo
            sdx = c % m + lo
            sx = jnp.roll(prev_haloed, sdx, axis=1)
            shifted = jax.lax.dynamic_slice_in_dim(sx, halo - sdy, hs,
                                                   axis=0)
            sel = (dyh == sdy) & (dxh == sdx)
            mask = jnp.repeat(jnp.repeat(sel, mb, axis=0), mb, axis=1)
            return jnp.where(mask, shifted, pred)

        return jax.lax.fori_loop(0, m * m, body_c,
                                 prev_haloed[halo:halo + hs] * 0)

    n = 2 * search_range + 1

    def body(c, pred):
        dy = c // n - search_range
        dx = c % n - search_range
        sx = jnp.roll(prev_haloed, dx, axis=1)
        shifted = jax.lax.dynamic_slice_in_dim(sx, halo - dy, hs, axis=0)
        sel = (mv[..., 0] == dy) & (mv[..., 1] == dx)
        mask = jnp.repeat(jnp.repeat(sel, mb, axis=0), mb, axis=1)
        return jnp.where(mask, shifted, pred)

    return jax.lax.fori_loop(0, n * n, body,
                             prev_haloed[halo:halo + hs] * 0)


@functools.partial(jax.jit, static_argnames=("search_range",))
def motion_search_hier(cur_y: jnp.ndarray, prev_y: jnp.ndarray,
                       search_range: int = 7):
    """Two-level coarse-to-fine motion estimation.

    Level 0 full-searches ±search_range//2 on 2x2-average-pooled frames
    (8x8 blocks = the 16x16 luma macroblocks at half resolution); level 1
    refines ±1 at full resolution by gathering one (MB+2)x(MB+2) window
    per macroblock around the upscaled coarse vector and evaluating the
    nine SADs. ~7x fewer whole-frame passes than the full search; vectors
    stay within ±search_range so the container contract is unchanged.
    """
    h, w = cur_y.shape
    mbh, mbw = h // MB, w // MB

    def pool(x):
        return x.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))

    coarse = motion_search(pool(cur_y), pool(prev_y),
                           search_range=max(1, search_range // 2), mb=8)
    base = jnp.clip(coarse * 2, -(search_range - 1), search_range - 1)

    # one (MB+2)^2 window per macroblock around the base displacement
    by = (jnp.arange(mbh) * MB)[:, None, None, None]
    bx = (jnp.arange(mbw) * MB)[None, :, None, None]
    wy = (jnp.arange(MB + 2) - 1)[None, None, :, None]
    wx = (jnp.arange(MB + 2) - 1)[None, None, None, :]
    sy = (by + wy - base[..., 0][..., None, None]) % h
    sx = (bx + wx - base[..., 1][..., None, None]) % w
    win = prev_y.reshape(-1)[sy * w + sx]          # (mbh, mbw, MB+2, MB+2)
    cur_b = cur_y.reshape(mbh, MB, mbw, MB).transpose(0, 2, 1, 3)

    z = cur_y[::MB, ::MB].astype(jnp.float32) * 0
    best_cost = z + jnp.inf
    best_mv = jnp.stack([z, z], axis=-1).astype(jnp.int32)
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            # candidate dy = base+oy → source pixel i reads window i-oy
            cand = jax.lax.dynamic_slice_in_dim(
                jax.lax.dynamic_slice_in_dim(win, 1 - oy, MB, axis=2),
                1 - ox, MB, axis=3)
            cost = jnp.abs(cur_b - cand).sum(axis=(-1, -2))
            off = jnp.stack([jnp.full_like(cost, oy, dtype=jnp.int32),
                             jnp.full_like(cost, ox, dtype=jnp.int32)],
                            axis=-1)
            better = cost < best_cost
            best_cost = jnp.where(better, cost, best_cost)
            best_mv = jnp.where(better[..., None], base + off, best_mv)
    return best_mv


@functools.partial(jax.jit, static_argnames=("mb",))
def motion_compensate_subpel(prev: jnp.ndarray, mv_hp: jnp.ndarray,
                             mb: int = MB):
    """Half-pel motion compensation: ``mv_hp`` is in HALF-PIXEL units on
    the luma grid (chroma: pass mb=8 — vectors are floor-halved onto the
    chroma grid, still in half-pel units). Bilinear between the four
    neighboring integer-shift samples; four flat gathers total."""
    h, w = prev.shape
    scale = MB // mb
    d = mv_hp if scale == 1 else mv_hp // 2
    dyf = jnp.repeat(jnp.repeat(d[..., 0], mb, axis=0), mb, axis=1)
    dxf = jnp.repeat(jnp.repeat(d[..., 1], mb, axis=0), mb, axis=1)
    iy = dyf // 2
    ix = dxf // 2
    fy = (dyf - 2 * iy).astype(jnp.float32) * 0.5  # 0 or .5
    fx = (dxf - 2 * ix).astype(jnp.float32) * 0.5
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    flat = prev.reshape(-1)

    def g(ddy, ddx):
        sy = (yy - ddy) % h
        sx = (xx - ddx) % w
        return flat[sy * w + sx]

    p00 = g(iy, ix)
    p10 = g(iy + 1, ix)
    p01 = g(iy, ix + 1)
    p11 = g(iy + 1, ix + 1)
    return ((1 - fy) * (1 - fx) * p00 + fy * (1 - fx) * p10
            + (1 - fy) * fx * p01 + fy * fx * p11)


@jax.jit
def subpel_refine(cur_y: jnp.ndarray, prev_y: jnp.ndarray,
                  int_mv: jnp.ndarray) -> jnp.ndarray:
    """±half-pel refinement around integer vectors.

    Gathers one (MB+2)x(MB+2) window per macroblock at the integer vector
    and evaluates the nine half-pel candidates from bilinear slice
    averages (window-local — no further gathers). Returns vectors in
    HALF-PIXEL units: 2*int_mv + offset, offset ∈ {-1,0,1}^2."""
    h, w = cur_y.shape
    mbh, mbw = h // MB, w // MB
    base = int_mv
    by = (jnp.arange(mbh) * MB)[:, None, None, None]
    bx = (jnp.arange(mbw) * MB)[None, :, None, None]
    wy = (jnp.arange(MB + 2) - 1)[None, None, :, None]
    wx = (jnp.arange(MB + 2) - 1)[None, None, None, :]
    sy = (by + wy - base[..., 0][..., None, None]) % h
    sx = (bx + wx - base[..., 1][..., None, None]) % w
    win = prev_y.reshape(-1)[sy * w + sx]          # (mbh, mbw, MB+2, MB+2)
    cur_b = cur_y.reshape(mbh, MB, mbw, MB).transpose(0, 2, 1, 3)

    def rows(a):
        # source row j = i + 1 - a/2 for half-offset a ∈ {-1, 0, 1}
        if a == 0:
            return win[:, :, 1:1 + MB, :]
        if a == 1:
            return 0.5 * (win[:, :, 0:MB, :] + win[:, :, 1:1 + MB, :])
        return 0.5 * (win[:, :, 1:1 + MB, :] + win[:, :, 2:2 + MB, :])

    def cols(x, a):
        if a == 0:
            return x[..., 1:1 + MB]
        if a == 1:
            return 0.5 * (x[..., 0:MB] + x[..., 1:1 + MB])
        return 0.5 * (x[..., 1:1 + MB] + x[..., 2:2 + MB])

    z = cur_y[::MB, ::MB].astype(jnp.float32) * 0
    best_cost = z + jnp.inf
    best_mv = jnp.stack([z, z], axis=-1).astype(jnp.int32)
    for ay in (-1, 0, 1):
        r = rows(ay)
        for ax in (-1, 0, 1):
            cand = cols(r, ax)
            cost = jnp.abs(cur_b - cand).sum(axis=(-1, -2))
            off = jnp.stack([jnp.full_like(cost, ay, dtype=jnp.int32),
                             jnp.full_like(cost, ax, dtype=jnp.int32)],
                            axis=-1)
            better = cost < best_cost
            best_cost = jnp.where(better, cost, best_cost)
            best_mv = jnp.where(better[..., None], 2 * base + off, best_mv)
    return best_mv
