"""The XLA motion arms the card runs (full search, gather compensation)
against a numpy brute force on integer planes."""

import jax.numpy as jnp
import numpy as np
import pytest

from flutpu.codec.ops.motion import MB, motion_compensate, motion_search


def _search_np(cur, prev, r, mb=MB):
    """Brute force: per macroblock, every candidate in scan order
    (dy-major), cost SAD*64 + |dy| + |dx|, first minimum wins."""
    h, w = cur.shape
    mv = np.zeros((h // mb, w // mb, 2), np.int32)
    for by in range(h // mb):
        for bx in range(w // mb):
            sl = (slice(by * mb, (by + 1) * mb),
                  slice(bx * mb, (bx + 1) * mb))
            best = None
            for dy in range(-r, r + 1):
                for dx in range(-r, r + 1):
                    cand = np.roll(prev, (dy, dx), axis=(0, 1))[sl]
                    cost = (np.abs(cur[sl] - cand).sum() * 64
                            + abs(dy) + abs(dx))
                    if best is None or cost < best:
                        best = cost
                        mv[by, bx] = (dy, dx)
    return mv


def _scene(h, w, shift, seed):
    """Integer-valued planes: a textured frame and its shifted copy with
    a little integer noise."""
    rng = np.random.default_rng(seed)
    prev = rng.integers(0, 256, size=(h, w)).astype(np.float32)
    cur = np.roll(prev, shift, axis=(0, 1))
    cur = cur + rng.integers(-2, 3, size=(h, w))
    return cur.astype(np.float32), prev


@pytest.mark.parametrize("r,shift", [(1, (1, -1)), (3, (2, 3)),
                                     (7, (-5, 6)), (7, (0, 0))])
def test_motion_search_matches_brute_force(r, shift):
    cur, prev = _scene(48, 64, shift, seed=r)
    got = np.asarray(motion_search(jnp.asarray(cur), jnp.asarray(prev),
                                   search_range=r))
    np.testing.assert_array_equal(got, _search_np(cur, prev, r))


@pytest.mark.parametrize("mb,r", [(16, 7), (8, 7), (16, 3)])
def test_gather_mc_matches_brute_force(mb, r):
    """Each mb x mb block comes from the previous plane displaced by its
    vector with wrap-around; chroma (mb=8) floor-halves the luma grid's
    vectors."""
    rng = np.random.default_rng(mb + r)
    h, w = (48, 64) if mb == 16 else (24, 32)
    prev = rng.integers(0, 256, size=(h, w)).astype(np.float32)
    mv = rng.integers(-r, r + 1, size=(h // mb, w // mb, 2)).astype(np.int32)
    got = np.asarray(motion_compensate(jnp.asarray(prev), jnp.asarray(mv),
                                       search_range=r, mb=mb))
    want = np.empty_like(prev)
    for by in range(h // mb):
        for bx in range(w // mb):
            dy, dx = mv[by, bx]
            if mb != MB:
                dy, dx = dy // 2, dx // 2
            src = np.roll(prev, (dy, dx), axis=(0, 1))
            want[by * mb:(by + 1) * mb, bx * mb:(bx + 1) * mb] = \
                src[by * mb:(by + 1) * mb, bx * mb:(bx + 1) * mb]
    np.testing.assert_array_equal(got, want)
