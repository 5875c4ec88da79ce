"""The plain-XLA front end (overlay → YCbCr → 4:2:0 → DCT → quantize →
zigzag): the 8x8 and block-diagonal planar DCT formulations agree, and the
overlay fold matches burning the interleaved frames first."""

import jax.numpy as jnp
import numpy as np
import pytest

from flutpu.codec.jpeg import (JpegEncoder, _planes_front_end,
                               encode_gop_planes_to_coefs,
                               encode_gop_to_coefs)
from flutpu.codec.ops.testsrc import gradient_ball_planes

# (frames, height, width) source shapes at quarter scale, coded to
# multiples of 16: 1080p-like (1088x1920 coded), 4K-like whose 540 rows
# pad to 544, and odd sizes that need edge padding in both dimensions
SHAPES = {
    "1080p_like": (2, 272, 480),
    "4k_padded": (1, 540, 960),
    "odd": (2, 44, 70),
}


def _planes(f, h, w, seed=0):
    r, g, b = gradient_ball_planes(h, w, f, jnp.float32(seed))
    return r, g, b


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_dct_forms_agree(name):
    f, h, w = SHAPES[name]
    ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
    enc = JpegEncoder(quality=85)
    r, g, b = _planes(f, h, w)
    out = {}
    for planar in (False, True):
        out[planar] = [np.asarray(c) for c in encode_gop_planes_to_coefs(
            r, g, b, enc._qy_dev, enc._qc_dev, pad_h=ph, pad_w=pw,
            planar=planar)]
    for a, c in zip(out[False], out[True]):
        assert a.shape == c.shape
        # the two summation orders may round a razor tie differently
        assert np.abs(a.astype(np.int32) - c).max() <= 1
        assert (a != c).mean() < 1e-3


@pytest.mark.parametrize("name", ["1080p_like", "odd"])
def test_planar_entry_matches_interleaved(name):
    """Channel planes and the interleaved (F, H, W, 3) entry give the
    same coefficients, padding included."""
    f, h, w = SHAPES[name]
    ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
    enc = JpegEncoder(quality=85)
    r, g, b = _planes(f, h, w, seed=3)
    want = encode_gop_to_coefs(jnp.stack([r, g, b], -1), enc._qy_dev,
                               enc._qc_dev, pad_h=ph, pad_w=pw)
    got = encode_gop_planes_to_coefs(r, g, b, enc._qy_dev, enc._qc_dev,
                                     pad_h=ph, pad_w=pw)
    for a, c in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))


def test_overlay_fold_matches_burning_frames_first():
    from flutpu.ttml.render import overlay_on_frames
    f, h, w = 2, 64, 96
    enc = JpegEncoder(quality=85)
    r, g, b = _planes(f, h, w, seed=5)
    ov = np.zeros((h, w, 4), np.uint8)
    ov[40:56, 8:88] = (30, 200, 250, 255)      # opaque box
    ov[8:24, 8:40, 3] = 128                    # half-transparent box
    ov = jnp.asarray(ov)
    got = _planes_front_end(r, g, b, enc._qy_dev, enc._qc_dev, pad_h=h,
                            pad_w=w, subsample=True, overlay=ov)
    burned = overlay_on_frames(jnp.stack([r, g, b], -1), ov)
    want = encode_gop_to_coefs(burned, enc._qy_dev, enc._qc_dev, pad_h=h,
                               pad_w=w)
    for a, c in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
