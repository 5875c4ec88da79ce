"""The Pallas packer (interpret mode on the CPU) at its edges: capacity
overflow, padding blocks, both bit-stream layouts end to end."""

import jax.numpy as jnp
import numpy as np
import pytest

from flutpu.codec.ops import entropy as E
from flutpu.codec.ops.pack_kernel import TILE, pack_segments


def _blocks(b, seed, density=0.3):
    rng = np.random.default_rng(seed)
    zz = rng.integers(-300, 300, size=(b, 64)).astype(np.int32)
    zz[rng.random(zz.shape) > density] = 0
    comp = (np.arange(b) % 6 >= 4).astype(np.int32)
    return zz, comp


@pytest.mark.parametrize("seg_g,n_words", [(1, 4), (16, 24)])
def test_capacity_overflow_drops_words_but_counts_bits(seg_g, n_words):
    """Words past the capacity are dropped by both packers alike, and
    the bit count still reports the true need (how callers detect the
    overflow and grow)."""
    zz, comp = _blocks(32, seed=seg_g, density=0.6)
    kb, kn = pack_segments(jnp.asarray(zz), jnp.asarray(comp), seg_g=seg_g,
                           n_words=n_words)
    sb, sn = E._pack_segments_scan(jnp.asarray(zz), jnp.asarray(comp),
                                   seg_g, n_words)
    assert (np.asarray(kn) > n_words * 32).any()
    np.testing.assert_array_equal(np.asarray(kn), np.asarray(sn))
    np.testing.assert_array_equal(np.asarray(kb), np.asarray(sb))


def test_padding_blocks_emit_no_bits():
    """comp = -1 marks padding blocks: a segment of them is empty, and a
    partly padded segment equals its live blocks alone."""
    zz, comp = _blocks(TILE + 16, seed=4)
    comp[-16:] = -1
    zz[-16:] = 0
    comp[3] = -1
    zz[3] = 0
    kb, kn = pack_segments(jnp.asarray(zz), jnp.asarray(comp), seg_g=16,
                           n_words=64)
    kn = np.asarray(kn)
    assert kn[-1] == 0 and not np.asarray(kb)[-1].any()
    live = np.delete(np.arange(16), 3)
    lb, ln = pack_segments(jnp.asarray(zz[live]), jnp.asarray(comp[live]),
                           seg_g=15, n_words=64)
    assert kn[0] == int(np.asarray(ln)[0])
    np.testing.assert_array_equal(np.asarray(kb)[0], np.asarray(lb)[0])


@pytest.mark.parametrize("subsample", [True, False])
def test_segmented_stream_same_with_either_packer(subsample):
    """The segment-layout program gives the same words with the kernel
    (interpret mode) and with the scan reference."""
    rng = np.random.default_rng(9)
    f, ybh, ybw = 2, 4, 6
    cbh, cbw = (ybh // 2, ybw // 2) if subsample else (ybh, ybw)

    def planes(bh, bw):
        a = rng.integers(-40, 40, size=(f, bh, bw, 64)).astype(np.int16)
        return jnp.asarray(np.where(rng.random(a.shape) < 0.2, a, 0))

    yq, cbq, crq = planes(ybh, ybw), planes(cbh, cbw), planes(cbh, cbw)
    layout = E.mcu_layout(ybw, ybh, cbw, cbh, subsample)
    out = [np.asarray(E.encode_gop_scans_segmented(
        yq, cbq, crq, layout=layout, prefix_words=512, seg_g=16,
        seg_words=64, use_pallas=up)) for up in (False, True)]
    np.testing.assert_array_equal(out[0], out[1])
