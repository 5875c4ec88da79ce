"""The Pallas pack kernel (compiled through Triton on the card, interpret
mode on CPU) must be bit-identical to the lax.scan formulation and to the
host coder."""

import numpy as np
import pytest

import jax.numpy as jnp

from flutpu.codec.jpeg import JpegEncoder
from flutpu.codec.ops.entropy import _pack_block_bits, _slot_tables
from flutpu.codec.ops.pack_kernel import pack_segments
from flutpu.core.elements import make_test_frame


def _random_blocks(b, seed):
    """Random sparse quantized blocks and their component classes."""
    rng = np.random.default_rng(seed)
    zz = np.zeros((b, 64), np.int32)
    for i in range(b):
        n = rng.integers(0, 20)
        pos = rng.choice(64, size=n, replace=False)
        zz[i, pos] = rng.integers(-200, 200, size=n)
    comp = (np.arange(b) % 3 > 0).astype(np.int32)
    return jnp.asarray(zz), jnp.asarray(comp)


@pytest.mark.parametrize("b", [1, 7, 130])
def test_pallas_matches_scan(b):
    zz, comp = _random_blocks(b, seed=b)
    buf_s, nb_s = _pack_block_bits(*_slot_tables(zz, comp))
    buf_p, nb_p = pack_segments(zz, comp, seg_g=1, n_words=64)
    np.testing.assert_array_equal(np.asarray(nb_p), np.asarray(nb_s))
    np.testing.assert_array_equal(np.asarray(buf_p), np.asarray(buf_s))


def test_full_pipeline_with_pallas_interpret():
    frames = make_test_frame("gradient", 32, 32, 2)[None]
    host = JpegEncoder(quality=85, engine="host").encode_gop(frames)
    # use_pallas=True on the CPU runs the kernel in interpret mode
    dev = JpegEncoder(quality=85, engine="device", use_pallas=True)
    assert dev.use_pallas
    out = dev.encode_gop(frames)
    assert out == host


def test_merged_64bit_slots_bit_identical():
    """Merged 64-bit slots (scan + kernel) match the 32-bit slot scan
    packer bit for bit."""
    from flutpu.codec.ops.entropy import (_pack_block_bits,
                                          _pack_block_bits64,
                                          _slot_tables,
                                          _slot_tables_merged)

    rng = np.random.default_rng(42)
    zz = rng.integers(-40, 40, size=(96, 64)).astype(np.int32)
    zz[rng.random(zz.shape) < 0.75] = 0      # sparse like real coefs
    zz[:5] = 0                                # all-zero blocks
    zz[6, 63] = 9                             # nonzero at the last position
    zz[7, 1:] = 0; zz[7, 0] = -1023           # DC-only, max magnitude
    zz[8, 1:48] = 0                           # long zero run -> 2+ ZRLs
    comp = (np.arange(96) % 3 > 0).astype(np.int32)

    lens, vals = _slot_tables(jnp.asarray(zz), jnp.asarray(comp))
    ref_buf, ref_nb = _pack_block_bits(lens, vals)

    ml, mh, mo = _slot_tables_merged(jnp.asarray(zz), jnp.asarray(comp))
    buf64, nb64 = _pack_block_bits64(ml, mh, mo)
    np.testing.assert_array_equal(np.asarray(ref_buf), np.asarray(buf64))
    np.testing.assert_array_equal(np.asarray(ref_nb), np.asarray(nb64))

    buf_p, nb_p = pack_segments(jnp.asarray(zz), jnp.asarray(comp),
                                seg_g=1, n_words=64)
    np.testing.assert_array_equal(np.asarray(ref_buf), np.asarray(buf_p))
    np.testing.assert_array_equal(np.asarray(ref_nb), np.asarray(nb_p))


def test_fused_slot_pack_bit_identical():
    """The kernel (slot symbol math computed in-kernel, run-lengths as
    loop state) is bit-identical to the split _slot_tables_merged +
    _pack_block_bits64 formulation, across DC-only blocks, >47-zero runs
    (3 ZRLs), nonzero position 63 (no EOB), and both component classes."""
    from flutpu.codec.ops.entropy import (_pack_block_bits64,
                                          _slot_tables_merged)

    rng = np.random.default_rng(17)
    b = 260
    zz = np.zeros((b, 64), np.int32)
    zz[:, 0] = rng.integers(-2047, 2048, b)
    for i in range(b):
        k = rng.integers(0, 30)
        pos = rng.choice(np.arange(1, 64), size=k, replace=False)
        zz[i, pos] = rng.integers(-1023, 1024, k)
    zz[3, 1:] = 0                      # DC-only (EOB immediately)
    zz[4, 1:] = 0; zz[4, 63] = 9       # run 62 (3 ZRLs), no EOB
    zz[5, 1:] = 0; zz[5, 33] = -1      # run 32 (2 ZRLs)
    comp = (rng.random(b) > 0.5).astype(np.int32)

    lens, his, los = _slot_tables_merged(jnp.asarray(zz), jnp.asarray(comp))
    ref_buf, ref_nb = _pack_block_bits64(lens, his, los)
    got_buf, got_nb = pack_segments(jnp.asarray(zz), jnp.asarray(comp),
                                    seg_g=1, n_words=64)
    np.testing.assert_array_equal(np.asarray(got_nb), np.asarray(ref_nb))
    np.testing.assert_array_equal(np.asarray(got_buf), np.asarray(ref_buf))


class TestSegmentLayout:
    """Segment bitstream layout: the packer emits per-lane segments of
    SEG_G consecutive blocks, the device word-aligns whole segments (no
    block-granular concat), the host bit-compacts. The contract
    everywhere is BYTE IDENTITY with the block-concat stream."""

    def _planes(self, f=2, ybh=8, ybw=12, seed=0, dense=False):
        rng = np.random.default_rng(seed)
        shape = lambda bh, bw: (f, bh, bw, 64)  # noqa: E731
        def sparse(s):
            a = rng.integers(-40, 40, size=s).astype(np.int16)
            a = np.where(rng.random(s) < (0.3 if dense else 0.08), a, 0)
            a[..., 0] = rng.integers(-200, 200, size=s[:-1])
            return a
        return (sparse(shape(ybh, ybw)), sparse(shape(ybh // 2, ybw // 2)),
                sparse(shape(ybh // 2, ybw // 2)))

    @pytest.mark.slow
    def test_segmented_scan_byte_identical(self):
        from flutpu.codec.ops import entropy as E
        yq, cbq, crq = self._planes()
        layout = E.mcu_layout(12, 8, 6, 4, True)
        prefix = 4096
        packed, bits = E.encode_gop_scans(
            jnp.asarray(yq), jnp.asarray(cbq), jnp.asarray(crq),
            layout=layout, out_words=prefix)
        comb = E.encode_gop_scans_segmented(
            jnp.asarray(yq), jnp.asarray(cbq), jnp.asarray(crq),
            layout=layout, prefix_words=prefix, seg_g=16, seg_words=128,
            use_pallas=True)
        arr = np.asarray(comb)
        s = arr.shape[1] - 1 - prefix
        for i in range(yq.shape[0]):
            segbits = arr[i, 1:1 + s]
            assert (segbits <= 128 * 32).all()
            stream, total = E.compact_aligned_segments(
                segbits, arr[i, 1 + s:])
            assert total == int(np.asarray(bits)[i])
            assert (E.stuff_and_finalize(stream, total)
                    == E.stuff_and_finalize(np.asarray(packed)[i],
                                            int(np.asarray(bits)[i])))

    @pytest.mark.slow
    def test_encoder_segmented_matches_standard(self):
        frames = make_test_frame("gradient", 32, 32, 2)[None].repeat(2, 0)
        std = JpegEncoder(quality=85, engine="device",
                          use_pallas=False).encode_gop(frames)
        seg = JpegEncoder(quality=85, engine="device", use_pallas=False,
                          segmented=True).encode_gop(frames)
        assert seg == std

    @pytest.mark.parametrize("use_pallas", [False, True],
                             ids=["scan", "kernel"])
    def test_encoder_dispatch_finalize_segmented(self, use_pallas):
        frames = make_test_frame("gradient", 32, 32, 7)[None].repeat(2, 0)
        std = JpegEncoder(quality=85, use_pallas=False)
        seg = JpegEncoder(quality=85, use_pallas=use_pallas, segmented=True)
        fdev = jnp.asarray(frames)
        want = std.encode_gop_finalize(std.encode_gop_dispatch(fdev, 32, 32))
        got = seg.encode_gop_finalize(seg.encode_gop_dispatch(fdev, 32, 32))
        assert got == want

    def test_native_compaction_byte_identical(self):
        """The one-pass C++ compact+finalize (flu_compact_segments_finalize)
        is byte-identical to the numpy pair across ragged segment sizes,
        zero (padding) segments, 0xFF-stuffing boundaries, and non-byte
        totals."""
        import pytest

        from flutpu import native
        from flutpu.codec.ops import entropy as E
        if native.get_lib() is None:
            pytest.skip("native library unavailable")
        rng = np.random.default_rng(11)
        for trial in range(20):
            n = int(rng.integers(1, 40))
            seg_bits = rng.integers(0, 513, size=n).astype(np.int64)
            if trial % 5 == 0:
                seg_bits[:] = 0       # all-padding → empty stream
            wcnt = (seg_bits + 31) >> 5
            words = rng.integers(0, 2 ** 32, size=int(wcnt.sum()),
                                 dtype=np.uint64).astype(np.uint32)
            # force plenty of 0xFF bytes through the stuffing path
            words[rng.random(len(words)) < 0.3] = 0xFFFFFFFF
            # zero the unused low bits of each segment's last word (the
            # device kernel guarantees this; keeps OR-merge semantics)
            pos = np.cumsum(wcnt)
            for i in range(n):
                rem = int(seg_bits[i]) & 31
                if seg_bits[i] and rem:
                    words[pos[i] - 1] &= np.uint32(
                        (0xFFFFFFFF << (32 - rem)) & 0xFFFFFFFF)
            stream, total = E.compact_aligned_segments(seg_bits, words)
            want = E.stuff_and_finalize(stream, total)
            got = E.compact_segments_finalize(seg_bits, words)
            assert got == want, f"trial {trial}"

    @pytest.mark.slow
    def test_capacity_overflow_grows_and_stays_correct(self):
        """A GOP whose densest segment exceeds the staging capacity must
        fall back (same bytes) and grow the capacity for the next GOP."""
        frames = (np.random.default_rng(3)
                  .integers(0, 256, size=(2, 32, 32, 3)).astype(np.uint8))
        std = JpegEncoder(quality=97, use_pallas=False)
        seg = JpegEncoder(quality=97, use_pallas=False, segmented=True)
        seg._seg_words = 8  # force overflow (8 words = 256 bits/segment)
        want = std.encode_gop(frames)
        got = seg.encode_gop(frames)
        assert got == want
        assert seg._seg_words > 8, "capacity did not grow"
        # next GOP rides the segment path at the grown capacity
        got2 = seg.encode_gop(frames)
        assert got2 == want
