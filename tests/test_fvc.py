"""FVC GOP codec tests: roundtrip quality, P-frame gains, chunk-boundary
bit-exactness (the hype stitch contract), element integration."""

import numpy as np
import pytest

from flutpu.codec.fvc import FvcDecoder, FvcEncoder, MAGIC
from flutpu.codec.jpeg import psnr
from flutpu.core import Buffer, Harness, MSECOND
from flutpu.core.elements import make_test_frame


def video(n, w=64, h=48, pattern="ball"):
    return np.stack([make_test_frame(pattern, w, h, i) for i in range(n)])


class TestFvcCodec:
    def test_roundtrip_psnr(self):
        frames = video(6)
        enc = FvcEncoder(quality=90)
        chunk = enc.encode_chunk(frames)
        assert chunk[:4] == MAGIC
        dec, info = FvcDecoder().decode_chunk(chunk)
        assert dec.shape == frames.shape
        assert info["types"] == [0, 1, 1, 1, 1, 1]
        for i in range(len(frames)):
            assert psnr(frames[i], dec[i]) > 30, f"frame {i}"

    def test_p_frames_smaller_than_i_only(self):
        """Static content: P frames must be far cheaper than re-coding I."""
        frames = np.repeat(video(1, pattern="gradient"), 8, axis=0)
        fvc = len(FvcEncoder(quality=85).encode_chunk(frames))
        from flutpu.codec.jpeg import JpegEncoder
        mjpeg = sum(len(p) for p in
                    JpegEncoder(quality=85, engine="host").encode_gop(frames))
        assert fvc < mjpeg * 0.4, (fvc, mjpeg)

    def test_no_drift_on_static_content(self):
        frames = np.repeat(video(1, pattern="gradient"), 10, axis=0)
        dec, _ = FvcDecoder().decode_chunk(
            FvcEncoder(quality=85).encode_chunk(frames))
        # all decoded frames identical: residuals are exactly zero
        for i in range(1, 10):
            np.testing.assert_array_equal(dec[i], dec[0])

    def test_chunked_stream_bit_exact_stitch(self):
        """Encoding N chunks separately and concatenating equals encoding
        the same chunk boundaries in one pass — the hype stitch invariant."""
        frames = video(12)
        enc = FvcEncoder(quality=85)
        whole = enc.encode_chunk(frames[:6]) + enc.encode_chunk(frames[6:])
        c1 = enc.encode_chunk(frames[:6])
        c2 = enc.encode_chunk(frames[6:])
        assert whole == c1 + c2  # stateless chunks → bit-exact boundaries
        dec = FvcDecoder().decode_stream(whole)
        assert dec.shape == frames.shape
        assert psnr(frames[8], dec[8]) > 30

    def test_device_and_host_engines_bit_identical(self):
        """The device entropy path (only compressed bits cross the link)
        must emit byte-identical chunks to the host C++ coder."""
        frames = video(4)
        for motion in (False, True):
            dev = FvcEncoder(quality=85, motion=motion,
                             engine="device").encode_chunk(frames)
            host = FvcEncoder(quality=85, motion=motion,
                              engine="host").encode_chunk(frames)
            assert dev == host

    def test_corrupt_stream_raises(self):
        with pytest.raises(ValueError):
            FvcDecoder().decode_chunk(b"JUNKJUNKJUNKJUNK")


class TestFvcMotion:
    """FVC v2 — motion-compensated hybrid mode."""

    def test_roundtrip_psnr(self):
        frames = video(6)
        enc = FvcEncoder(quality=90, motion=True)
        chunk = enc.encode_chunk(frames)
        assert chunk[4] == 2  # version byte
        dec, info = FvcDecoder().decode_chunk(chunk)
        assert dec.shape == frames.shape
        assert info["types"] == [0, 1, 1, 1, 1, 1]
        for i in range(len(frames)):
            assert psnr(frames[i], dec[i]) > 30, f"frame {i}"

    def test_motion_beats_v1_on_moving_content(self):
        """A translating ball is exactly what MC prediction wins on: v2
        P frames should be materially smaller than v1's DCT-delta frames."""
        frames = video(8, w=96, h=64)
        v1 = len(FvcEncoder(quality=85).encode_chunk(frames))
        v2 = len(FvcEncoder(quality=85, motion=True).encode_chunk(frames))
        assert v2 < v1, (v2, v1)

    def test_no_drift_on_static_content(self):
        frames = np.repeat(video(1, pattern="gradient"), 8, axis=0)
        dec, _ = FvcDecoder().decode_chunk(
            FvcEncoder(quality=85, motion=True).encode_chunk(frames))
        for i in range(1, 8):
            np.testing.assert_array_equal(dec[i], dec[0])

    def test_decode_stream_mixed_versions(self):
        frames = video(8)
        v1 = FvcEncoder(quality=85).encode_chunk(frames[:4])
        v2 = FvcEncoder(quality=85, motion=True).encode_chunk(frames[4:])
        dec = FvcDecoder().decode_stream(v1 + v2)
        assert dec.shape == frames.shape
        assert psnr(frames[6], dec[6]) > 30

    def test_motion_requires_420(self):
        with pytest.raises(ValueError):
            FvcEncoder(motion=True, subsample=False).encode_chunk(video(2))

    @pytest.mark.slow
    def test_device_decode_matches_numpy_mirror(self):
        """The jitted decode scan and the numpy reference reconstruction
        must agree (both mirror the encoder's in-loop state)."""
        import jax.numpy as jnp
        from flutpu.codec.fvc import (FvcDecoder, _pad_to, LUMA_QTABLE,
                                      CHROMA_QTABLE, scale_qtable)
        frames = video(5, w=96, h=64)
        chunk = FvcEncoder(quality=85, motion=True,
                           search_range=5).encode_chunk(frames)
        dec = FvcDecoder()
        dev, _ = dec.decode_chunk(chunk)
        # replay the parse, then reconstruct via the numpy mirror
        import struct
        _, flags, w, h, quality, f = struct.unpack(">BBHHBB", chunk[4:12])
        sr = chunk[12]
        ph, pw = _pad_to(h, 16), _pad_to(w, 16)
        from flutpu.codec.decode import decode_scan_to_coefs
        off, planes, mvs = 13, [], []
        for i in range(f):
            ftype, mv_len, plen = struct.unpack(">BHI", chunk[off:off + 7])
            off += 7
            mv = None
            if mv_len:
                import zlib
                raw = zlib.decompress(chunk[off:off + mv_len]) \
                    if flags & 2 else chunk[off:off + mv_len]
                mv = np.frombuffer(raw, np.int8).reshape(
                    ph // 16, pw // 16, 2)
                off += mv_len
            mvs.append(mv)
            planes.append(decode_scan_to_coefs(chunk[off:off + plen],
                                               pw // 8, ph // 8,
                                               pw // 16, ph // 16, True))
            off += plen
        qy = jnp.asarray(scale_qtable(LUMA_QTABLE, quality))
        qc = jnp.asarray(scale_qtable(CHROMA_QTABLE, quality))
        ref = dec._reconstruct_mc_np(planes, mvs, qy, qc, h, w,
                                     subpel=bool(flags & 4),
                                     planar=bool(flags & 8))
        for i in range(f):
            diff = np.abs(dev[i].astype(int) - ref[i].astype(int))
            assert diff.max() <= 1, (i, diff.max())  # f32 vs f64 rounding

    def test_element_motion_property(self):
        h = Harness("fvcenc quality=90 gop-size=4 motion=true")
        h.set_src_caps(TestFvcElement.CAPS)
        frames = video(4)
        for i, f in enumerate(frames):
            h.push(Buffer(f, pts=i * MSECOND, duration=MSECOND, offset=i))
        h.push_eos()
        chunk = bytes(h.pull(timeout=30).data)
        h.teardown()
        assert chunk[4] == 2
        dec, _ = FvcDecoder().decode_chunk(chunk)
        assert psnr(frames[3], dec[3]) > 30


class TestFvcElement:
    CAPS = "video/x-raw, format=RGB, width=64, height=48, framerate=30/1"

    def test_standalone(self):
        h = Harness("fvcenc quality=90 gop-size=4")
        h.set_src_caps(self.CAPS)
        frames = video(8)
        for i, f in enumerate(frames):
            h.push(Buffer(f, pts=i * MSECOND, duration=MSECOND, offset=i))
        h.push_eos()
        chunks = [h.pull(timeout=20) for _ in range(2)]
        data = b"".join(bytes(c.data) for c in chunks)
        dec = FvcDecoder().decode_stream(data)
        assert dec.shape == frames.shape
        assert psnr(frames[5], dec[5]) > 30

    def test_inside_hype(self):
        """Chunk-parallel FVC: scene events bound chunks; every chunk is
        independently decodable; stitched stream reconstructs in order."""
        h = Harness("hype gop-size=4 encoder-1=fvcenc encoder-2=fvcenc")
        h.set_src_caps(self.CAPS)
        frames = video(12)
        for i, f in enumerate(frames):
            h.push(Buffer(f, pts=i * MSECOND, duration=MSECOND, offset=i))
        h.push_eos()
        chunks = []
        while True:
            b = h.try_pull(timeout=10)
            if b is None:
                break
            chunks.append(b)
        h.teardown()
        assert [c.pts for c in chunks] == sorted(c.pts for c in chunks)
        dec = FvcDecoder().decode_stream(b"".join(bytes(c.data) for c in chunks))
        assert dec.shape == frames.shape
        for i in (0, 5, 11):
            assert psnr(frames[i], dec[i]) > 30, f"frame {i}"


class TestFvcRateControl:
    @pytest.mark.slow
    def test_bitrate_converges(self):
        """Per-chunk controller steers chunk sizes toward the budget."""
        from flutpu.codec.fvc import FvcEnc
        h = Harness("fvcenc gop-size=4 bitrate=600000")  # 600 kbit/s
        h.set_src_caps(TestFvcElement.CAPS)
        frames = video(24, w=128, h=96)
        for i, f in enumerate(frames):
            h.push(Buffer(f, pts=i * 33 * MSECOND,
                          duration=33 * MSECOND, offset=i))
        h.push_eos()
        sizes = []
        while True:
            b = h.try_pull(timeout=20)
            if b is None:
                break
            sizes.append(len(bytes(b.data)))
        h.teardown()
        assert len(sizes) == 6
        # budget per 4-frame chunk at 600 kbit/s, 33 ms frames: ~9.9 KB
        target = 600000 / 8 * (4 * 0.033)
        # later chunks (post-adaptation) land within 2x of budget
        for s in sizes[2:]:
            assert s < target * 2, (s, target, sizes)

    def test_bitrate_zero_is_constant_quality(self):
        enc_sizes = []
        for br in (0,):
            h = Harness("fvcenc gop-size=4 bitrate=0 quality=90")
            h.set_src_caps(TestFvcElement.CAPS)
            for i, f in enumerate(video(4)):
                h.push(Buffer(f, pts=i * MSECOND, duration=MSECOND, offset=i))
            h.push_eos()
            b = h.pull(timeout=20)
            enc_sizes.append(len(bytes(b.data)))
            assert bytes(b.data)[10] == 90  # quality byte preserved
            h.teardown()


def test_motion_compensate_gather_equals_rolls():
    """The single-gather prediction is bit-identical to per-macroblock
    np.roll (the decoder's numpy mirror), luma and chroma grids."""
    import jax.numpy as jnp
    from flutpu.codec.fvc import _mc_np
    from flutpu.codec.ops.motion import motion_compensate
    rng = np.random.default_rng(3)
    mv_np = rng.integers(-7, 8, (4, 6, 2)).astype(np.int32)
    mv = jnp.asarray(mv_np)
    luma = rng.random((64, 96)).astype(np.float32)
    chroma = rng.random((32, 48)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(motion_compensate(jnp.asarray(luma), mv,
                                     search_range=7)),
        _mc_np(luma, mv_np, 16, chroma=False))
    np.testing.assert_array_equal(
        np.asarray(motion_compensate(jnp.asarray(chroma), mv,
                                     search_range=7, mb=8)),
        _mc_np(chroma, mv_np, 8, chroma=True))


@pytest.mark.slow
def test_hier_search_mode_roundtrips():
    """Coarse-to-fine search produces a valid v2 stream with near-full
    compression on moving content."""
    frames = video(6, w=96, h=64)
    full = FvcEncoder(quality=88, motion=True).encode_chunk(frames)
    hier = FvcEncoder(quality=88, motion=True, hier=True).encode_chunk(frames)
    dec, _ = FvcDecoder().decode_chunk(hier)
    for i in range(6):
        assert psnr(frames[i], dec[i]) > 30, i
    assert len(hier) < len(full) * 1.25, (len(hier), len(full))


@pytest.mark.slow
def test_decode_stream_parallel_matches_serial():
    """Chunk-concurrent decode must equal serial decode exactly (chunks
    are independent; order preserved)."""
    frames = video(12, w=96, h=64)
    enc = FvcEncoder(quality=85, motion=True)
    data = b"".join(enc.encode_chunk(frames[i:i + 3]) for i in (0, 3, 6, 9))
    dec = FvcDecoder()
    par = dec.decode_stream(data, parallel=True)
    ser = dec.decode_stream(data, parallel=False)
    np.testing.assert_array_equal(par, ser)
    assert par.shape == frames.shape


def test_v1_444_roundtrip():
    """FVC v1 without chroma subsampling (flags bit0 = 0)."""
    frames = video(4, w=64, h=48)
    chunk = FvcEncoder(quality=90, subsample=False).encode_chunk(frames)
    assert chunk[5] & 1 == 0  # flags byte
    dec, _ = FvcDecoder().decode_chunk(chunk)
    for i in range(4):
        assert psnr(frames[i], dec[i]) > 32, i


def test_mid_chunk_scene_cut_gets_i_frame():
    """Content that hard-cuts inside a chunk: the mode decision codes the
    cut frame as I (flat prediction beats motion from the dead scene) and
    quality holds across the cut."""
    a = video(4, w=96, h=64, pattern="ball")
    b = np.stack([make_test_frame("gradient", 96, 64, 40 + i)
                  for i in range(4)])
    frames = np.concatenate([a, 255 - b], axis=0)  # hard cut at frame 4
    chunk = FvcEncoder(quality=88, motion=True).encode_chunk(frames)
    dec, info = FvcDecoder().decode_chunk(chunk)
    assert info["types"][0] == 0
    assert info["types"][4] == 0, info["types"]  # the cut became an I frame
    assert all(t == 1 for t in info["types"][1:4])
    for i in (3, 4, 7):
        assert psnr(frames[i], dec[i]) > 30, i


@pytest.mark.slow
def test_quality_monotonic_size_and_psnr():
    """Higher quality → larger chunks and better reconstruction, for both
    FVC modes (the quality knob must actually steer the RD point)."""
    frames = video(4, w=96, h=64)
    for motion in (False, True):
        sizes, quals = [], []
        for q in (30, 60, 90):
            enc = FvcEncoder(quality=q, motion=motion)
            chunk = enc.encode_chunk(frames)
            dec, _ = FvcDecoder().decode_chunk(chunk)
            sizes.append(len(chunk))
            quals.append(np.mean([psnr(frames[i], dec[i])
                                  for i in range(4)]))
        assert sizes[0] < sizes[1] < sizes[2], (motion, sizes)
        assert quals[0] < quals[1] < quals[2], (motion, quals)


@pytest.mark.slow
def test_halfpel_beats_integer_on_fractional_motion():
    """Content translating by half-pixel steps: half-pel compensation must
    shrink the residual payload vs integer-only vectors."""
    rng = np.random.default_rng(12)
    base = rng.random((64, 96)).astype(np.float32) * 200 + 20
    frames = []
    for i in range(6):
        hp = i * 3  # 1.5 px/frame: alternates integer / half-pel positions
        ip, frac = hp // 2, hp % 2
        img = np.roll(base, (0, ip), (0, 1))
        if frac:
            img = 0.5 * (img + np.roll(base, (0, ip + 1), (0, 1)))
        frames.append(np.repeat(img[..., None], 3, axis=2).astype(np.uint8))
    frames = np.stack(frames)
    sub = FvcEncoder(quality=88, motion=True, subpel=True)
    intg = FvcEncoder(quality=88, motion=True, subpel=False)
    s_len = len(sub.encode_chunk(frames))
    i_len = len(intg.encode_chunk(frames))
    assert s_len < i_len, (s_len, i_len)
    dec, _ = FvcDecoder().decode_chunk(sub.encode_chunk(frames))
    assert psnr(frames[5], dec[5]) > 30


def test_search_range_bounds_validated():
    """Vectors are int8 in the bitstream (half-pel units under subpel):
    out-of-range search_range must raise instead of silently wrapping."""
    import pytest
    from flutpu.codec.fvc import FvcEncoder

    FvcEncoder(motion=True, search_range=62, subpel=True)
    FvcEncoder(motion=True, search_range=126, subpel=False)
    with pytest.raises(ValueError):
        FvcEncoder(motion=True, search_range=63, subpel=True)
    with pytest.raises(ValueError):
        FvcEncoder(motion=True, search_range=127, subpel=False)
    with pytest.raises(ValueError):
        FvcEncoder(motion=True, search_range=0)


def test_pipelined_dispatch_matches_sync_encode():
    """Two chunks in flight through the async API produce the same bytes
    as sequential encode_chunk calls (shared adaptive state included)."""
    from flutpu.codec.fvc import FvcEncoder
    rng = np.random.default_rng(5)
    chunks = [np.clip(rng.normal(128, 40, (4, 48, 64, 3)), 0, 255)
              .astype(np.uint8) for _ in range(3)]

    sync = FvcEncoder(quality=85, engine="auto")
    expect = [sync.encode_chunk(c) for c in chunks]

    enc = FvcEncoder(quality=85, engine="auto")
    pending = []
    got = []
    for c in chunks:
        pending.append(enc.encode_chunk_dispatch(c))
        if len(pending) > 1:
            got.append(enc.encode_chunk_finalize(pending.pop(0)))
    while pending:
        got.append(enc.encode_chunk_finalize(pending.pop(0)))
    assert got == expect


@pytest.mark.slow
def test_src_fused_dispatch_matches_array_dispatch():
    """encode_chunk_dispatch_src (on-device source fused into the GOP
    program — the config-5/6 bench shape) produces byte-identical chunks
    to dispatching the same frames as an array."""
    import jax.numpy as jnp
    from flutpu.codec.fvc import FvcEncoder
    from flutpu.codec.ops.testsrc import gradient_ball_frames

    for motion in (False, True):
        ref = FvcEncoder(quality=85, motion=motion, engine="auto")
        frames = np.asarray(gradient_ball_frames(48, 128, 4,
                                                 jnp.float32(3.0)))
        expect = ref.encode_chunk(frames)
        enc = FvcEncoder(quality=85, motion=motion, engine="auto")
        got = enc.encode_chunk_finalize(enc.encode_chunk_dispatch_src(
            gradient_ball_frames, jnp.float32(3.0), 4, 48, 128))
        assert got == expect, f"motion={motion}"


def test_jpeg_src_fused_dispatch_matches_array_dispatch():
    import jax.numpy as jnp
    from flutpu.codec.jpeg import JpegEncoder
    from flutpu.codec.ops.testsrc import gradient_ball_frames

    def src8(ph, pw, start):
        return gradient_ball_frames(ph, pw, 4, start)

    ph, pw = 48, 128
    frames = gradient_ball_frames(ph, pw, 4, jnp.float32(2.0))
    ov = np.zeros((ph, pw, 4), np.uint8)
    ov[30:40, :, :] = (40, 40, 40, 200)
    ov = jnp.asarray(ov)
    ref = JpegEncoder(quality=85)
    expect = ref.encode_gop_finalize(
        ref.encode_gop_dispatch(frames, ph, pw, overlay=ov))
    enc = JpegEncoder(quality=85)
    got = enc.encode_gop_finalize(enc.encode_gop_dispatch_src(
        src8, jnp.float32(2.0), ph, pw, ph, pw, overlay=ov))
    assert got == expect


def test_planar_recon_flag_travels_and_decoder_follows_it():
    """The in-loop DCT formulation is codec state (ADVICE r2): an encoder
    using the planar formulation flags it in the header (bit 3) and the
    decoder reconstructs through the SAME formulation regardless of its
    own backend — no P-chain drift across backends."""
    import jax.numpy as jnp
    from flutpu.codec.ops.testsrc import gradient_ball_frames
    frames = np.asarray(gradient_ball_frames(48, 64, 6, jnp.float32(0)))

    enc = FvcEncoder(quality=85, motion=True)
    enc.planar = True   # what a planar-formulation encoder records
    chunk = enc.encode_chunk(frames)
    assert chunk[5] & 8, "flags bit 3 (planar recon) must be set"

    dec = FvcDecoder()
    right, _ = dec.decode_chunk(chunk)          # follows the flag
    # decode the same payload with the flag cleared: the decoder then
    # reconstructs through the 8x8-einsum formulation the encoder did NOT
    # use — the cross-backend mismatch this header bit exists to prevent
    wrong_chunk = chunk[:5] + bytes([chunk[5] & ~8]) + chunk[6:]
    wrong, _ = dec.decode_chunk(wrong_chunk)
    p_right = psnr(frames, right)
    p_wrong = psnr(frames, wrong)

    # matched-formulation quality: within 0.5 dB of a fully-CPU
    # (non-planar) encode/decode pair of the same content
    enc2 = FvcEncoder(quality=85, motion=True)
    enc2.planar = False
    chunk2 = enc2.encode_chunk(frames)
    assert not chunk2[5] & 8
    base, _ = dec.decode_chunk(chunk2)
    p_base = psnr(frames, base)
    assert p_right >= p_base - 0.5
    # the mismatched decode can only be as good or worse
    assert p_right >= p_wrong - 1e-6


class TestSegmentedLayout:
    """Round-4 segment bitstream layout through the FVC encoder: chunks
    must be byte-identical to the block-concat layout (the segment
    compaction reproduces the exact scan bytes) for both v1 and motion
    mode, and survive the capacity-overflow growth path."""

    def test_v1_segmented_byte_identical(self):
        frames = video(4)
        std = FvcEncoder(quality=85)
        seg = FvcEncoder(quality=85)
        seg._scan_coder.segmented = True
        assert std.encode_chunk(frames) == seg.encode_chunk(frames)

    def test_motion_segmented_byte_identical(self):
        frames = np.stack([np.asarray(f) for f in video(4)])
        std = FvcEncoder(quality=85, motion=True)
        seg = FvcEncoder(quality=85, motion=True)
        seg._scan_coder.segmented = True
        assert std.encode_chunk(frames) == seg.encode_chunk(frames)

    @pytest.mark.slow
    def test_segmented_capacity_overflow_grows(self):
        frames = (np.random.default_rng(7)
                  .integers(0, 256, size=(2, 32, 32, 3)).astype(np.uint8))
        std = FvcEncoder(quality=97)
        seg = FvcEncoder(quality=97)
        seg._scan_coder.segmented = True
        seg._scan_coder._seg_words = 8
        assert std.encode_chunk(frames) == seg.encode_chunk(frames)
        assert seg._scan_coder._seg_words > 8


class TestPlanarSourcePath:
    """Channel-planar device path: sources/pipelines that carry
    (r, g, b) planes instead of interleaved (F, H, W, 3) frames. All
    planar formulations must be BYTE-identical to the interleaved ones."""

    def test_planes_src_matches_interleaved_src(self):
        import jax.numpy as jnp
        from flutpu.codec.ops.testsrc import (gradient_ball_frames,
                                              gradient_ball_planes)
        frames = np.asarray(gradient_ball_frames(48, 128, 4,
                                                 jnp.float32(3.0)))
        r, g, b = (np.asarray(p) for p in
                   gradient_ball_planes(48, 128, 4, jnp.float32(3.0)))
        assert np.array_equal(frames[..., 0], r)
        assert np.array_equal(frames[..., 1], g)
        assert np.array_equal(frames[..., 2], b)

    def test_planes_to_i420_bit_identical(self):
        import jax.numpy as jnp
        from flutpu.codec.ops.colorspace import planes_to_i420, rgb_to_i420
        rng = np.random.default_rng(3)
        rgb = rng.integers(0, 256, size=(2, 32, 64, 3)).astype(np.uint8)
        y0, cb0, cr0 = rgb_to_i420(jnp.asarray(rgb).astype(jnp.float32))
        y1, cb1, cr1 = planes_to_i420(jnp.asarray(rgb[..., 0]),
                                      jnp.asarray(rgb[..., 1]),
                                      jnp.asarray(rgb[..., 2]))
        assert np.array_equal(np.asarray(y0), np.asarray(y1))
        assert np.array_equal(np.asarray(cb0), np.asarray(cb1))
        assert np.array_equal(np.asarray(cr0), np.asarray(cr1))

    def test_encode_gop_planes_to_coefs_bit_identical(self):
        import jax.numpy as jnp
        from flutpu.codec.jpeg import (encode_gop_planes_to_coefs,
                                       encode_gop_to_coefs)
        from flutpu.codec.ops.quant import (CHROMA_QTABLE, LUMA_QTABLE,
                                            scale_qtable)
        rng = np.random.default_rng(5)
        rgb = rng.integers(0, 256, size=(2, 30, 60, 3)).astype(np.uint8)
        qy = jnp.asarray(scale_qtable(LUMA_QTABLE, 85))
        qc = jnp.asarray(scale_qtable(CHROMA_QTABLE, 85))
        for subsample in (True, False):
            a = encode_gop_to_coefs(jnp.asarray(rgb), qy, qc, pad_h=32,
                                    pad_w=64, subsample=subsample)
            p = encode_gop_planes_to_coefs(
                jnp.asarray(rgb[..., 0]), jnp.asarray(rgb[..., 1]),
                jnp.asarray(rgb[..., 2]), qy, qc, pad_h=32, pad_w=64,
                subsample=subsample)
            for x, y in zip(a, p):
                assert np.array_equal(np.asarray(x), np.asarray(y))

    def test_overlay_on_planes_bit_identical(self):
        from flutpu.ttml.render import overlay_on_frames, overlay_on_planes
        import jax.numpy as jnp
        rng = np.random.default_rng(9)
        frames = rng.integers(0, 256, size=(3, 24, 40, 3)).astype(np.uint8)
        ov = rng.integers(0, 256, size=(24, 40, 4)).astype(np.uint8)
        want = np.asarray(overlay_on_frames(jnp.asarray(frames),
                                            jnp.asarray(ov)))
        r, g, b = overlay_on_planes(jnp.asarray(frames[..., 0]),
                                    jnp.asarray(frames[..., 1]),
                                    jnp.asarray(frames[..., 2]),
                                    jnp.asarray(ov))
        got = np.stack([np.asarray(r), np.asarray(g), np.asarray(b)],
                       axis=-1)
        assert np.array_equal(want, got)

    @pytest.mark.slow
    def test_jpeg_planar_src_dispatch_byte_identical(self):
        import jax.numpy as jnp
        from flutpu.codec.jpeg import JpegEncoder
        from flutpu.codec.ops.testsrc import (gradient_ball_frames,
                                              gradient_ball_planes)

        ph, pw = 48, 128
        ov = np.zeros((ph, pw, 4), np.uint8)
        ov[30:40, :, :] = (40, 40, 40, 200)
        ov = jnp.asarray(ov)

        def src_i(ph_, pw_, start):
            return gradient_ball_frames(ph_, pw_, 4, start)

        def src_p(ph_, pw_, start):
            return gradient_ball_planes(ph_, pw_, 4, start)

        for overlay in (None, ov):
            ref = JpegEncoder(quality=85)
            expect = ref.encode_gop_finalize(ref.encode_gop_dispatch_src(
                src_i, jnp.float32(2.0), ph, pw, ph, pw, overlay=overlay))
            enc = JpegEncoder(quality=85)
            got = enc.encode_gop_finalize(enc.encode_gop_dispatch_src(
                src_p, jnp.float32(2.0), ph, pw, ph, pw, overlay=overlay))
            assert got == expect, f"overlay={overlay is not None}"

    def test_fvc_planar_src_dispatch_byte_identical(self):
        import jax.numpy as jnp
        from flutpu.codec.ops.testsrc import (gradient_ball_frames,
                                              gradient_ball_planes)

        def src_p(ph, pw, n, start):
            return gradient_ball_planes(ph, pw, n, start)

        for motion in (False, True):
            ref = FvcEncoder(quality=85, motion=motion)
            expect = ref.encode_chunk_finalize(ref.encode_chunk_dispatch_src(
                gradient_ball_frames, jnp.float32(3.0), 4, 48, 128))
            enc = FvcEncoder(quality=85, motion=motion)
            got = enc.encode_chunk_finalize(enc.encode_chunk_dispatch_src(
                src_p, jnp.float32(3.0), 4, 48, 128))
            assert got == expect, f"motion={motion}"

    def test_planar_src_overflow_fallback(self):
        """The rare cap-ladder fallback re-synthesizes frames from a
        PLANAR src (stacks the planes) and still matches the interleaved
        encoder byte for byte."""
        import jax.numpy as jnp
        from flutpu.codec.jpeg import JpegEncoder
        from flutpu.codec.ops.testsrc import (gradient_ball_frames,
                                              gradient_ball_planes)

        ph, pw = 32, 64

        def src_p(ph_, pw_, start):
            return gradient_ball_planes(ph_, pw_, 2, start)

        def src_i(ph_, pw_, start):
            return gradient_ball_frames(ph_, pw_, 2, start)

        ref = JpegEncoder(quality=85)
        expect = ref.encode_gop_finalize(ref.encode_gop_dispatch_src(
            src_i, jnp.float32(0.0), ph, pw, ph, pw))
        enc = JpegEncoder(quality=85)
        # force the overflow path: a 1-word window cannot hold any scan
        enc._prefix_used_words = 1
        enc._prefix_window = 1
        handle = enc.encode_gop_dispatch_src(src_p, jnp.float32(0.0),
                                             ph, pw, ph, pw)
        got = enc.encode_gop_finalize(handle)
        assert got == expect


class TestBatchedChunkDispatch:
    """Round 5: B independent chunks per device dispatch (one RTT + one
    fetch per B*n frames). Streams must be byte-identical to separate
    dispatches — chunks stay independently decodable."""

    def test_v1_batch_matches_singles(self):
        import jax.numpy as jnp
        from flutpu.codec.ops.testsrc import gradient_ball_planes

        def src(ph, pw, n, start):
            return gradient_ball_planes(ph, pw, n, start)

        enc = FvcEncoder(quality=85)
        singles = []
        for b in range(2):
            h = enc.encode_chunk_dispatch_src(src, jnp.float32(b * 4),
                                              4, 48, 64)
            singles.append(enc.encode_chunk_finalize(h))
        enc2 = FvcEncoder(quality=85)
        hb = enc2.encode_chunk_batch_dispatch_src(src, jnp.float32(0),
                                                  4, 48, 64, batch=2)
        batched = enc2.encode_chunk_batch_finalize(hb)
        assert batched == singles
        dec, _ = FvcDecoder().decode_chunk(batched[1])
        assert dec.shape == (4, 48, 64, 3)

    @pytest.mark.slow
    def test_motion_and_bframes_batch_match_singles(self):
        import jax.numpy as jnp
        from flutpu.codec.ops.testsrc import gradient_ball_planes

        def src(ph, pw, n, start):
            return gradient_ball_planes(ph, pw, n, start)

        for kw in (dict(motion=True), dict(motion=True, bframes=1)):
            enc = FvcEncoder(quality=85, **kw)
            singles = []
            for b in range(2):
                h = enc.encode_chunk_dispatch_src(src, jnp.float32(b * 8),
                                                  8, 64, 128)
                singles.append(enc.encode_chunk_finalize(h))
            enc2 = FvcEncoder(quality=85, **kw)
            hb = enc2.encode_chunk_batch_dispatch_src(
                src, jnp.float32(0), 8, 64, 128, batch=2)
            assert enc2.encode_chunk_batch_finalize(hb) == singles
