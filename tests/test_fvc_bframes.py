"""FVC B-frame tests (v2 header flags bit 5): bidirectional prediction
from reconstructed anchor pairs, per-macroblock modes, parallel B pass.

The reference delegates encoding to x264 (which owns B-frames there,
/root/reference/hype/README.md pipelines); this is the framework-native
equivalent on the FVC codec. B frames are non-reference, so the encode
is a lax.scan over anchors plus ONE parallel pass over every B frame —
the device-shaped formulation (no sequential dependency, no extra carry).
"""

import struct
import zlib

import numpy as np
import pytest

from flutpu.codec.fvc import (FvcDecoder, FvcEncoder, MAGIC,
                              _bframe_structure, _pad_to)
from flutpu.codec.jpeg import psnr
from flutpu.core import Buffer, Harness, MSECOND
from flutpu.core.elements import make_test_frame


def video(n, w=64, h=48, pattern="ball"):
    return np.stack([make_test_frame(pattern, w, h, i) for i in range(n)])


class TestBframeStructure:
    def test_pattern(self):
        assert _bframe_structure(8, 1) == ([0, 2, 4, 6, 7], [1, 3, 5],
                                           [0, 1, 2], [1, 2, 3])
        a, b, pm, nm = _bframe_structure(8, 2)
        assert a == [0, 3, 6, 7] and b == [1, 2, 4, 5]
        assert pm == [0, 0, 1, 1] and nm == [1, 1, 2, 2]

    def test_edges(self):
        assert _bframe_structure(1, 3) == ([0], [], [], [])
        assert _bframe_structure(2, 3) == ([0, 1], [], [], [])
        # bframes larger than the chunk: one B between the two anchors
        assert _bframe_structure(3, 7) == ([0, 2], [1], [0], [1])

    def test_every_b_has_surrounding_anchors(self):
        for f in range(1, 17):
            for bf in range(1, 5):
                a, b, pm, nm = _bframe_structure(f, bf)
                assert a[0] == 0 and a[-1] == f - 1
                assert sorted(a + b) == list(range(f))
                for j, p, n in zip(b, pm, nm):
                    assert a[p] < j < a[n]


class TestBframeRoundtrip:
    def test_types_and_psnr(self):
        frames = video(8)
        enc = FvcEncoder(quality=90, motion=True, bframes=1)
        chunk = enc.encode_chunk(frames)
        assert chunk[:4] == MAGIC
        assert chunk[5] & 32  # flags bit 5
        dec, info = FvcDecoder().decode_chunk(chunk)
        assert dec.shape == frames.shape
        # anchors at 0,2,4,6,7; B at 1,3,5 (anchor 0 is I, rest content-
        # decided P/I; every odd-slot frame must be type 2)
        assert [info["types"][i] for i in (1, 3, 5)] == [2, 2, 2]
        assert info["types"][0] == 0
        assert all(info["types"][i] != 2 for i in (0, 2, 4, 6, 7))
        for i in range(len(frames)):
            assert psnr(frames[i], dec[i]) > 30, f"frame {i}"

    def test_b_beats_p_only_on_noisy_motion(self):
        """The rate case B frames exist for: on noisy moving content the
        bidirectional average denoises the prediction and the non-
        reference B quantizer offset (bquality) spends fewer bits where
        errors cannot propagate. The stream must shrink at near-equal
        quality. (On noise-free synthetic content where single-frame P
        prediction is already near-perfect, the doubled anchor spacing
        costs more than B saves — a content tradeoff, not a bug; the
        default stays bframes=0.)"""
        rng = np.random.default_rng(7)
        base = video(8, w=96, h=64).astype(np.int16)
        frames = np.clip(base + rng.normal(0, 6, base.shape),
                         0, 255).astype(np.uint8)
        p_chunk = FvcEncoder(quality=85, motion=True).encode_chunk(frames)
        b_chunk = FvcEncoder(quality=85, motion=True,
                             bframes=2).encode_chunk(frames)
        assert len(b_chunk) < len(p_chunk), (len(b_chunk), len(p_chunk))
        p_dec, _ = FvcDecoder().decode_chunk(p_chunk)
        b_dec, _ = FvcDecoder().decode_chunk(b_chunk)
        p_psnr = np.mean([psnr(frames[i], p_dec[i]) for i in range(8)])
        b_psnr = np.mean([psnr(frames[i], b_dec[i]) for i in range(8)])
        assert b_psnr > p_psnr - 0.5, (b_psnr, p_psnr)

    def test_bquality_byte_travels(self):
        frames = video(6)
        chunk = FvcEncoder(quality=85, motion=True, bframes=1,
                           bquality=60).encode_chunk(frames)
        assert chunk[13] == 60
        dec, _ = FvcDecoder().decode_chunk(chunk)  # decodes cleanly
        default = FvcEncoder(quality=85, motion=True,
                             bframes=1).encode_chunk(frames)
        assert default[13] == 85 - 8  # auto offset
        # coarser B quantizer → smaller stream
        assert len(chunk) < len(default)

    def test_engines_bit_identical(self):
        frames = video(7)
        kw = dict(quality=85, motion=True, bframes=2)
        dev = FvcEncoder(engine="device", **kw).encode_chunk(frames)
        host = FvcEncoder(engine="host", **kw).encode_chunk(frames)
        assert dev == host

    def test_segmented_layout_byte_identical(self):
        frames = video(6)
        kw = dict(quality=85, motion=True, bframes=1, engine="device")
        base = FvcEncoder(segmented=False, **kw).encode_chunk(frames)
        seg = FvcEncoder(segmented=True, **kw).encode_chunk(frames)
        assert base == seg

    def test_pipelined_dispatch_matches_sync(self):
        frames = video(6)
        enc = FvcEncoder(quality=85, motion=True, bframes=1)
        sync = enc.encode_chunk(frames)
        h = enc.encode_chunk_dispatch(frames)
        assert enc.encode_chunk_finalize(h) == sync

    def test_validation(self):
        with pytest.raises(ValueError):
            FvcEncoder(motion=False, bframes=1)
        with pytest.raises(ValueError):
            FvcEncoder(motion=True, subpel=True, bframes=1)
        with pytest.raises(ValueError):
            FvcEncoder(motion=True, bframes=99)

    def test_single_frame_chunk(self):
        frames = video(1)
        chunk = FvcEncoder(quality=85, motion=True,
                           bframes=2).encode_chunk(frames)
        dec, info = FvcDecoder().decode_chunk(chunk)
        assert info["types"] == [0]
        assert psnr(frames[0], dec[0]) > 30

    @pytest.mark.slow
    def test_stitch_and_split_stream(self):
        frames = video(12, w=96, h=64)
        enc = FvcEncoder(quality=85, motion=True, bframes=1)
        c1 = enc.encode_chunk(frames[:6])
        c2 = enc.encode_chunk(frames[6:])
        dec = FvcDecoder()
        parts = dec.split_stream(c1 + c2)
        assert parts == [c1, c2]
        out = dec.decode_stream(c1 + c2)
        assert out.shape == frames.shape
        assert psnr(frames[8], out[8]) > 30


class TestBframeDecoder:
    def _parse(self, chunk):
        _, flags, w, h, quality, f = struct.unpack(">BBHHBB", chunk[4:12])
        sr = chunk[12]
        ph, pw = _pad_to(h, 16), _pad_to(w, 16)
        mbn = (ph // 16) * (pw // 16)
        from flutpu.codec.decode import decode_scan_to_coefs
        off = 13
        bquality = quality
        if flags & 32:
            bquality = chunk[off]
            off += 1
        planes, mvs, types = [], [], []
        for i in range(f):
            ftype, mv_len, plen = struct.unpack(">BHI", chunk[off:off + 7])
            off += 7
            mv = None
            if mv_len:
                raw = zlib.decompress(chunk[off:off + mv_len])
                b8 = np.frombuffer(raw, np.int8)
                if ftype == 2:
                    mv = (b8[:mbn * 2].reshape(ph // 16, pw // 16, 2),
                          b8[mbn * 2:mbn * 4].reshape(ph // 16, pw // 16, 2),
                          b8[mbn * 4:].reshape(ph // 16, pw // 16))
                else:
                    mv = b8.reshape(ph // 16, pw // 16, 2)
                off += mv_len
            mvs.append(mv)
            types.append(ftype)
            planes.append(decode_scan_to_coefs(chunk[off:off + plen],
                                               pw // 8, ph // 8,
                                               pw // 16, ph // 16, True))
            off += plen
        return flags, w, h, quality, bquality, sr, planes, mvs, types

    def test_device_decode_matches_numpy_mirror(self):
        import jax.numpy as jnp
        from flutpu.codec.fvc import (CHROMA_QTABLE, LUMA_QTABLE,
                                      scale_qtable)
        frames = video(7, w=96, h=64)
        chunk = FvcEncoder(quality=85, motion=True, bframes=1,
                           search_range=5).encode_chunk(frames)
        dec = FvcDecoder()
        dev, _ = dec.decode_chunk(chunk)
        (flags, w, h, quality, bquality, sr, planes, mvs,
         types) = self._parse(chunk)
        assert 2 in types
        assert bquality == 85 - 8  # the default B-quality offset
        qy = jnp.asarray(scale_qtable(LUMA_QTABLE, quality))
        qc = jnp.asarray(scale_qtable(CHROMA_QTABLE, quality))
        ref = dec._reconstruct_mc_b_np(
            planes, mvs, types, qy, qc, h, w, search_range=sr,
            planar=bool(flags & 8),
            qy_b=jnp.asarray(scale_qtable(LUMA_QTABLE, bquality)),
            qc_b=jnp.asarray(scale_qtable(CHROMA_QTABLE, bquality)))
        for i in range(len(frames)):
            diff = np.abs(dev[i].astype(int) - ref[i].astype(int))
            assert diff.max() <= 1, (i, diff.max())  # f32 vs f64 rounding

    def test_truncated_b_motion_block_raises(self):
        frames = video(5)
        chunk = FvcEncoder(quality=85, motion=True,
                           bframes=1).encode_chunk(frames)
        # find the first B frame header and corrupt its mv block length
        off = 14  # 13 + the bit5 bquality byte
        for i in range(5):
            ftype, mv_len, plen = struct.unpack(">BHI", chunk[off:off + 7])
            if ftype == 2:
                bad = bytearray(chunk)
                # shrink the declared motion length mid-stream
                struct.pack_into(">H", bad, off + 1, 3)
                with pytest.raises(ValueError):
                    FvcDecoder().decode_chunk(bytes(bad))
                return
            off += 7 + mv_len + plen
        pytest.fail("no B frame found")

    def test_wrong_decompressed_mode_length_raises(self):
        """A B motion block whose decompressed size is the P-frame size
        (missing bwd/mode fields) must be rejected."""
        frames = video(5)
        chunk = FvcEncoder(quality=85, motion=True,
                           bframes=1).encode_chunk(frames)
        off = 14  # 13 + the bit5 bquality byte
        rebuilt = [chunk[:14]]
        patched = False
        for i in range(5):
            ftype, mv_len, plen = struct.unpack(">BHI", chunk[off:off + 7])
            blob = chunk[off + 7:off + 7 + mv_len]
            payload = chunk[off + 7 + mv_len:off + 7 + mv_len + plen]
            off += 7 + mv_len + plen
            if ftype == 2 and not patched:
                raw = zlib.decompress(blob)
                blob = zlib.compress(raw[:len(raw) // 5 * 2], 6)  # fwd only
                patched = True
            rebuilt.append(struct.pack(">BHI", ftype, len(blob), plen))
            rebuilt.append(blob)
            rebuilt.append(payload)
        assert patched
        with pytest.raises(ValueError):
            FvcDecoder().decode_chunk(b"".join(rebuilt))

    def test_b_frame_without_anchor_rejected(self):
        """A hostile stream whose LAST frame is type 2 (no following
        anchor) must be rejected, not crash."""
        frames = video(4)
        chunk = FvcEncoder(quality=85, motion=True,
                           bframes=1).encode_chunk(frames)
        # walk frames; flip the final frame's type to 2 with a valid blob
        (flags, w, h, quality, bquality, sr, planes, mvs,
         types) = self._parse(chunk)
        ph, pw = _pad_to(h, 16), _pad_to(w, 16)
        mbn = (ph // 16) * (pw // 16)
        off = 14  # 13 + the bit5 bquality byte
        offs = []
        for i in range(len(types)):
            offs.append(off)
            ftype, mv_len, plen = struct.unpack(">BHI", chunk[off:off + 7])
            off += 7 + mv_len + plen
        last = offs[-1]
        ftype, mv_len, plen = struct.unpack(">BHI", chunk[last:last + 7])
        blob = zlib.compress(bytes(mbn * 5), 6)
        bad = (chunk[:last]
               + struct.pack(">BHI", 2, len(blob), plen) + blob
               + chunk[last + 7 + mv_len:])
        with pytest.raises(ValueError):
            FvcDecoder().decode_chunk(bad)


class TestBframeElement:
    CAPS = "video/x-raw, format=RGB, width=64, height=48, framerate=30/1"

    def test_fvcdec_streams_b_chunks(self):
        """The streaming decoder element must walk the bit5 header
        extension when reassembling chunks from arbitrary byte blocks."""
        frames = video(6)
        chunk = FvcEncoder(quality=88, motion=True,
                           bframes=1).encode_chunk(frames)
        h = Harness("fvcdec")
        h.set_src_caps("video/x-fvc")
        # feed in awkward fragments to exercise the reassembly walk
        for i in range(0, len(chunk), 97):
            h.push(Buffer(chunk[i:i + 97], pts=0))
        h.push_eos()
        outs = []
        while (b := h.pull(timeout=30)) is not None:
            outs.append(np.asarray(b.data))
        h.teardown()
        assert len(outs) == 6
        for i in range(6):
            assert psnr(frames[i], outs[i]) > 30, f"frame {i}"

    def test_element_property(self):
        h = Harness("fvcenc quality=88 gop-size=6 motion=true bframes=1")
        h.set_src_caps(self.CAPS)
        frames = video(6)
        for i, f in enumerate(frames):
            h.push(Buffer(f, pts=i * MSECOND, duration=MSECOND, offset=i))
        h.push_eos()
        chunk = bytes(h.pull(timeout=30).data)
        h.teardown()
        assert chunk[4] == 2 and (chunk[5] & 32)
        dec, info = FvcDecoder().decode_chunk(chunk)
        assert 2 in info["types"]
        assert psnr(frames[3], dec[3]) > 30
