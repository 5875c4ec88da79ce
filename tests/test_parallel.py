"""Multi-device tests on the virtual 8-CPU mesh: sharded GOP encode matches
the single-device path bit-for-bit; tpuhype element produces ordered,
decodable output; graft entry points run."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from flutpu.codec.ops.quant import (CHROMA_QTABLE, LUMA_QTABLE, scale_qtable)
from flutpu.parallel.gop import encode_chunks_sharded, encode_chunks_single
from flutpu.parallel.mesh import (chunk_sharding, make_chunk_mesh,
                                  make_chunk_spatial_mesh)


@pytest.fixture(scope="module")
def qtabs():
    return (jnp.asarray(scale_qtable(LUMA_QTABLE, 85)),
            jnp.asarray(scale_qtable(CHROMA_QTABLE, 85)))


def rand_chunks(c, f, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(c, f, h, w, 3), dtype=np.uint8)


class TestShardedEncode:
    def test_matches_single_device(self, qtabs):
        qy, qc = qtabs
        chunks = rand_chunks(8, 2, 32, 32)
        mesh = make_chunk_mesh(8)
        sharded = encode_chunks_sharded(jnp.asarray(chunks), qy, qc, mesh=mesh)
        single = encode_chunks_single(jnp.asarray(chunks), qy, qc)
        for a, b in zip(sharded, single):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_spatial_mesh_matches(self, qtabs):
        qy, qc = qtabs
        chunks = rand_chunks(4, 2, 64, 32, seed=1)
        mesh = make_chunk_spatial_mesh(4, 2)
        sharded = encode_chunks_sharded(jnp.asarray(chunks), qy, qc,
                                        mesh=mesh, spatial=True)
        single = encode_chunks_single(jnp.asarray(chunks), qy, qc)
        for a, b in zip(sharded, single):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    @pytest.mark.slow
    def test_planar_input_matches_interleaved(self, qtabs):
        """Channel-planar sharded encode (the product upload layout) is
        bit-identical to the interleaved form, on both mesh shapes."""
        qy, qc = qtabs
        chunks = rand_chunks(8, 2, 32, 32, seed=2)
        mesh = make_chunk_mesh(8)
        planes = tuple(jnp.asarray(chunks[..., c]) for c in range(3))
        got = encode_chunks_sharded(planes, qy, qc, mesh=mesh)
        want = encode_chunks_sharded(jnp.asarray(chunks), qy, qc, mesh=mesh)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        chunks = rand_chunks(4, 2, 64, 32, seed=3)
        mesh = make_chunk_spatial_mesh(4, 2)
        planes = tuple(jnp.asarray(chunks[..., c]) for c in range(3))
        got = encode_chunks_sharded(planes, qy, qc, mesh=mesh, spatial=True)
        want = encode_chunks_single(jnp.asarray(chunks), qy, qc)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_output_stays_sharded(self, qtabs):
        """Coefficients must come back sharded over chunk — no implicit
        gather (host pulls per-chunk for entropy coding)."""
        qy, qc = qtabs
        mesh = make_chunk_mesh(8)
        chunks = jax.device_put(jnp.asarray(rand_chunks(8, 1, 16, 16)),
                                chunk_sharding(mesh))
        yq, _, _ = encode_chunks_sharded(chunks, qy, qc, mesh=mesh)
        spec = yq.sharding.spec
        assert spec[0] == "chunk"


class TestShardedFvc:
    def _frames(self, c=8, f=4, h=32, w=32):
        rng = np.random.default_rng(7)
        return jnp.asarray(rng.integers(0, 256, (c, f, h, w, 3), np.uint8))

    def test_v1_matches_per_chunk(self, qtabs):
        from flutpu.codec.fvc import fvc_residuals
        from flutpu.parallel.gop import fvc_chunks_sharded
        qy, qc = qtabs
        frames = self._frames()
        mesh = make_chunk_mesh(8)
        ry, rcb, rcr = fvc_chunks_sharded(frames, qy, qc, mesh)
        for c in range(8):
            coefs = encode_chunks_single(frames[c], qy, qc)
            ery, ercb, ercr = fvc_residuals(*coefs)
            np.testing.assert_array_equal(np.asarray(ry[c]), np.asarray(ery))
            np.testing.assert_array_equal(np.asarray(rcr[c]), np.asarray(ercr))

    def test_motion_matches_per_chunk(self, qtabs):
        from flutpu.codec.fvc import fvc_mc_encode_chunk
        from flutpu.parallel.gop import fvc_chunks_sharded
        qy, qc = qtabs
        frames = self._frames(c=8, f=3)
        mesh = make_chunk_mesh(8)
        ry, rcb, rcr, mvs, itypes = fvc_chunks_sharded(
            frames, qy, qc, mesh, motion=True, search_range=3)
        assert mvs.shape == (8, 3, 2, 2, 2) and mvs.dtype == jnp.int8
        for c in (0, 5):
            e = fvc_mc_encode_chunk(frames[c], qy, qc, pad_h=32, pad_w=32,
                                    search_range=3)
            np.testing.assert_array_equal(np.asarray(ry[c]), np.asarray(e[0]))
            np.testing.assert_array_equal(np.asarray(mvs[c]), np.asarray(e[3]))
            np.testing.assert_array_equal(np.asarray(itypes[c]),
                                          np.asarray(e[4]))

    def test_output_stays_sharded(self, qtabs):
        from flutpu.parallel.gop import fvc_chunks_sharded
        qy, qc = qtabs
        mesh = make_chunk_mesh(8)
        ry, _, _ = fvc_chunks_sharded(self._frames(), qy, qc, mesh)
        assert len(ry.sharding.device_set) == 8

    def test_planar_input_matches_interleaved(self, qtabs):
        """Channel-planar fvc_chunks_sharded (the tpuhype upload layout,
        round 4) — bit-identical to interleaved input for v1, motion,
        and motion+bframes."""
        from flutpu.parallel.gop import fvc_chunks_sharded
        qy, qc = qtabs
        frames = self._frames(c=8, f=4)
        planes = tuple(frames[..., ci] for ci in range(3))
        mesh = make_chunk_mesh(8)
        for kw in (dict(), dict(motion=True, search_range=3),
                   dict(motion=True, search_range=3, bframes=1)):
            got = fvc_chunks_sharded(planes, qy, qc, mesh, **kw)
            want = fvc_chunks_sharded(frames, qy, qc, mesh, **kw)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              err_msg=str(kw))


class TestGraftEntry:
    def test_entry(self):
        import __graft_entry__ as g
        fn, args = g.entry()
        out = jax.jit(fn)(*args)
        assert out[0].shape == (8, 16, 16, 64)
        assert out[0].dtype == jnp.int16

    @pytest.mark.slow
    def test_dryrun_8(self, capsys):
        import __graft_entry__ as g
        g.dryrun_multichip(8)
        assert "OK" in capsys.readouterr().out

    def test_dryrun_2(self, capsys):
        import __graft_entry__ as g
        g.dryrun_multichip(2)
        assert "OK" in capsys.readouterr().out


class TestTpuHypeElement:
    def test_ordered_decodable(self):
        from flutpu.core import Buffer, Harness, MSECOND
        from flutpu.core.elements import make_test_frame
        from flutpu.codec.jpeg import decode_jpeg, psnr
        h = Harness("tpuhype gop-size=2 chunks=4 quality=90")
        h.set_src_caps("video/x-raw, format=RGB, width=64, height=48, framerate=30/1")
        frames = []
        for i in range(10):  # 8 fill one batch; 2 drain at EOS
            f = make_test_frame("gradient", 64, 48, i)
            frames.append(f)
            h.push(Buffer(f, pts=i * MSECOND, duration=MSECOND, offset=i))
        h.push_eos()
        outs = [h.pull(timeout=30) for _ in range(10)]
        assert [o.pts for o in outs] == [i * MSECOND for i in range(10)]
        for i, o in enumerate(outs):
            assert psnr(frames[i], decode_jpeg(o.data)) > 30
        h.teardown()


class TestTpuHypeSpatial:
    def test_chunk_spatial_mesh_element(self):
        """4K-style operation: chunk x spatial mesh on the virtual CPU
        devices; output identical contract (ordered decodable frames)."""
        from flutpu.core import Buffer, Harness, MSECOND
        from flutpu.core.elements import make_test_frame
        from flutpu.codec.jpeg import decode_jpeg, psnr
        h = Harness("tpuhype gop-size=2 chunks=2 spatial=2 quality=90")
        h.set_src_caps("video/x-raw, format=RGB, width=64, height=64, framerate=30/1")
        frames = []
        for i in range(4):
            f = make_test_frame("gradient", 64, 64, i)
            frames.append(f)
            h.push(Buffer(f, pts=i * MSECOND, duration=MSECOND, offset=i))
        h.push_eos()
        outs = [h.pull(timeout=30) for _ in range(4)]
        assert [o.pts for o in outs] == [i * MSECOND for i in range(4)]
        for i, o in enumerate(outs):
            assert psnr(frames[i], decode_jpeg(o.data)) > 30
        h.teardown()


class TestTpuHypeSpatialOverPad:
    """Heights where 16*spatial striping pads BEYOND the standard MCU
    rows (h=80, spatial=2 → 96 padded vs 80 standard): the JPEG scan must
    carry exactly the blocks an unstriped encode would — SOF height has
    no coded-size extension, so extra entropy-coded MCU rows would read
    as corrupt trailing data in standard decoders."""

    def _encode(self, spatial):
        from flutpu.core import Buffer, Harness, MSECOND
        from flutpu.core.elements import make_test_frame
        h = Harness(f"tpuhype gop-size=2 chunks=2 spatial={spatial} "
                    "quality=90")
        h.set_src_caps("video/x-raw, format=RGB, width=64, height=80, "
                       "framerate=30/1")
        frames = [make_test_frame("gradient", 64, 80, i) for i in range(4)]
        for i, f in enumerate(frames):
            h.push(Buffer(f, pts=i * MSECOND, duration=MSECOND, offset=i))
        h.push_eos()
        outs = [bytes(h.pull(timeout=30).data) for _ in range(4)]
        h.teardown()
        return frames, outs

    def test_striped_jpeg_byte_identical_to_unstriped(self):
        from flutpu.codec.jpeg import decode_jpeg, psnr
        frames, striped = self._encode(2)
        _, flat = self._encode(1)
        assert striped == flat
        for i in (0, 3):
            img = decode_jpeg(striped[i])
            assert img.shape == (80, 64, 3)
            assert psnr(frames[i], img) > 30


class TestTpuHypeFvc:
    CAPS = "video/x-raw, format=RGB, width=64, height=48, framerate=30/1"

    def _run(self, launch, n=10):
        from flutpu.core import Buffer, Harness, MSECOND
        from flutpu.core.elements import make_test_frame
        h = Harness(launch)
        h.set_src_caps(self.CAPS)
        frames = [make_test_frame("ball", 64, 48, i) for i in range(n)]
        for i, f in enumerate(frames):
            h.push(Buffer(f, pts=i * MSECOND, duration=MSECOND, offset=i))
        h.push_eos()
        chunks = []
        while True:
            b = h.try_pull(timeout=20)
            if b is None:
                break
            chunks.append(b)
        h.teardown()
        return frames, chunks

    @pytest.mark.slow
    def test_fvc_chunks_ordered_decodable(self):
        from flutpu.codec.fvc import FvcDecoder
        from flutpu.codec.jpeg import psnr
        frames, chunks = self._run("tpuhype gop-size=2 chunks=4 quality=90 "
                                   "codec=fvc")
        assert [c.pts for c in chunks] == sorted(c.pts for c in chunks)
        dec = FvcDecoder().decode_stream(
            b"".join(bytes(c.data) for c in chunks))
        assert dec.shape == (10, 48, 64, 3)  # tail chunk holds 2 real frames
        for i in (0, 4, 9):
            assert psnr(np.asarray(frames[i]), dec[i]) > 30, i

    @pytest.mark.slow
    def test_fvc_motion_chunks(self):
        from flutpu.codec.fvc import FvcDecoder
        from flutpu.codec.jpeg import psnr
        frames, chunks = self._run(
            "tpuhype gop-size=2 chunks=4 quality=90 codec=fvc-motion "
            "search-range=3", n=8)
        assert all(bytes(c.data)[4] == 2 for c in chunks)
        dec = FvcDecoder().decode_stream(
            b"".join(bytes(c.data) for c in chunks))
        assert dec.shape == (8, 48, 64, 3)
        assert psnr(np.asarray(frames[5]), dec[5]) > 30

    @pytest.mark.slow
    def test_fvc_motion_bframes_chunks(self):
        """Chunk-parallel B frames: every full chunk carries a type-2
        frame; the stream decodes in order at quality."""
        from flutpu.codec.fvc import FvcDecoder
        from flutpu.codec.jpeg import psnr
        frames, chunks = self._run(
            "tpuhype gop-size=4 chunks=2 quality=90 codec=fvc-motion "
            "search-range=3 bframes=1", n=8)
        assert len(chunks) == 2
        for c in chunks:
            d = bytes(c.data)
            assert d[4] == 2 and (d[5] & 32), (d[4], d[5])
        dec = FvcDecoder().decode_stream(
            b"".join(bytes(c.data) for c in chunks))
        assert dec.shape == (8, 48, 64, 3)
        for i in (0, 3, 5, 7):
            assert psnr(np.asarray(frames[i]), dec[i]) > 30, i

    @pytest.mark.slow
    def test_fvc_motion_bframes_tail_chunk_self_contained(self):
        """A truncated final chunk must not end on a B frame whose next
        anchor was cut — the tail re-encodes with the real-count
        structure."""
        from flutpu.codec.fvc import FvcDecoder
        frames, chunks = self._run(
            "tpuhype gop-size=4 chunks=2 quality=90 codec=fvc-motion "
            "search-range=3 bframes=1", n=6)
        dec = FvcDecoder().decode_stream(
            b"".join(bytes(c.data) for c in chunks))
        assert dec.shape == (6, 48, 64, 3)

    def test_bframes_rejects_subpel(self):
        """The invalid combination surfaces as a flow error on the chain
        (Pad.chain converts element exceptions — the error-containment
        contract), not a silent misencode."""
        from flutpu.core import Buffer, FlowReturn, Harness, MSECOND
        from flutpu.core.elements import make_test_frame
        launch = ("tpuhype gop-size=2 chunks=4 quality=90 "
                  "codec=fvc-motion subpel=true bframes=1")
        h = Harness(launch)
        h.set_src_caps(self.CAPS)
        ret = FlowReturn.OK
        for i in range(8):
            ret = h.push(Buffer(
                make_test_frame("ball", 64, 48, i),
                pts=i * MSECOND, duration=MSECOND, offset=i))
            if ret != FlowReturn.OK:
                break
        assert ret == FlowReturn.ERROR, launch
        h.teardown()


class TestSpatialFvcMotion:
    """Round-4 sequence-parallel FVC motion: frames row-striped over the
    'spatial' mesh axis, ±r halos exchanged with ring ppermutes,
    frame-type decision psum-reduced. Per-pixel results must equal the
    unsharded codec (ring wrap ≡ jnp.roll wrap)."""

    def _moving(self, c=2, f=3, h=64, w=32):
        from flutpu.core.elements import make_test_frame
        vids = []
        for ci in range(c):
            vids.append(np.stack([
                np.asarray(make_test_frame("ball", w, h, ci * 7 + i))
                for i in range(f)]))
        return jnp.asarray(np.stack(vids))

    @pytest.mark.slow
    def test_striped_motion_matches_unsharded(self, qtabs):
        from flutpu.codec.fvc import fvc_mc_encode_chunk
        from flutpu.parallel.gop import fvc_chunks_sharded
        qy, qc = qtabs
        frames = self._moving()
        mesh = make_chunk_spatial_mesh(2, 4)
        ry, rcb, rcr, mvs, itypes = fvc_chunks_sharded(
            frames, qy, qc, mesh, motion=True, search_range=3,
            spatial=True)
        assert mvs.shape == (2, 3, 4, 2, 2)
        for c in range(2):
            e = fvc_mc_encode_chunk(frames[c], qy, qc, pad_h=64, pad_w=32,
                                    search_range=3)
            np.testing.assert_array_equal(np.asarray(itypes[c]),
                                          np.asarray(e[4]))
            np.testing.assert_array_equal(np.asarray(mvs[c]),
                                          np.asarray(e[3]))
            np.testing.assert_array_equal(np.asarray(ry[c]),
                                          np.asarray(e[0]))
            np.testing.assert_array_equal(np.asarray(rcb[c]),
                                          np.asarray(e[1]))

    @pytest.mark.slow
    def test_striped_bframes_matches_unsharded(self, qtabs):
        """bframes + spatial (round 4 final): the anchor scan AND the
        parallel B pass stripe with halo ppermutes; every output field
        must equal the unsharded bidirectional codec."""
        from flutpu.codec.fvc import fvc_mc_encode_chunk_b
        from flutpu.parallel.gop import fvc_chunks_sharded
        qy, qc = qtabs
        frames = self._moving(f=4)
        mesh = make_chunk_spatial_mesh(2, 4)
        out = fvc_chunks_sharded(frames, qy, qc, mesh, motion=True,
                                 search_range=3, spatial=True, bframes=1)
        ry, rcb, rcr, fwd, bwd, modes, ftypes = out
        assert fwd.shape == (2, 4, 4, 2, 2)
        assert modes.shape == (2, 4, 4, 2)
        for c in range(2):
            e = fvc_mc_encode_chunk_b(frames[c], qy, qc, pad_h=64,
                                      pad_w=32, search_range=3, bframes=1)
            for got, want, name in zip(
                    (ry, rcb, rcr, fwd, bwd, modes, ftypes), e,
                    ("ry", "rcb", "rcr", "fwd", "bwd", "modes", "ftypes")):
                np.testing.assert_array_equal(
                    np.asarray(got[c]), np.asarray(want), err_msg=name)

    def test_striped_v1_matches_unsharded(self, qtabs):
        """v1 (temporal coefficient deltas) stripes with zero halos."""
        from flutpu.codec.fvc import fvc_residuals
        from flutpu.parallel.gop import encode_chunks_single, \
            fvc_chunks_sharded
        qy, qc = qtabs
        frames = self._moving(f=2)
        mesh = make_chunk_spatial_mesh(2, 4)
        ry, rcb, rcr = fvc_chunks_sharded(frames, qy, qc, mesh,
                                          motion=False, spatial=True)
        for c in range(2):
            coefs = encode_chunks_single(frames[c], qy, qc)
            ery, _, ercr = fvc_residuals(*coefs)
            np.testing.assert_array_equal(np.asarray(ry[c]),
                                          np.asarray(ery))
            np.testing.assert_array_equal(np.asarray(rcr[c]),
                                          np.asarray(ercr))


class TestTpuHypeFvcSpatial:
    """tpuhype codec=fvc-motion spatial=2 — the element face of the
    round-4 sequence-parallel path (2 chunks x 2 row stripes on the
    virtual mesh); streams must decode like any other fvc stream."""
    CAPS = "video/x-raw, format=RGB, width=64, height=48, framerate=30/1"

    @pytest.mark.slow
    def test_fvc_motion_spatial_chunks_decode(self):
        from flutpu.codec.fvc import FvcDecoder
        from flutpu.codec.jpeg import psnr
        from flutpu.core import Buffer, Harness, MSECOND
        from flutpu.core.elements import make_test_frame
        h = Harness("tpuhype gop-size=2 chunks=2 spatial=2 quality=90 "
                    "codec=fvc-motion search-range=3")
        h.set_src_caps(self.CAPS)
        frames = [make_test_frame("ball", 64, 48, i) for i in range(8)]
        for i, f in enumerate(frames):
            h.push(Buffer(f, pts=i * MSECOND, duration=MSECOND, offset=i))
        h.push_eos()
        chunks = []
        while (b := h.try_pull(timeout=30)) is not None:
            chunks.append(b)
        h.teardown()
        assert [c.pts for c in chunks] == sorted(c.pts for c in chunks)
        assert all(bytes(c.data)[4] == 2 for c in chunks)
        dec = FvcDecoder().decode_stream(
            b"".join(bytes(c.data) for c in chunks))
        assert dec.shape == (8, 48, 64, 3)
        for i in (0, 3, 7):
            assert psnr(np.asarray(frames[i]), dec[i]) > 30, i

    @pytest.mark.slow
    def test_fvc_motion_spatial_bframes_decode(self):
        """spatial=2 + bframes=1 through the element: streams carry both
        the coded-size extension (bit 4) and the B structure (bit 5) and
        decode like any other fvc stream."""
        from flutpu.codec.fvc import FvcDecoder
        from flutpu.codec.jpeg import psnr
        from flutpu.core import Buffer, Harness, MSECOND
        from flutpu.core.elements import make_test_frame
        h = Harness("tpuhype gop-size=4 chunks=2 spatial=2 quality=90 "
                    "codec=fvc-motion search-range=3 bframes=1")
        h.set_src_caps(self.CAPS)
        frames = [make_test_frame("ball", 64, 48, i) for i in range(8)]
        for i, f in enumerate(frames):
            h.push(Buffer(f, pts=i * MSECOND, duration=MSECOND, offset=i))
        h.push_eos()
        chunks = []
        while (b := h.try_pull(timeout=30)) is not None:
            chunks.append(b)
        h.teardown()
        assert [c.pts for c in chunks] == sorted(c.pts for c in chunks)
        assert all(bytes(c.data)[5] & 32 for c in chunks), "bit 5 (B)"
        dec = FvcDecoder().decode_stream(
            b"".join(bytes(c.data) for c in chunks))
        assert dec.shape == (8, 48, 64, 3)
        for i in (0, 1, 5, 7):
            assert psnr(np.asarray(frames[i]), dec[i]) > 30, i

    @pytest.mark.slow
    def test_fvc_v1_spatial_chunks_decode(self):
        from flutpu.codec.fvc import FvcDecoder
        from flutpu.codec.jpeg import psnr
        from flutpu.core import Buffer, Harness, MSECOND
        from flutpu.core.elements import make_test_frame
        h = Harness("tpuhype gop-size=2 chunks=2 spatial=2 quality=90 "
                    "codec=fvc")
        h.set_src_caps(self.CAPS)
        frames = [make_test_frame("ball", 64, 48, i) for i in range(8)]
        for i, f in enumerate(frames):
            h.push(Buffer(f, pts=i * MSECOND, duration=MSECOND, offset=i))
        h.push_eos()
        chunks = []
        while (b := h.try_pull(timeout=30)) is not None:
            chunks.append(b)
        h.teardown()
        dec = FvcDecoder().decode_stream(
            b"".join(bytes(c.data) for c in chunks))
        assert dec.shape == (8, 48, 64, 3)
        assert psnr(np.asarray(frames[5]), dec[5]) > 30
