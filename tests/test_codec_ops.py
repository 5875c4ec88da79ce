"""Device transform tests: colorspace, DCT, quant/zigzag, JPEG interop."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from flutpu.codec.ops.colorspace import (i420_to_rgb, rgb_to_i420,
                                         rgb_to_ycbcr, scale_bilinear,
                                         subsample_420, upsample_420,
                                         ycbcr_to_rgb)
from flutpu.codec.ops.dct import (blockize, dct2, dct_matrix, idct2,
                                  plane_dct, plane_idct, unblockize)
from flutpu.codec.ops.quant import (LUMA_QTABLE, dequantize, quantize,
                                    scale_qtable, zigzag_flatten,
                                    zigzag_order, zigzag_unflatten)


def rand_rgb(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


class TestColorspace:
    def test_roundtrip(self):
        rgb = rand_rgb((16, 16, 3)).astype(np.float32)
        out = np.asarray(ycbcr_to_rgb(rgb_to_ycbcr(rgb)))
        np.testing.assert_allclose(out, rgb, atol=1e-2)

    def test_gray_maps_to_neutral_chroma(self):
        gray = np.full((8, 8, 3), 77, np.float32)
        ycc = np.asarray(rgb_to_ycbcr(gray))
        np.testing.assert_allclose(ycc[..., 0], 77, atol=1e-3)
        np.testing.assert_allclose(ycc[..., 1:], 128, atol=1e-3)

    def test_subsample_upsample(self):
        p = np.arange(64, dtype=np.float32).reshape(8, 8)
        s = np.asarray(subsample_420(p))
        assert s.shape == (4, 4)
        assert s[0, 0] == pytest.approx((0 + 1 + 8 + 9) / 4)
        u = np.asarray(upsample_420(s))
        assert u.shape == (8, 8)

    def test_i420_roundtrip_flat_regions(self):
        rgb = np.zeros((16, 16, 3), np.float32)
        rgb[:8] = [200, 30, 40]
        rgb[8:] = [10, 90, 250]
        y, cb, cr = rgb_to_i420(rgb)
        out = np.clip(np.asarray(i420_to_rgb(y, cb, cr)), 0, 255)
        # flat regions survive 4:2:0 except the boundary rows
        np.testing.assert_allclose(out[:6], rgb[:6], atol=1.0)
        np.testing.assert_allclose(out[10:], rgb[10:], atol=1.0)

    def test_scale_bilinear(self):
        img = rand_rgb((32, 64, 3))
        out = np.asarray(scale_bilinear(jnp.asarray(img), 16, 32))
        assert out.shape == (16, 32, 3)
        const = np.full((8, 8), 42.0, np.float32)
        out2 = np.asarray(scale_bilinear(jnp.asarray(const), 16, 16))
        np.testing.assert_allclose(out2, 42.0, atol=1e-4)


class TestDCT:
    def test_orthonormal(self):
        c = dct_matrix(8)
        np.testing.assert_allclose(c @ c.T, np.eye(8), atol=1e-6)

    def test_matches_scipy_definition(self):
        # orthonormal DCT-II of a ramp, computed by direct formula
        x = np.arange(8, dtype=np.float64)
        expected = np.zeros(8)
        for k in range(8):
            s = np.sqrt(1 / 8) if k == 0 else np.sqrt(2 / 8)
            expected[k] = s * np.sum(x * np.cos((2 * np.arange(8) + 1) * k * np.pi / 16))
        got = dct_matrix(8).astype(np.float64) @ x
        np.testing.assert_allclose(got, expected, atol=1e-5)

    def test_roundtrip(self):
        blocks = np.random.default_rng(1).normal(size=(5, 3, 8, 8)).astype(np.float32) * 100
        out = np.asarray(idct2(dct2(blocks)))
        np.testing.assert_allclose(out, blocks, atol=1e-2)

    def test_blockize_roundtrip(self):
        plane = np.arange(32 * 16, dtype=np.float32).reshape(32, 16)
        b = blockize(jnp.asarray(plane))
        assert b.shape == (4, 2, 8, 8)
        np.testing.assert_array_equal(np.asarray(b[0, 0]), plane[:8, :8])
        np.testing.assert_array_equal(np.asarray(unblockize(b)), plane)

    def test_plane_roundtrip_batched(self):
        planes = np.random.default_rng(2).normal(size=(4, 16, 24)).astype(np.float32) * 50
        out = np.asarray(plane_idct(plane_dct(jnp.asarray(planes))))
        np.testing.assert_allclose(out, planes, atol=1e-2)

    def test_dc_coefficient(self):
        block = np.full((8, 8), 100.0, np.float32)
        coefs = np.asarray(dct2(jnp.asarray(block)))
        assert coefs[0, 0] == pytest.approx(800.0, rel=1e-4)  # 8 * mean
        assert np.abs(coefs).sum() == pytest.approx(800.0, rel=1e-4)


class TestQuant:
    def test_zigzag_order_prefix(self):
        zz = zigzag_order(8)
        assert list(zz[:10]) == [0, 1, 8, 16, 9, 2, 3, 10, 17, 24]
        assert sorted(zz) == list(range(64))

    def test_zigzag_roundtrip(self):
        blocks = np.arange(2 * 64, dtype=np.int32).reshape(2, 8, 8)
        flat = zigzag_flatten(jnp.asarray(blocks))
        back = np.asarray(zigzag_unflatten(flat))
        np.testing.assert_array_equal(back, blocks)

    def test_quality_scaling(self):
        q50 = scale_qtable(LUMA_QTABLE, 50)
        np.testing.assert_array_equal(q50, LUMA_QTABLE)
        q100 = scale_qtable(LUMA_QTABLE, 100)
        assert q100.max() <= 1
        q10 = scale_qtable(LUMA_QTABLE, 10)
        assert (q10 >= LUMA_QTABLE).all()

    def test_quant_roundtrip_error_bounded(self):
        rng = np.random.default_rng(3)
        coefs = rng.normal(size=(8, 8)).astype(np.float32) * 200
        qt = scale_qtable(LUMA_QTABLE, 85)
        deq = np.asarray(dequantize(quantize(jnp.asarray(coefs), jnp.asarray(qt)),
                                    jnp.asarray(qt)))
        assert np.all(np.abs(deq - coefs) <= qt / 2 + 1e-3)


class TestJpeg:
    def test_jpeg_decodable_and_close(self):
        from flutpu.codec.jpeg import JpegEncoder, decode_jpeg, psnr
        from flutpu.core.elements import make_test_frame
        frame = make_test_frame("gradient", 96, 64, 0)
        enc = JpegEncoder(quality=90)
        data = enc.encode_frame(frame)
        assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
        decoded = decode_jpeg(data)
        assert decoded.shape == frame.shape
        p = psnr(frame, decoded)
        assert p > 30, f"PSNR too low: {p:.1f} dB"

    def test_jpeg_non_multiple_of_16(self):
        from flutpu.codec.jpeg import JpegEncoder, decode_jpeg, psnr
        from flutpu.core.elements import make_test_frame
        frame = make_test_frame("gradient", 50, 34, 0)
        data = JpegEncoder(quality=90).encode_frame(frame)
        decoded = decode_jpeg(data)
        assert decoded.shape == frame.shape
        assert psnr(frame, decoded) > 28

    def test_jpeg_444(self):
        from flutpu.codec.jpeg import JpegEncoder, decode_jpeg, psnr
        from flutpu.core.elements import make_test_frame
        frame = make_test_frame("ball", 64, 48, 3)
        data = JpegEncoder(quality=95, subsample=False).encode_frame(frame)
        decoded = decode_jpeg(data)
        assert psnr(frame, decoded) > 35

    def test_quality_ladder(self):
        from flutpu.codec.jpeg import JpegEncoder, decode_jpeg, psnr
        from flutpu.core.elements import make_test_frame
        frame = make_test_frame("noise", 64, 64, 1)
        sizes, psnrs = [], []
        for q in (30, 60, 90):
            data = JpegEncoder(quality=q).encode_frame(frame)
            sizes.append(len(data))
            psnrs.append(psnr(frame, decode_jpeg(data)))
        assert sizes[0] < sizes[1] < sizes[2]
        assert psnrs[0] < psnrs[1] < psnrs[2]

    def test_gop_batch_matches_single(self):
        from flutpu.codec.jpeg import JpegEncoder
        from flutpu.core.elements import make_test_frame
        frames = np.stack([make_test_frame("gradient", 32, 32, i)
                           for i in range(4)])
        enc = JpegEncoder(quality=80)
        batch = enc.encode_gop(frames)
        singles = [enc.encode_frame(frames[i]) for i in range(4)]
        assert batch == singles

    def test_python_fallback_matches_native(self):
        from flutpu.codec import jpeg as J
        from flutpu.core.elements import make_test_frame
        from flutpu import native
        if native.get_lib() is None:
            pytest.skip("native lib unavailable")
        frame = make_test_frame("gradient", 48, 32, 1)
        enc = J.JpegEncoder(quality=75)
        import jax.numpy as jnp
        yq, cbq, crq = J.encode_gop_to_coefs(
            jnp.asarray(frame[None]), jnp.asarray(enc.qy), jnp.asarray(enc.qc),
            pad_h=32, pad_w=48, subsample=True)
        y, cb, cr = (np.asarray(a[0], dtype=np.int16) for a in (yq, cbq, crq))
        a = J._encode_scan_python(y, cb, cr, True)
        b = J._encode_scan_native(native.get_lib(), y, cb, cr, True)
        assert a == b


def test_planar_dct_matches_blockized():
    """plane_dct_planar == unblockize-composed plane_dct layout-wise, and
    the roundtrip through planar idct reconstructs."""
    import jax.numpy as jnp
    from flutpu.codec.ops.dct import (blockize, plane_dct, plane_dct_planar,
                                      plane_idct_planar, unblockize)
    rng = np.random.default_rng(3)
    planes = rng.uniform(-128, 127, size=(2, 32, 48)).astype(np.float32)
    ref = np.asarray(unblockize(plane_dct(jnp.asarray(planes))))
    got = np.asarray(plane_dct_planar(jnp.asarray(planes)))
    np.testing.assert_allclose(ref, got, atol=2e-3)
    rec = np.asarray(plane_idct_planar(jnp.asarray(got)))
    np.testing.assert_allclose(rec, planes, atol=1e-2)


def test_planar_quantize_matches_blockized():
    import jax.numpy as jnp
    from flutpu.codec.ops.dct import blockize
    from flutpu.codec.ops.quant import (LUMA_QTABLE, quantize,
                                        quantize_planar)
    rng = np.random.default_rng(4)
    coefs_plane = rng.uniform(-900, 900, size=(24, 40)).astype(np.float32)
    qt = jnp.asarray(LUMA_QTABLE.astype(np.float32))
    a = np.asarray(quantize(blockize(jnp.asarray(coefs_plane)), qt))
    b = np.asarray(blockize(quantize_planar(jnp.asarray(coefs_plane), qt)))
    np.testing.assert_array_equal(a, b)
