"""The Triton packer and the JPEG dispatch programs lower for CUDA at real
widths. Pallas-through-Triton lowers to Triton IR in Python, so a CPU-only
JAX catches kernel errors of shape, indexing and dtype here; what only the
card's compiler says (registers, shared memory) needs the card (the
``gpu``-marked tests and chip_smoke.py).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flutpu import platform

TRITON = "__gpu$xla.gpu.triton"

# (coded height, width, frames)
SHAPES = {"1080p": (1088, 1920), "4k": (2176, 3840)}


@pytest.fixture
def on_gpu(monkeypatch):
    """Take the GPU's arms (Triton kernel, never interpret mode) while
    tracing on this CPU-only JAX."""
    monkeypatch.setattr(platform, "name", lambda: "gpu")


def _custom_calls(lowered):
    return set(re.findall(r'custom_call @([^\(\s]+)\(', lowered.as_text()))


def _blocks(shape, frames):
    ph, pw = SHAPES[shape]
    return frames * (ph // 8) * (pw // 8) * 3 // 2


@pytest.mark.parametrize("seg_g,n_words", [(1, 64), (16, 128)])
@pytest.mark.parametrize("shape,frames", [("1080p", 16), ("4k", 1)])
def test_packer_lowers_for_cuda(on_gpu, shape, frames, seg_g, n_words):
    from flutpu.codec.ops.pack_kernel import pack_segments
    b = _blocks(shape, frames)
    b += -b % seg_g
    lowered = jax.jit(lambda z, c: pack_segments(
        z, c, seg_g=seg_g, n_words=n_words)).trace(
        jax.ShapeDtypeStruct((b, 64), jnp.int32),
        jax.ShapeDtypeStruct((b,), jnp.int32)).lower(
        lowering_platforms=("cuda",))
    assert TRITON in _custom_calls(lowered)


@pytest.mark.parametrize("seg_words", [None, 128])
@pytest.mark.parametrize("shape", ["1080p", "4k"])
@pytest.mark.parametrize("frames", [16, 32])
def test_dispatch_program_lowers_for_cuda(on_gpu, frames, shape,
                                          seg_words):
    """The whole fused JPEG dispatch program (on-device source → front
    end → entropy pack → concat), in both bit-stream layouts."""
    from flutpu.codec.jpeg import JpegEncoder, _gop_dispatch_program_src
    from flutpu.codec.ops.entropy import mcu_layout
    from flutpu.codec.ops.testsrc import gradient_ball_planes
    ph, pw = SHAPES[shape]
    enc = JpegEncoder(quality=85)
    assert enc.use_pallas

    def src(h, w, start):
        return gradient_ball_planes(h, w, frames, start)

    layout = mcu_layout(pw // 8, ph // 8, pw // 16, ph // 16, True)
    lowered = _gop_dispatch_program_src.trace(
        jax.ShapeDtypeStruct((), jnp.float32), enc._qy_dev, enc._qc_dev,
        jax.ShapeDtypeStruct((ph, pw, 4), jnp.uint8), src, pad_h=ph,
        pad_w=pw, subsample=True, layout=layout, prefix_words=32768,
        use_pallas=True, seg_words=seg_words).lower(
        lowering_platforms=("cuda",))
    assert TRITON in _custom_calls(lowered)


@pytest.mark.gpu
@pytest.mark.parametrize("seg_g,n_words", [(1, 64), (16, 128)])
def test_packer_matches_scan_on_card(seg_g, n_words):
    """On the card: the compiled kernel equals the scan bit for bit on a
    16-frame 1080p dispatch's worth of coefficients."""
    from flutpu.codec.ops import entropy as E
    from flutpu.codec.ops.pack_kernel import pack_segments
    rng = np.random.default_rng(0)
    b = _blocks("1080p", 16)
    zz = rng.integers(-60, 60, size=(b, 64)).astype(np.int32)
    zz[rng.random(zz.shape) < 0.85] = 0
    comp = (np.arange(b) % 6 >= 4).astype(np.int32)
    zz, comp = jnp.asarray(zz), jnp.asarray(comp)
    kb, kn = pack_segments(zz, comp, seg_g=seg_g, n_words=n_words)
    sb, sn = jax.jit(lambda z, c: E._pack_segments_scan(
        z, c, seg_g, n_words))(zz, comp)
    np.testing.assert_array_equal(np.asarray(kn), np.asarray(sn))
    np.testing.assert_array_equal(np.asarray(kb), np.asarray(sb))
