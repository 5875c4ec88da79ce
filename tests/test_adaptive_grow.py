"""Adaptive device-program sizing: background growth + cheap overflow.

A grown static size is a fresh program, and compiling it on the streaming
thread stalls the stream; a true overflow that re-encoded through the
interleaved cap ladder would compile programs the steady state never
uses. The design:

- growth targets are computed from recorded usage (pure policy) and the
  grown program compiles on a worker (`_maybe_adopt_or_warm`), adopted
  only once ready — the stream keeps riding the still-correct current
  program (the injectbin prewarm contract applied to the encoder's own
  adaptive shapes);
- a true overflow redispatches the SAME program family once at sizes
  covering the device-reported TRUE usage (`_refinalize_grown`) — the
  grown program is exactly what subsequent GOPs dispatch.


Packing cases run with both packers: the plain scan and the Pallas kernel
(interpret mode on the CPU).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from flutpu.codec.jpeg import JpegEncoder
from flutpu.core.elements import make_test_frame


def _gop(n=2, seed=3, noisy=False):
    if noisy:
        return (np.random.default_rng(seed)
                .integers(0, 256, size=(n, 32, 32, 3)).astype(np.uint8))
    return make_test_frame("gradient", 32, 32, seed)[None].repeat(n, 0)


PACKERS = pytest.mark.parametrize("use_pallas", [False, True],
                                  ids=["scan", "kernel"])


class TestAsyncGrow:
    @pytest.mark.slow
    @PACKERS
    def test_grow_defers_then_adopts(self, monkeypatch, use_pallas):
        """With async growth on, a dispatch after usage outgrows the
        capacity keeps riding the OLD sizes (pending warm), and a later
        dispatch adopts the grown ones — every GOP byte-identical."""
        std = JpegEncoder(quality=85, use_pallas=False)
        enc = JpegEncoder(quality=85, use_pallas=use_pallas, segmented=True)
        monkeypatch.setattr(enc, "_grow_async", lambda: True)
        frames = _gop()
        fdev = jnp.asarray(frames)
        want = std.encode_gop_finalize(std.encode_gop_dispatch(fdev, 32, 32))

        h1 = enc.encode_gop_dispatch(fdev, 32, 32)
        assert enc.encode_gop_finalize(h1) == want
        sw0 = enc._seg_words
        enc._seg_gops = 3  # past warmup: growth must go async

        # usage report says the densest segment needs > 75% of capacity
        enc._seg_used_words = sw0  # 100% of current capacity
        h2 = enc.encode_gop_dispatch(fdev, 32, 32)
        assert h2[7] == sw0, "dispatch must keep riding the old program"
        assert enc._grow_pending is not None, "no background warm submitted"
        assert enc.encode_gop_finalize(h2) == want

        enc._grow_pending[1].result(timeout=30)  # warm finished
        h3 = enc.encode_gop_dispatch(fdev, 32, 32)
        assert enc._grow_pending is None
        assert enc._seg_words > sw0, "grown capacity not adopted"
        assert h3[7] == enc._seg_words
        assert enc.encode_gop_finalize(h3) == want

    def test_warmup_adopts_synchronously_with_2x_headroom(self, monkeypatch):
        """During the first GOPs the capacity adopts synchronously (no
        program is warm yet) and covers 2x the observed usage — content
        whose densest segment jumps after warmup (motion residuals) must
        not overflow mid-stream."""
        enc = JpegEncoder(quality=85, use_pallas=False, segmented=True)
        monkeypatch.setattr(enc, "_grow_async", lambda: True)
        enc._note_seg_usage(60 * 32)   # GOP-0 densest segment: 60 words
        win, sw = enc._maybe_adopt_or_warm(
            lambda p, s: (_ for _ in ()).throw(
                AssertionError("warmup must adopt, not warm")))
        assert sw == enc._seg_words == 128  # 2x60 → 120 → padded 128
        assert enc._grow_pending is None
        # light content stays at the default capacity
        enc2 = JpegEncoder(quality=85, use_pallas=False, segmented=True)
        monkeypatch.setattr(enc2, "_grow_async", lambda: True)
        enc2._note_seg_usage(20 * 32)
        _, sw2 = enc2._maybe_adopt_or_warm(lambda p, s: None)
        assert sw2 == enc2.SEG_WORDS0

    @pytest.mark.slow
    def test_overflow_prefers_covering_pending_warm(self, monkeypatch):
        """A true overflow whose need is covered by the pending
        background warm must WAIT for that compile and reuse its sizes
        instead of compiling yet another program."""
        from concurrent.futures import Future
        enc = JpegEncoder(quality=85, use_pallas=False, segmented=True)
        monkeypatch.setattr(enc, "_grow_async", lambda: True)
        enc._seg_gops = 3
        enc._prefix_window = 8192
        fut = Future()
        fut.set_result(0)   # the warm finished
        enc._grow_pending = ((None, 128), fut)
        win, sw = enc._overflow_sizes(used_words=100, seg_need_words=96)
        assert sw == 128 and enc._grow_pending is None
        # need BEYOND the pending: falls back to target computation
        enc2 = JpegEncoder(quality=85, use_pallas=False, segmented=True)
        monkeypatch.setattr(enc2, "_grow_async", lambda: True)
        enc2._seg_gops = 3
        enc2._prefix_window = 8192
        enc2._grow_pending = ((None, 128), fut)
        _, sw2 = enc2._overflow_sizes(used_words=100, seg_need_words=200)
        assert sw2 >= 200
        assert enc2._grow_pending is not None, \
            "an insufficient pending warm should stay for later adoption"

    def test_sync_backends_adopt_immediately(self):
        """CPU backends (tests, host fallback) keep the deterministic
        synchronous adoption."""
        enc = JpegEncoder(quality=85, use_pallas=False, segmented=True)
        assert not enc._grow_async()
        enc._seg_used_words = enc._seg_words  # > 75% of capacity
        enc._maybe_adopt_or_warm(lambda p, s: (_ for _ in ()).throw(
            AssertionError("sync path must not build")))
        assert enc._seg_words > enc.SEG_WORDS0


class TestOverflowRedispatch:
    @pytest.mark.slow
    @PACKERS
    def test_segment_overflow_redispatches_same_family(self, use_pallas):
        """A segment-capacity overflow must be healed by ONE redispatch of
        the same fused program at grown sizes — never via the interleaved
        cap-ladder re-encode (`_finalize_overflow`)."""
        frames = _gop(noisy=True)
        fdev = jnp.asarray(frames)
        std = JpegEncoder(quality=97, use_pallas=False)
        want = std.encode_gop_finalize(std.encode_gop_dispatch(fdev, 32, 32))
        enc = JpegEncoder(quality=97, use_pallas=use_pallas, segmented=True)
        enc._seg_words = 8  # force overflow (8 words = 256 bits/segment)
        calls = []
        orig = JpegEncoder._finalize_overflow
        enc._finalize_overflow = lambda *a, **k: (
            calls.append(1) or orig(enc, *a, **k))
        got = enc.encode_gop_finalize(enc.encode_gop_dispatch(fdev, 32, 32))
        assert got == want
        assert enc._seg_words > 8, "capacity did not grow"
        assert not calls, "overflow fell back to the cap ladder"
        # the grown program is what the next GOP dispatches — no overflow
        h = enc.encode_gop_dispatch(fdev, 32, 32)
        assert h[7] == enc._seg_words
        assert enc.encode_gop_finalize(h) == want

    @PACKERS
    def test_prefix_overflow_redispatches_same_family(self, use_pallas):
        """An adaptive-window overflow grows the window from the TRUE
        device-reported usage and redispatches once (combined layout)."""
        frames = _gop(noisy=True, seed=5)
        fdev = jnp.asarray(frames)
        std = JpegEncoder(quality=97, use_pallas=False)
        want = std.encode_gop_finalize(std.encode_gop_dispatch(fdev, 32, 32))
        enc = JpegEncoder(quality=97, use_pallas=use_pallas,
                          segmented=False)
        enc._prefix_window = 8  # absurdly small window → overflow
        calls = []
        orig = JpegEncoder._finalize_overflow
        enc._finalize_overflow = lambda *a, **k: (
            calls.append(1) or orig(enc, *a, **k))
        got = enc.encode_gop_finalize(enc.encode_gop_dispatch(fdev, 32, 32))
        assert got == want
        assert not calls, "overflow fell back to the cap ladder"
        assert (enc._prefix_window or 0) > 8

    @pytest.mark.slow
    @PACKERS
    def test_fvc_overflow_redispatch(self, use_pallas):
        """FVC's device finalize heals overflow through the same-family
        redispatch (no interleaved re-encode, no estimate reset)."""
        from flutpu.codec.fvc import FvcDecoder, FvcEncoder
        frames = (np.random.default_rng(7)
                  .integers(0, 256, size=(3, 32, 32, 3)).astype(np.uint8))
        enc = FvcEncoder(quality=97, segmented=True)
        enc._scan_coder.use_pallas = use_pallas
        enc._scan_coder.segmented = True
        enc._scan_coder._seg_words = 8
        chunk = enc.encode_chunk(frames)
        ref = FvcEncoder(quality=97, segmented=False)
        ref._scan_coder.use_pallas = False
        assert chunk == ref.encode_chunk(frames)
        assert enc._scan_coder._seg_words > 8
        assert enc._scan_coder._prefix_used_words is not None, \
            "estimate must survive a healed overflow"
        out, _ = FvcDecoder().decode_chunk(chunk)
        assert out.shape[0] == 3
