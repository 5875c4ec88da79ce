"""tpujpegenc element tests: the device encode path inside real pipelines —
the end-to-end slice (SURVEY §7.3/7.4): source → GOP scatter → per-branch
device encode → ordered gather → decodable bitstreams."""

import numpy as np
import pytest

from flutpu.core import (Buffer, Caps, Harness, MSECOND, SECOND, State,
                         parse_launch)
from flutpu.core.elements import make_test_frame
from flutpu.codec.jpeg import decode_jpeg, psnr

CAPS = "video/x-raw, format=RGB, width=64, height=48, framerate=30/1"


def push_frames(h, n, w=64, hh=48):
    frames = []
    for i in range(n):
        f = make_test_frame("gradient", w, hh, i)
        frames.append(f)
        h.push(Buffer(f, pts=i * MSECOND, duration=MSECOND, offset=i))
    return frames


def test_encoder_standalone():
    h = Harness("tpujpegenc quality=90 batch-frames=4")
    h.set_src_caps(CAPS)
    frames = push_frames(h, 6)
    h.push_eos()
    outs = [h.pull(timeout=20) for _ in range(6)]
    assert h.wait_for_eos(5)
    for i, out in enumerate(outs):
        assert out.pts == i * MSECOND
        img = decode_jpeg(out.data)
        assert psnr(frames[i], img) > 30
    h.teardown()


def test_encoder_caps_negotiation():
    h = Harness("tpujpegenc")
    h.set_src_caps(CAPS)
    push_frames(h, 1)
    h.push_eos()
    h.pull(timeout=20)
    caps_events = [e for e in h.events_received() if e.type.value == "caps"]
    assert caps_events, "no caps event reached the sink"
    caps = caps_events[-1].caps
    assert caps.media_type == "image/jpeg"
    assert caps["width"] == 64 and caps["height"] == 48


def test_hype_with_tpu_encoders():
    """The minimum end-to-end slice: GOP scatter → parallel device encode →
    ordered gather; outputs must be in-order, decodable, faithful."""
    h = Harness("hype gop-size=4 encoder-1=tpujpegenc encoder-2=tpujpegenc")
    h.set_src_caps(CAPS)
    frames = push_frames(h, 12)
    h.push_eos()
    outs = [h.pull(timeout=30) for _ in range(12)]
    for i, out in enumerate(outs):
        assert out.pts == i * MSECOND, f"order broken at {i}"
        img = decode_jpeg(out.data)
        assert psnr(frames[i], img) > 30, f"frame {i} corrupt"
    h.teardown()


def test_hype_tpu_encoders_partial_last_chunk():
    h = Harness("hype gop-size=5 encoder-1=tpujpegenc encoder-2=tpujpegenc")
    h.set_src_caps(CAPS)
    frames = push_frames(h, 7)  # 5 + partial 2
    h.push_eos()
    outs = [h.pull(timeout=30) for _ in range(7)]
    assert [o.pts for o in outs] == [i * MSECOND for i in range(7)]
    assert psnr(frames[6], decode_jpeg(outs[6].data)) > 30
    h.teardown()


def test_flushing_seek_drops_pending_frames():
    """Pre-seek batched frames must not leak into post-seek chunks; the
    post-seek stream restarts on a sync point."""
    from flutpu.codec.fvc import FvcDecoder
    from flutpu.core import Buffer, Harness, MSECOND
    from flutpu.core.events import FlushStartEvent, FlushStopEvent
    from flutpu.core.elements import make_test_frame

    h = Harness("fvcenc quality=90 gop-size=4")
    h.set_src_caps("video/x-raw, format=RGB, width=64, height=48, "
                   "framerate=30/1")
    for i in range(3):  # fewer than gop-size: stay pending
        h.push(Buffer(make_test_frame("ball", 64, 48, i),
                      pts=i * MSECOND, duration=MSECOND, offset=i))
    h.push_event(FlushStartEvent())
    h.push_event(FlushStopEvent())
    post = [make_test_frame("ball", 64, 48, 10 + i) for i in range(4)]
    for i, f in enumerate(post):
        h.push(Buffer(f, pts=(10 + i) * MSECOND, duration=MSECOND,
                      offset=10 + i))
    h.push_eos()
    chunks = []
    while True:
        b = h.try_pull(timeout=10)
        if b is None:
            break
        chunks.append(bytes(b.data))
    h.teardown()
    assert len(chunks) == 1  # only the post-seek chunk
    dec, info = FvcDecoder().decode_chunk(chunks[0])
    assert dec.shape[0] == 4 and info["types"][0] == 0


@pytest.mark.slow
def test_mid_stream_resolution_change_splits_chunks():
    """A caps change closes the open chunk; each resolution gets its own
    independently decodable chunks (no mixed-size batches)."""
    from flutpu.codec.fvc import FvcDecoder
    from flutpu.core import Buffer, Harness, MSECOND
    from flutpu.core.elements import make_test_frame
    from flutpu.codec.jpeg import psnr

    h = Harness("fvcenc quality=85 gop-size=8")
    h.set_src_caps("video/x-raw, format=RGB, width=64, height=48, "
                   "framerate=30/1")
    small = [make_test_frame("ball", 64, 48, i) for i in range(3)]
    for i, f in enumerate(small):
        h.push(Buffer(f, pts=i * MSECOND, duration=MSECOND, offset=i))
    h.set_src_caps("video/x-raw, format=RGB, width=96, height=64, "
                   "framerate=30/1")
    big = [make_test_frame("ball", 96, 64, 3 + i) for i in range(3)]
    for i, f in enumerate(big):
        h.push(Buffer(f, pts=(3 + i) * MSECOND, duration=MSECOND,
                      offset=3 + i))
    h.push_eos()
    chunks = []
    while True:
        b = h.try_pull(timeout=5)
        if b is None:
            break
        chunks.append(bytes(b.data))
    h.teardown()
    assert len(chunks) == 2
    d1, _ = FvcDecoder().decode_chunk(chunks[0])
    d2, _ = FvcDecoder().decode_chunk(chunks[1])
    assert d1.shape == (3, 48, 64, 3) and d2.shape == (3, 64, 96, 3)
    assert psnr(small[1], d1[1]) > 30 and psnr(big[1], d2[1]) > 30


class TestAdaptivePrefix:
    def test_jpeg_adaptive_window_shrinks_and_matches(self):
        import jax.numpy as jnp
        from flutpu.codec.jpeg import JpegEncoder, _pad_to
        from flutpu.core.elements import make_test_frame
        frames = np.stack([make_test_frame("gradient", 128, 64, i)
                           for i in range(4)])
        ph, pw = _pad_to(64, 16), _pad_to(128, 16)
        fdev = jnp.asarray(np.pad(
            frames, ((0, 0), (0, ph - 64), (0, pw - 128), (0, 0)),
            mode="edge"))

        ref = JpegEncoder(quality=85, engine="auto")
        expect = ref.encode_gop_finalize(ref.encode_gop_dispatch(
            fdev, 64, 128))

        enc = JpegEncoder(quality=85, engine="auto")
        first = enc.encode_gop_finalize(enc.encode_gop_dispatch(
            fdev, 64, 128))
        assert enc._prefix_used_words is not None
        est = enc._prefix_estimate()
        assert est is not None and est <= enc.PREFIX_WORDS
        second = enc.encode_gop_finalize(enc.encode_gop_dispatch(
            fdev, 64, 128))
        assert first == expect and second == expect

    def test_fvc_adaptive_spike_retries_on_device(self):
        from flutpu.codec.fvc import FvcDecoder, FvcEncoder
        rng = np.random.default_rng(11)
        smooth = np.tile(
            np.linspace(0, 255, 64, dtype=np.uint8)[None, :, None, None],
            (4, 1, 64, 3)).reshape(4, 64, 64, 3)
        noisy = rng.integers(0, 255, (4, 64, 64, 3)).astype(np.uint8)

        enc = FvcEncoder(quality=85, engine="auto")
        c1 = enc.encode_chunk(smooth)
        est_after_smooth = enc._scan_coder._prefix_estimate()
        assert est_after_smooth is not None
        c2 = enc.encode_chunk(noisy)   # spike: must retry, not corrupt
        # the adaptive/retry path must be byte-identical to a fresh
        # encoder with no adaptive state
        fresh = FvcEncoder(quality=85, engine="auto")
        assert c2 == fresh.encode_chunk(noisy)
        dec = FvcDecoder()
        out1, _ = dec.decode_chunk(c1)
        out2, _ = dec.decode_chunk(c2)
        assert out1.shape == (4, 64, 64, 3)
        assert out2.shape == (4, 64, 64, 3)


def test_dispatch_with_fused_overlay_burns_in():
    import io
    import jax.numpy as jnp
    from PIL import Image
    from flutpu.codec.jpeg import JpegEncoder, _pad_to
    from flutpu.core.elements import make_test_frame
    h, w = 64, 128
    frames = np.stack([make_test_frame("gradient", w, h, i)
                       for i in range(2)])
    fdev = jnp.asarray(np.pad(
        frames, ((0, 0), (0, _pad_to(h, 16) - h), (0, _pad_to(w, 16) - w),
                 (0, 0)), mode="edge"))
    ov = np.zeros((h, w, 4), np.uint8)
    ov[10:20, 10:60] = (0, 0, 255, 255)  # opaque red box (BGRA)
    enc = JpegEncoder(quality=85, engine="auto")
    outs = enc.encode_gop_finalize(
        enc.encode_gop_dispatch(fdev, h, w, overlay=jnp.asarray(ov)))
    img = np.asarray(Image.open(io.BytesIO(outs[0])).convert("RGB"))
    box = img[12:18, 15:55]
    assert box[..., 0].mean() > 150 and box[..., 2].mean() < 100
    # outside the overlay the frame still matches the source
    ref = frames[0].astype(np.float64)
    mse = ((ref[30:, :] - img[30:, :].astype(np.float64)) ** 2).mean()
    assert 10 * np.log10(255 ** 2 / mse) > 35
