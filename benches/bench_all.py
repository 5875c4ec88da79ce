"""Secondary benchmarks — the BASELINE.json configs beyond the headline
encode number (bench.py stays the driver's single-line entry point).

Prints one JSON line per config:
  1. fluttml: TTML parse + render to ARGB overlays (ms/frame)
  2. injectbin: mid-stream swap latency in a running pipeline
  3. hype: 1080p30 8-chunk parallel encode + stitch (fps) — see bench.py
  4. 4K fused conversion+DCT+quant throughput (fps)
  5. full pipeline: encode + subtitle burn-in (fps)

Run: python benches/bench_all.py   (FLUTPU_CPU=1 to force CPU)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("FLUTPU_CPU"):
    import jax
    jax.config.update("jax_platforms", "cpu")


from flutpu.platform import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np


def report(metric, value, unit, **extra):
    print(json.dumps({"metric": metric, "value": round(value, 3),
                      "unit": unit, **extra}), flush=True)


def bench_ttml_render(n_cues=40, w=640, h=360):
    """Config 1: parse + render a many-cue TTML doc; ms per interval frame
    DELIVERED TO HOST (device-out=false — each interval pays a fetch;
    benches/bench_ttml.py measures the on-device burn-in mode). A warm
    pass absorbs compiles + atlas population."""
    from flutpu.core import Buffer, Harness
    cues = "".join(
        f'<p begin="{i}s" end="{i + 1}s" region="r">Cue number {i} with some '
        f'<span tts:fontWeight="bold">styled</span> text</p>'
        for i in range(n_cues))
    doc = ("<?xml version='1.0'?>"
           "<tt xmlns='http://www.w3.org/ns/ttml' "
           "xmlns:tts='http://www.w3.org/ns/ttml#styling'><head><layout>"
           "<region xml:id='r' tts:origin='10% 75%' tts:extent='80% 20%' "
           "tts:backgroundColor='#00000080'/></layout></head><body><div>"
           + cues + "</div></body></tt>")

    def run():
        hns = Harness(f"ttmlrender window-width={w} window-height={h}")
        hns.set_src_caps("application/ttml+xml")
        t0 = time.time()
        hns.push(Buffer(doc.encode(), pts=0))
        hns.push_eos()
        frames = 0
        while hns.try_pull(timeout=0.001) is not None:
            frames += 1
        dt = time.time() - t0
        hns.teardown()
        return frames, dt

    run()                      # warm: compiles + atlas population
    frames, dt = run()
    report("ttml_render_ms_per_frame", dt / max(frames, 1) * 1000, "ms",
           frames=frames)


def bench_injectbin_swap(n=200):
    """Config 2: property-set → swap-complete latency under dataflow."""
    from flutpu.core import Buffer, MSECOND, parse_launch, make
    p = parse_launch("appsrc name=src caps='video/x-raw, format=RGB' "
                     "! injectbin name=ib ! appsink name=out")
    src, ib, sink = (p.get_by_name(x) for x in ("src", "ib", "out"))
    p.play()
    frame = np.zeros((32, 32, 3), np.uint8)
    lat = []
    for i in range(n):
        if i % 10 == 5:
            el = make("identity")
            t0 = time.perf_counter()
            done = []
            ib.connect_notify("element", lambda e, _p: done.append(
                time.perf_counter()))
            ib.set_property("element", el if (i // 10) % 2 == 0 else None)
            src.push(Buffer(frame, pts=i * MSECOND, offset=i))
            if done:
                lat.append((done[-1] - t0) * 1e3)
            ib._notify_cbs["element"].clear()
        else:
            src.push(Buffer(frame, pts=i * MSECOND, offset=i))
    src.end_of_stream()
    p.stop()
    report("injectbin_swap_latency_ms", float(np.mean(lat)), "ms",
           swaps=len(lat))


def bench_injectbin_swap_device(n=48, w=64, h=32, period_s=0.01):
    """Config 2b: swap a DEVICE encoder (tpujpegenc) into a live stream.

    The compile happens in Element.prewarm BEFORE the blocking probe is
    installed, so the stream keeps flowing while the program builds.
    Reports the prewarm cost (paid off the streaming path, on the caller
    thread) and the max observable output gap around the swap (bounded
    by queue depth + one GOP batch, NOT by compile time)."""
    import threading
    from flutpu.core import Buffer, MSECOND, parse_launch, make
    p = parse_launch(
        f"appsrc name=src caps='video/x-raw, format=RGB, width={w}, "
        f"height={h}' ! injectbin name=ib ! appsink name=out")
    src, ib, sink = (p.get_by_name(x) for x in ("src", "ib", "out"))
    p.play()
    frame = np.zeros((h, w, 3), np.uint8)
    arrivals = []
    pulled = []

    def puller():
        while True:
            b = sink.try_pull_buffer(timeout=10)
            if b is None:
                return
            arrivals.append(time.perf_counter())
            pulled.append(b)

    pt = threading.Thread(target=puller)
    pt.start()

    swap_done = threading.Event()

    def feeder():
        # keep the stream flowing through the compile, then `n` more
        # frames after the swap request so the probe fires and the new
        # encoder emits
        i = 0
        extra = 0
        while extra < n:
            src.push(Buffer(frame, pts=i * MSECOND, offset=i))
            i += 1
            if swap_done.is_set():
                extra += 1
            time.sleep(period_s)
        src.end_of_stream()

    ft = threading.Thread(target=feeder)
    ft.start()
    time.sleep(period_s * 10)  # mid-stream
    enc = make("tpujpegenc", batch_frames=8)
    t0 = time.perf_counter()
    ib.set_property("element", enc)   # prewarm (compile) happens in here
    prewarm_ms = (time.perf_counter() - t0) * 1e3
    swap_done.set()
    ft.join()
    pt.join()
    p.stop()
    gaps = np.diff(arrivals) * 1e3 if len(arrivals) > 1 else [0.0]
    jpegs = sum(1 for b in pulled if bytes(b.data[:2]) == b"\xff\xd8")
    report("injectbin_device_swap", float(np.max(gaps)), "ms_max_gap",
           prewarm_ms=round(prewarm_ms, 1), outputs=len(pulled),
           jpeg_outputs=jpegs)


def bench_4k_convert(frames=4, reps=5):
    """Config 4: 4K fused convert+DCT+quant+zigzag device throughput.

    The rep loop runs INSIDE one jitted program (lax.fori_loop) reduced
    to a scalar checksum, and the timed quantity is the scalar fetch."""
    import jax
    import jax.numpy as jnp
    from flutpu.codec.jpeg import JpegEncoder, _planes_front_end
    from flutpu.codec.ops.testsrc import gradient_ball_planes
    enc = JpegEncoder(quality=85)
    w, h = 3840, 2160

    @jax.jit
    def prog(start, qy, qc):
        def body(i, acc):
            r, g, b = gradient_ball_planes(h, w, frames, start + i * frames)
            y, cb, cr = _planes_front_end(
                r, g, b, qy, qc, pad_h=h, pad_w=w, subsample=True)
            return (acc + y.astype(jnp.int32).sum()
                    + cb.astype(jnp.int32).sum()
                    + cr.astype(jnp.int32).sum())
        return jax.lax.fori_loop(0, reps, body, jnp.int32(0))

    np.asarray(prog(jnp.float32(0), enc._qy_dev, enc._qc_dev))  # compile
    t0 = time.time()
    np.asarray(prog(jnp.float32(7), enc._qy_dev, enc._qc_dev))  # the fetch
    dt = time.time() - t0
    report("4k_convert_dct_quant_fps", frames * reps / dt, "frames/s")


# frames per dispatch: JPEG is intra-only, so this is purely a device
# batch — FLUTPU_BENCH_GOP amortizes the per-dispatch cost over more
# frames (per-frame JFIF output is byte-identical)
GOPF = int(os.environ.get("FLUTPU_BENCH_GOP", "16"))


def _ball_src8(ph, pw, start):
    # channel-planar source: byte-identical to the interleaved form
    from flutpu.codec.ops.testsrc import gradient_ball_planes
    return gradient_ball_planes(ph, pw, GOPF, start)


def bench_full_pipeline(gops=6, w=1920, h=1088, out_h=1080):
    """Config 5: encode + TTML burn-in — ONE fused device program per GOP
    (on-device synthesis → overlay blend → convert/DCT/quant → entropy
    pack) with two GOPs in flight so the fetch + host finalize overlap
    device compute. This is the same program shape as the headline bench.
    Pass w/h for the 4K variant."""
    import jax.numpy as jnp
    from flutpu.codec.jpeg import JpegEncoder
    from flutpu.core import Buffer, Harness

    h_el = Harness(f"ttmlrender window-width={w} window-height={h}")
    h_el.set_src_caps("application/ttml+xml")
    h_el.push(Buffer(
        b"<?xml version='1.0'?><tt xmlns='http://www.w3.org/ns/ttml'>"
        b"<body><div><p begin='0s' end='60s'>Burn-in subtitle</p></div>"
        b"</body></tt>", pts=0))
    h_el.push_eos()
    overlay = jnp.asarray(np.asarray(h_el.pull(timeout=30).data))
    h_el.teardown()

    enc = JpegEncoder(quality=85)
    def dispatch(g):
        return enc.encode_gop_dispatch_src(
            _ball_src8, jnp.float32(g * GOPF), out_h, w, h, w,
            overlay=overlay)
    enc.encode_gop_finalize(dispatch(0))  # compile + learn the estimate
    enc.encode_gop_finalize(dispatch(0))  # compile the adaptive program
    from concurrent.futures import ThreadPoolExecutor
    # threaded finalize: the fetch overlaps remote execution when issued
    # concurrently
    workers = int(os.environ.get("FLUTPU_BENCH_WORKERS", "3"))
    depth = int(os.environ.get("FLUTPU_BENCH_DEPTH", "8"))
    pool = ThreadPoolExecutor(max_workers=workers)
    # best-of-3 measurement rounds
    best_dt = float("inf")
    for _ in range(3):
        t0 = time.time()
        futs = []
        for g in range(gops):
            futs.append(pool.submit(enc.encode_gop_finalize, dispatch(g)))
            if len(futs) >= depth:
                futs.pop(0).result()
        for fu in futs:
            fu.result()
        best_dt = min(best_dt, time.time() - t0)
    pool.shutdown()
    name = "encode_plus_burnin_fps" if w < 3000 else "encode_plus_burnin_4k_fps"
    report(name, gops * GOPF / best_dt, "frames/s")


def bench_fvc(gops=6, motion=False, bframes=0):
    """Config 6: FVC GOP codec throughput at 1080p — source fused into the
    chunk program (encode_chunk_dispatch_src), two chunks in flight.
    ``bframes`` adds the bidirectional pass (config 6b)."""
    import jax.numpy as jnp
    from flutpu.codec.fvc import FvcEncoder
    from flutpu.codec.ops.testsrc import gradient_ball_frames

    enc = FvcEncoder(quality=85, motion=motion, bframes=bframes)

    def planar_src(ph, pw, n, start):
        # channel-planar source (round 4): i420 stage measured +7.3 ms/GOP
        # reading interleaved frames; planes are byte-identical
        from flutpu.codec.ops.testsrc import gradient_ball_planes
        return gradient_ball_planes(ph, pw, n, start)

    # FLUTPU_FVC_BATCH=B packs B independent chunks per dispatch (one
    # dispatch + one fetch per B*8 frames; byte-identical streams —
    # encode_chunk_batch_dispatch_src). Default 1.
    batch = int(os.environ.get("FLUTPU_FVC_BATCH", "1"))

    def dispatch(g):
        # the on-device testsrc traces INTO the chunk program: one dispatch
        # + one compressed fetch per GOP
        if batch > 1:
            return enc.encode_chunk_batch_dispatch_src(
                planar_src, jnp.float32(g * 8), 8, 1080, 1920, batch=batch)
        return enc.encode_chunk_dispatch_src(
            planar_src, jnp.float32(g * 8), 8, 1080, 1920)

    def finalize(h):
        if batch > 1:
            return b"".join(enc.encode_chunk_batch_finalize(h))
        return enc.encode_chunk_finalize(h)
    finalize(dispatch(0))   # compile + learn the estimate
    finalize(dispatch(0))   # compile the adaptive window
    from concurrent.futures import ThreadPoolExecutor
    # chunks in flight + finalize on worker threads (fetch overlaps
    # device execution when issued concurrently)
    workers = int(os.environ.get("FLUTPU_BENCH_WORKERS", "3"))
    depth = int(os.environ.get("FLUTPU_BENCH_DEPTH", "8"))
    pool = ThreadPoolExecutor(max_workers=workers)
    # best-of-3 measurement rounds
    dt = float("inf")
    for _ in range(3):
        t0 = time.time()
        total = 0
        futs = []
        for g in range(0, gops, batch):
            futs.append(pool.submit(finalize, dispatch(g)))
            if len(futs) >= depth:
                total += len(futs.pop(0).result())
        for fu in futs:
            total += len(fu.result())
        dt = min(dt, time.time() - t0)
    pool.shutdown()
    name = "fvc_motion_encode_fps" if motion else "fvc_encode_fps"
    if bframes:
        name = f"fvc_motion_b{bframes}_encode_fps"
    report(name, gops * 8 / dt, "frames/s",
           kbytes_per_gop=round(total / gops / 1024, 1))


def main():
    which = sys.argv[1:] or ["ttml", "inject", "4k", "full", "fvc"]
    if "ttml" in which:
        bench_ttml_render()
    if "inject" in which:
        bench_injectbin_swap()
        bench_injectbin_swap_device()
    if "4k" in which:
        bench_4k_convert()
    gops = int(os.environ.get("FLUTPU_BENCH_GOPS", "6"))
    if "full" in which:
        bench_full_pipeline(gops=gops)
    if "fvc" in which:
        bench_fvc(gops=gops)
        bench_fvc(gops=gops, motion=True)
    if "fvc-b" in which:
        bench_fvc(gops=gops, motion=True, bframes=1)
    if "full4k" in which:
        bench_full_pipeline(gops=2, w=3840, h=2160, out_h=2160)


if __name__ == "__main__":
    main()
