#!/usr/bin/env python
"""Smoke test of flutpu's encode path on the GPU.

Drives the main path once through the entry points a user calls, at full
1080p width (coded 1088x1920, 4:2:0, quality 85), and checks what comes
out by the repo's own means: host decodes, PSNR against the source, and
the plain references the kernels and the card's numerics are held to.

Phases (one process, one card):
  1 device    the card, the native library, PIL
  2 hype      hype JPEG pipeline (parse_launch → 2 tpujpegenc branches →
              appsink): pts order, host decode PSNR, GPU vs CPU encode
  3 packer    the Pallas/Triton entropy packer vs its scan reference,
              bit for bit at 1080p x16 and 4K x1, both layouts; the JPEG
              dispatch program end to end with each packer and layout
  4 frontend  8x8 vs block-diagonal DCT front end at 1080p and 4K, with
              and without an overlay; burn-in through the dispatch program
  5 fvc       FVC v1, motion, motion + B at 1080p x16: GPU encode decoded
              on the host vs the encoder's own reconstruction and vs a CPU
              encode; XLA motion-search time per frame
  6 tpuhype   tpuhype on one card, codec=jpeg and codec=fvc-motion

``--cards 4`` runs only the multi-card path instead: tpuhype over a
4-card chunk mesh, and fvc_chunks_sharded over a 2x2 chunk x spatial mesh,
each compared byte for byte with the 1-card encode of the same chunks.

Each phase prints one JSON line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Any failed check exits non-zero before that line. Without a GPU it exits
non-zero and prints no result.

Run: python chip_smoke.py [--cards 4]
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

W, H = 1920, 1080
PH, PW = 1088, 1920
Q = 85
# (coded height, width, frames) of each measured shape
PACKER_SHAPES = {"1080p_x16": (PH, PW, 16), "4k_x1": (2176, 3840, 1)}
FRONTEND_SHAPES = {"1080p_x16": (PH, PW, 16), "4k_x4": (2160, 3840, 4)}


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def card_line() -> str:
    """The card's name and power limit, read by a child that stays off
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def card_field():
    """CARD as one JSON-friendly string (one entry per card)."""
    return "; ".join(CARD.splitlines())


CARD = None


def emit(phase, t0, setup_s, **fields):
    rec = {"phase": phase, "wall_s": round(time.perf_counter() - t0, 3),
           "compile_s": round(setup_s, 3), "card": card_field()}
    rec.update(fields)
    print(json.dumps(rec), flush=True)


def timed(fn, *args, reps=5):
    """(cold seconds incl. compile, best warm milliseconds) of fn(*args)."""
    import jax
    t = time.perf_counter()
    jax.block_until_ready(fn(*args))
    cold = time.perf_counter() - t
    best = float("inf")
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t)
    return cold, best * 1e3


def psnr(a, b):
    from flutpu.codec.jpeg import psnr as _psnr
    return float(_psnr(a, b))


def cpu():
    import jax
    return jax.devices("cpu")[0]


def jpeg_coefs_host(data: bytes):
    """Native host decode of our JFIF: (coefficient planes, RGB)."""
    import jax
    import jax.numpy as jnp
    from flutpu.codec.decode import coefs_to_rgb, decode_scan_to_coefs
    from flutpu.codec.decoders import parse_jfif
    info = parse_jfif(data)
    check(info is not None, "unparseable JFIF")
    h, w = info["h"], info["w"]
    ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
    coefs = decode_scan_to_coefs(info["scan"], pw // 8, ph // 8, pw // 16,
                                 ph // 16, True)
    check(coefs is not None, "native scan decode failed")
    with jax.default_device(cpu()):
        rgb = coefs_to_rgb(*(jnp.asarray(c) for c in coefs),
                           jnp.asarray(info["qtables"][0]),
                           jnp.asarray(info["qtables"][1]), h=h, w=w)
        return coefs, np.asarray(rgb)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device():
    import jax
    t0 = time.perf_counter()
    from flutpu import native
    try:
        import PIL  # noqa: F401
        pil = True
    except ImportError:
        pil = False
    from flutpu import platform
    dev = jax.devices()[0]
    emit("device", t0, 0.0, platform=dev.platform,
         kind=platform.device_kind(), count=len(jax.devices()),
         native=native.get_lib() is not None, pil=pil, jax=jax.__version__)
    check(native.get_lib() is not None, "native host library did not load")


def run_pipeline(desc, timeout=600):
    from flutpu.core import parse_launch
    p = parse_launch(desc)
    sink = p.get_by_name("out")
    p.play()
    bufs = []
    deadline = time.time() + timeout
    while time.time() < deadline:
        b = sink.try_pull_buffer(timeout=120)
        if b is None:
            break
        bufs.append(b)
    p.stop()
    return bufs


def phase_hype():
    import jax
    from flutpu.codec.jpeg import JpegEncoder
    from flutpu.core.elements import make_test_frame
    t0 = time.perf_counter()
    n = 48
    desc = (f"videotestsrc num-buffers={n} pattern=ball width={W} "
            f"height={H} ! hype gop-size=8 encoder-1=tpujpegenc "
            f"encoder-2=tpujpegenc ! appsink name=out")
    bufs = run_pipeline(desc)
    wall = time.perf_counter() - t0
    check(len(bufs) == n, f"hype returned {len(bufs)} of {n} frames")
    pts = [b.pts for b in bufs]
    check(all(a < b for a, b in zip(pts, pts[1:])), "pts out of order")
    src = [make_test_frame("ball", W, H, i) for i in range(n)]
    gpu_psnr = []
    for i, b in enumerate(bufs):
        _, rgb = jpeg_coefs_host(bytes(b.data))
        gpu_psnr.append(psnr(rgb, src[i]))
    check(min(gpu_psnr) > 30.0, f"hype PSNR too low: {min(gpu_psnr)}")
    # the same frames through the CPU encoder: coefficients and PSNR
    frames = np.stack(src[:8])
    with jax.default_device(cpu()):
        cpu_jpegs = JpegEncoder(quality=Q, engine="host").encode_gop(frames)
    differ = total = 0
    cpu_psnr = []
    for i in range(8):
        cg, _ = jpeg_coefs_host(bytes(bufs[i].data))
        cc, rgb_c = jpeg_coefs_host(cpu_jpegs[i])
        for a, b in zip(cg, cc):
            differ += int((a != b).sum())
            total += a.size
        cpu_psnr.append(psnr(rgb_c, src[i]))
    share = differ / total
    dpsnr = max(abs(a - b) for a, b in zip(gpu_psnr[:8], cpu_psnr))
    emit("hype", t0, 0.0, frames=n, fps_incl_compile=round(n / wall, 2),
         psnr_min=round(min(gpu_psnr), 3), coef_share_differ_vs_cpu=share,
         psnr_gap_vs_cpu_db=round(dpsnr, 4))
    check(share < 1e-3, f"GPU vs CPU coefficients differ in {share:.2e}")
    check(dpsnr < 0.1, f"GPU vs CPU PSNR gap {dpsnr:.3f} dB")


def _mcu(yq, cbq, crq, seg_g):
    import jax
    import jax.numpy as jnp
    from flutpu.codec.ops import entropy as E
    f, bh, bw = yq.shape[:3]
    layout = E.mcu_layout(bw, bh, bw // 2, bh // 2, True)
    mcu, comp = jax.jit(lambda a, b, c: E._mcu_blocks(a, b, c, layout))(
        yq, cbq, crq)
    zz = mcu.reshape(-1, 64)
    comp = jnp.tile(comp, f)
    pad = -zz.shape[0] % seg_g
    return (jnp.pad(zz, ((0, pad), (0, 0))),
            jnp.pad(comp, (0, pad), constant_values=-1))


def _coefs(ph, pw, n):
    import jax.numpy as jnp
    from flutpu.codec.jpeg import JpegEncoder, encode_gop_planes_to_coefs
    from flutpu.codec.ops.testsrc import gradient_ball_planes
    enc = JpegEncoder(quality=Q)
    r, g, b = gradient_ball_planes(ph, pw, n, jnp.float32(0))
    return encode_gop_planes_to_coefs(r, g, b, enc._qy_dev, enc._qc_dev,
                                      pad_h=ph, pad_w=pw)


def _jpeg_fps(use_pallas, segmented, gops=6, n=16):
    """1080p JPEG through encode_gop_dispatch_src/encode_gop_finalize
    with the on-device source: (fps, bytes of the last GOP)."""
    import jax.numpy as jnp
    from flutpu.codec.jpeg import JpegEncoder
    from flutpu.codec.ops.testsrc import gradient_ball_planes
    enc = JpegEncoder(quality=Q, use_pallas=use_pallas, segmented=segmented)

    def src(ph, pw, start):
        return gradient_ball_planes(ph, pw, n, start)

    for g in range(2):   # compile + adopt the adaptive window
        enc.encode_gop_finalize(enc.encode_gop_dispatch_src(
            src, jnp.float32(g * n), H, W, PH, PW))
    t = time.perf_counter()
    prev = None
    out = None
    for g in range(gops):
        h = enc.encode_gop_dispatch_src(src, jnp.float32(g * n), H, W,
                                        PH, PW)
        if prev is not None:
            out = enc.encode_gop_finalize(prev)
        prev = h
    out = enc.encode_gop_finalize(prev)
    return gops * n / (time.perf_counter() - t), out


def phase_packer():
    import jax
    from flutpu.codec.ops import entropy as E
    from flutpu.codec.ops.pack_kernel import pack_segments
    t0 = time.perf_counter()
    setup = 0.0
    res = {}
    for name, (ph, pw, n) in PACKER_SHAPES.items():
        yq, cbq, crq = _coefs(ph, pw, n)
        for seg_g, nw in ((1, 64), (16, 128)):
            zz, comp = _mcu(yq, cbq, crq, seg_g)
            k = jax.jit(lambda z, c, g=seg_g, w=nw: pack_segments(
                z, c, seg_g=g, n_words=w))
            s = jax.jit(lambda z, c, g=seg_g, w=nw: E._pack_segments_scan(
                z, c, g, w))
            kb, kn = k(zz, comp)
            sb, sn = s(zz, comp)
            same = bool(np.array_equal(np.asarray(kn), np.asarray(sn))
                        and np.array_equal(np.asarray(kb), np.asarray(sb)))
            check(same, f"packer differs from scan: {name} seg_g={seg_g}")
            # in turns: kernel, scan, scan, kernel
            c1, k1 = timed(k, zz, comp)
            c2, s1 = timed(s, zz, comp)
            _, s2 = timed(s, zz, comp)
            _, k2 = timed(k, zz, comp)
            setup += c1 + c2
            res[f"{name}_seg{seg_g}"] = {
                "identical": same, "kernel_ms": [k1, k2],
                "scan_ms": [s1, s2], "blocks": int(zz.shape[0])}
    # the whole 1080p x16 dispatch program, and its memory
    from flutpu.codec.jpeg import JpegEncoder, _gop_dispatch_program_src
    from flutpu.codec.ops.testsrc import gradient_ball_planes
    import jax.numpy as jnp
    enc = JpegEncoder(quality=Q)
    layout = E.mcu_layout(PW // 8, PH // 8, PW // 16, PH // 16, True)
    src = lambda ph, pw, start: gradient_ball_planes(ph, pw, 16, start)  # noqa
    lowered = _gop_dispatch_program_src.lower(
        jnp.float32(0), enc._qy_dev, enc._qc_dev, None, src, pad_h=PH,
        pad_w=PW, subsample=True, layout=layout, prefix_words=32768,
        use_pallas=True, seg_words=None)
    ma = lowered.compile().memory_analysis()
    mem = {k: getattr(ma, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")}
    # end to end on the JPEG phase: packer x layout, in turns
    e2e = {}
    ref = None
    arms = [(True, False), (False, False), (True, True), (False, True)]
    for up, seg in arms + arms[::-1]:
        fps, out = _jpeg_fps(up, seg)
        key = f"{'kernel' if up else 'scan'}_{'segment' if seg else 'block'}"
        e2e.setdefault(key, []).append(round(fps, 2))
        if ref is None:
            ref = out
        check(out == ref, f"JPEG bytes differ for arm {key}")
    emit("packer", t0, setup, results=res, dispatch_memory=mem,
         jpeg_1080p_x16_fps=e2e)


def phase_frontend():
    import jax
    import jax.numpy as jnp
    from flutpu.codec.jpeg import (JpegEncoder, encode_gop_planes_to_coefs)
    from flutpu.codec.ops.testsrc import gradient_ball_planes
    from flutpu.ttml.render import overlay_on_planes
    t0 = time.perf_counter()
    setup = 0.0
    enc = JpegEncoder(quality=Q)
    res = {}
    for name, (ph, pw, n) in FRONTEND_SHAPES.items():
        r, g, b = gradient_ball_planes(ph, pw, n, jnp.float32(0))
        ov = np.zeros((ph, pw, 4), np.uint8)
        ov[ph * 3 // 4:ph * 7 // 8, pw // 4:3 * pw // 4] = 255
        ov = jnp.asarray(ov)
        outs = {}
        for planar in (False, True):
            for burn in (False, True):
                def fe(r, g, b, ov, planar=planar, burn=burn):
                    if burn:
                        r, g, b = overlay_on_planes(r, g, b, ov)
                    return encode_gop_planes_to_coefs(
                        r, g, b, enc._qy_dev, enc._qc_dev, pad_h=ph,
                        pad_w=pw, planar=planar)
                f = jax.jit(fe)
                cold, ms = timed(f, r, g, b, ov)
                setup += cold
                key = f"{'planar' if planar else '8x8'}" \
                      f"{'_overlay' if burn else ''}"
                res[f"{name}_{key}_ms"] = ms
                outs[key] = [np.asarray(x) for x in f(r, g, b, ov)]
        diff = sum(int((a != b).sum()) for a, b in zip(outs["8x8"],
                                                       outs["planar"]))
        tot = sum(a.size for a in outs["8x8"])
        res[f"{name}_8x8_vs_planar_share_differ"] = diff / tot
        check(diff / tot < 1e-3, f"{name}: DCT forms disagree")
    # burn-in through the dispatch program's overlay argument
    y0, y1, x0, x1 = H * 5 // 6, H * 5 // 6 + 64, W // 4, W * 3 // 4
    ov = np.zeros((PH, PW, 4), np.uint8)
    ov[y0:y1, x0:x1] = 255                             # opaque white box
    jenc = JpegEncoder(quality=Q)
    src = lambda ph, pw, start: gradient_ball_planes(ph, pw, 8, start)  # noqa
    out = jenc.encode_gop_finalize(jenc.encode_gop_dispatch_src(
        src, jnp.float32(0), H, W, PH, PW, overlay=jnp.asarray(ov)))
    _, rgb = jpeg_coefs_host(out[0])
    box = float(rgb[y0 + 8:y1 - 8, x0 + 8:x1 - 8].mean())
    frame0 = np.stack([np.asarray(p[0]) for p in src(PH, PW, 0.0)], -1)
    outside = psnr(rgb[:y0 - 16], frame0[:y0 - 16])
    emit("frontend", t0, setup, results=res, burnin_box_mean=box,
         burnin_psnr_outside=round(outside, 3))
    check(box > 240, f"burn-in box not visible (mean {box})")
    check(outside > 30, f"burn-in frame PSNR {outside}")


def phase_fvc():
    import jax
    import jax.numpy as jnp
    from flutpu.codec.fvc import FvcDecoder, FvcEncoder
    from flutpu.codec.ops.motion import motion_search
    from flutpu.codec.ops.testsrc import gradient_ball_frames
    t0 = time.perf_counter()
    setup = 0.0
    frames = np.asarray(gradient_ball_frames(H, W, 16, jnp.float32(0)))
    res = {}
    for name, kw in {"v1": {}, "motion": {"motion": True},
                     "motion_b1": {"motion": True, "bframes": 1}}.items():
        enc = FvcEncoder(quality=Q, **kw)
        t = time.perf_counter()
        data = enc.encode_chunk(frames)
        enc.encode_chunk(frames)        # adopts the adaptive window
        setup += time.perf_counter() - t
        t = time.perf_counter()
        data2 = enc.encode_chunk(frames)
        warm = time.perf_counter() - t
        check(data == data2, f"FVC {name}: encode not deterministic")
        dec_gpu, _ = FvcDecoder().decode_chunk(data)      # encoder's recon
        with jax.default_device(cpu()):
            dec_host, info = FvcDecoder().decode_chunk(data)
            cpu_data = FvcEncoder(quality=Q, engine="host",
                                  **kw).encode_chunk(frames)
            dec_cpu, _ = FvcDecoder().decode_chunk(cpu_data)
        maxdiff = int(np.abs(dec_host.astype(np.int16)
                             - dec_gpu.astype(np.int16)).max())
        p_gpu = psnr(dec_host, frames)
        p_cpu = psnr(dec_cpu, frames)
        res[name] = {"bytes": len(data), "cpu_bytes": len(cpu_data),
                     "encode_ms_warm": round(warm * 1e3, 3),
                     "types": info["types"],
                     "host_vs_recon_max_diff": maxdiff,
                     "psnr_gpu": round(p_gpu, 4), "psnr_cpu": round(p_cpu, 4)}
        check(maxdiff <= 1, f"FVC {name}: host decode drifts by {maxdiff}")
        check(abs(p_gpu - p_cpu) <= 0.1,
              f"FVC {name}: PSNR {p_gpu:.3f} vs CPU {p_cpu:.3f}")
    # the XLA full search per 1080p frame (the Hopper kernel's baseline)
    y = jnp.asarray(frames[..., 1].astype(np.float32))
    cur = jnp.pad(y[1], ((0, PH - H), (0, 0)))
    prev = jnp.pad(y[0], ((0, PH - H), (0, 0)))
    cold, ms = timed(lambda a, b: motion_search(a, b, search_range=7),
                     cur, prev)
    setup += cold
    emit("fvc", t0, setup, results=res, motion_search_xla_ms_per_frame=ms)


def phase_tpuhype():
    import jax
    from flutpu.codec.fvc import FvcDecoder
    from flutpu.core.elements import make_test_frame
    t0 = time.perf_counter()
    n = 16
    src = np.stack([make_test_frame("ball", W, H, i) for i in range(n)])
    res = {}
    for codec in ("jpeg", "fvc-motion"):
        bufs = run_pipeline(
            f"videotestsrc num-buffers={n} pattern=ball width={W} "
            f"height={H} ! tpuhype gop-size=8 codec={codec} "
            f"! appsink name=out")
        if codec == "jpeg":
            check(len(bufs) == n, f"tpuhype jpeg: {len(bufs)} frames")
            ps = [psnr(jpeg_coefs_host(bytes(b.data))[1], src[i])
                  for i, b in enumerate(bufs)]
        else:
            check(len(bufs) == n // 8, f"tpuhype fvc: {len(bufs)} chunks")
            with jax.default_device(cpu()):
                dec = FvcDecoder().decode_stream(
                    b"".join(bytes(b.data) for b in bufs))
            ps = [psnr(dec[i], src[i]) for i in range(n)]
        res[codec] = {"outputs": len(bufs), "psnr_min": round(min(ps), 3)}
        check(min(ps) > 30, f"tpuhype {codec}: PSNR {min(ps)}")
    emit("tpuhype", t0, 0.0, results=res)


def phase_cards(n_cards):
    """The reference's parallelism across cards: hype's GOP chunks, one
    per card, compared byte for byte with the 1-card encode."""
    import jax
    import jax.numpy as jnp
    from flutpu.codec.ops.quant import (CHROMA_QTABLE, LUMA_QTABLE,
                                        scale_qtable)
    from flutpu.parallel.gop import fvc_chunks_sharded
    from flutpu.parallel.mesh import make_chunk_mesh, make_chunk_spatial_mesh
    t0 = time.perf_counter()
    check(len(jax.devices()) >= n_cards,
          f"{len(jax.devices())} cards, need {n_cards}")
    res = {}
    n = 8 * n_cards
    for codec in ("jpeg", "fvc-motion"):
        desc = (f"videotestsrc num-buffers={n} pattern=ball width={W} "
                f"height={H} ! tpuhype gop-size=8 codec={codec} chunks=%d "
                f"! appsink name=out")
        multi = [bytes(b.data) for b in run_pipeline(desc % n_cards)]
        single = [bytes(b.data) for b in run_pipeline(desc % 1)]
        same = multi == single
        res[f"tpuhype_{codec}"] = {"outputs": len(multi), "identical": same}
        check(same and len(multi) > 0,
              f"tpuhype {codec}: {n_cards}-card output differs from 1 card")
    # 2x2 chunk x spatial: ring-ppermute halos become NCCL collectives
    qy = jnp.asarray(scale_qtable(LUMA_QTABLE, Q))
    qc = jnp.asarray(scale_qtable(CHROMA_QTABLE, Q))
    from flutpu.codec.ops.testsrc import gradient_ball_planes
    chunks = [gradient_ball_planes(PH, PW, 8, jnp.float32(8 * c))
              for c in range(2)]
    planes = tuple(np.stack([np.asarray(ch[k]) for ch in chunks])
                   for k in range(3))                 # each (2, 8, PH, PW)
    mesh4 = make_chunk_spatial_mesh(2, 2, jax.devices()[:4])
    mesh1 = make_chunk_mesh(devices=jax.devices()[:1])
    spatial = fvc_chunks_sharded(tuple(jnp.asarray(p) for p in planes),
                                 qy, qc, mesh=mesh4, motion=True,
                                 spatial=True)
    ref = [[], [], [], [], []]
    for c in range(2):
        out = fvc_chunks_sharded(
            tuple(jax.device_put(p[c:c + 1], jax.devices()[0])
                  for p in planes), qy, qc, mesh=mesh1, motion=True)
        for i, o in enumerate(out):
            ref[i].append(np.asarray(o))
    same = all(np.array_equal(np.asarray(a), np.concatenate(b))
               for a, b in zip(spatial, ref))
    res["fvc_spatial_2x2"] = {"identical": same}
    emit("cards", t0, 0.0, cards=n_cards, results=res)
    check(same, "2x2 chunk x spatial FVC differs from the 1-card encode")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="4: run only the multi-card path")
    args = ap.parse_args()

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    from flutpu import platform
    platform.enable_compile_cache()
    global CARD
    CARD = card_line()
    print(f"card: {CARD}", flush=True)
    phase_device()
    if args.cards > 1:
        phase_cards(args.cards)
    else:
        phase_hype()
        phase_packer()
        phase_frontend()
        phase_fvc()
        phase_tpuhype()
    print(f"card: {CARD}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": platform.device_kind(),
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
