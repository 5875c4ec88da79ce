"""Rate-distortion sweep: the codec-selection data (round-5 verdict #4).

The round-4 config table showed fvc-motion at 400.2 KB/GOP vs v1's 360.1
on the 1080p bench content — "slower AND bigger" — while the q-sweep said
motion trades ~2 dB for the smallest streams on moving content. Equal-q
comparisons are meaningless across codecs (the same q lands on different
rate-quality points once prediction changes the residual statistics);
this sweep produces the MATCHED comparisons:

  * size at equal PSNR (interpolated on each codec's RD curve)
  * PSNR at equal size

for v1 (intra-only) / motion / motion+B on three contents — clean
near-static, clean moving, noisy moving — plus the 1080p bench content
itself at q85 for the reconciliation row. Outputs one JSON line per
measurement plus a markdown table on stderr for PERF.md / docs/GUIDE.md.

Quality metrics are backend-deterministic (encoder outputs are
bit-identical across backends — tests/test_fvc.py device-vs-host), so
this runs on CPU: FLUTPU_CPU=1 python benches/rd_sweep.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("FLUTPU_CPU"):
    import jax
    jax.config.update("jax_platforms", "cpu")

from flutpu.platform import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402

QS = (60, 70, 80, 85, 90, 95)
GOP = 8


def contents(w=640, h=384):
    from flutpu.core.elements import make_test_frame
    rng = np.random.default_rng(7)
    ball = np.stack([make_test_frame("ball", w, h, i) for i in range(GOP)])
    grad = np.stack([make_test_frame("gradient", w, h, i)
                     for i in range(GOP)])
    noisy = np.clip(ball.astype(np.int16)
                    + rng.normal(0, 6, ball.shape), 0, 255).astype(np.uint8)
    # camera pan over detail — the classic MC case: every pixel moves
    # coherently by an integer vector, so v1's coefficient residuals are
    # dense while one motion vector per macroblock captures it all.
    # Texture = smoothed noise (detail at DCT-relevant scales).
    base = make_test_frame("noise", w, h, 0).astype(np.float32)
    k = np.ones((3, 3)) / 9.0
    for c in range(base.shape[-1]):
        from numpy.lib.stride_tricks import sliding_window_view
        pad = np.pad(base[..., c], 1, mode="wrap")
        base[..., c] = (sliding_window_view(pad, (3, 3)) * k).sum((-1, -2))
    base = base.astype(np.uint8)
    pan = np.stack([np.roll(base, (2 * i, 3 * i), axis=(0, 1))
                    for i in range(GOP)])
    pan_noisy = np.clip(pan.astype(np.int16)
                        + rng.normal(0, 4, pan.shape), 0,
                        255).astype(np.uint8)
    return {
        "static": grad,    # global luma step, zero spatial motion
        "moving": ball,    # small object, subpixel motion, noise-free
        "noisy": noisy,    # object motion + sensor-like noise
        "pan": pan,        # integer global pan over texture
        "pan_noisy": pan_noisy,  # pan + sensor noise
    }


CODECS = {
    "v1": dict(motion=False),
    "motion": dict(motion=True),
    "motion_b2": dict(motion=True, bframes=2),
}


def measure(frames, q, kw):
    from flutpu.codec.fvc import FvcDecoder, FvcEncoder
    from flutpu.codec.jpeg import psnr
    chunk = FvcEncoder(quality=q, **kw).encode_chunk(frames)
    dec, _ = FvcDecoder().decode_chunk(chunk)
    p = float(np.mean([psnr(frames[i], dec[i])
                       for i in range(len(frames))]))
    return len(chunk), p


def interp_size_at_psnr(curve, target):
    """curve: sorted [(size, psnr)] — size (log-interp) at target psnr."""
    pts = sorted(curve, key=lambda t: t[1])
    if target <= pts[0][1] or target >= pts[-1][1]:
        return None
    for (s0, p0), (s1, p1) in zip(pts, pts[1:]):
        if p0 <= target <= p1:
            f = (target - p0) / (p1 - p0) if p1 > p0 else 0.0
            return float(np.exp(np.log(s0) + f * (np.log(s1) - np.log(s0))))
    return None


def interp_psnr_at_size(curve, target):
    pts = sorted(curve)
    if target <= pts[0][0] or target >= pts[-1][0]:
        return None
    for (s0, p0), (s1, p1) in zip(pts, pts[1:]):
        if s0 <= target <= s1:
            f = (np.log(target) - np.log(s0)) / (np.log(s1) - np.log(s0)) \
                if s1 > s0 else 0.0
            return float(p0 + f * (p1 - p0))
    return None


def main():
    out = []
    curves = {}
    for cname, frames in contents().items():
        for codec, kw in CODECS.items():
            curve = []
            for q in QS:
                size, p = measure(frames, q, kw)
                curve.append((size, p))
                rec = {"metric": "rd_point", "content": cname,
                       "codec": codec, "q": q, "bytes_per_gop": size,
                       "psnr_db": round(p, 2)}
                print(json.dumps(rec), flush=True)
                out.append(rec)
            curves[(cname, codec)] = curve

    # matched comparisons per content: anchor = v1@q85
    print("\n| content | codec | KB/GOP @ v1-q85 PSNR | PSNR @ v1-q85 size |",
          file=sys.stderr)
    print("|---|---|---|---|", file=sys.stderr)
    for cname in contents():
        v1curve = curves[(cname, "v1")]
        anchor_size, anchor_psnr = v1curve[QS.index(85)]
        for codec in CODECS:
            c = curves[(cname, codec)]
            s = interp_size_at_psnr(c, anchor_psnr)
            p = interp_psnr_at_size(c, anchor_size)
            rec = {"metric": "rd_matched", "content": cname, "codec": codec,
                   "anchor_psnr_db": round(anchor_psnr, 2),
                   "anchor_kb": round(anchor_size / 1024, 1),
                   "kb_at_anchor_psnr":
                       round(s / 1024, 1) if s is not None else None,
                   "psnr_at_anchor_kb":
                       round(p, 2) if p is not None else None}
            print(json.dumps(rec), flush=True)
            print(f"| {cname} | {codec} | "
                  f"{rec['kb_at_anchor_psnr']} | {rec['psnr_at_anchor_kb']} |",
                  file=sys.stderr)

    # 1080p bench-content reconciliation row (q85 only: the round-4
    # config table compared KB/GOP at equal q — attach the PSNRs that
    # make that comparison interpretable)
    if not os.environ.get("RD_SKIP_1080P"):
        import jax.numpy as jnp
        from flutpu.codec.ops.testsrc import gradient_ball_planes
        r, g, b = gradient_ball_planes(1088, 1920, GOP, jnp.float32(0))
        frames = np.stack([np.asarray(r), np.asarray(g),
                           np.asarray(b)], axis=-1).astype(np.uint8)
        for codec, kw in CODECS.items():
            size, p = measure(frames, 85, kw)
            rec = {"metric": "rd_bench_content_1080p", "codec": codec,
                   "q": 85, "kb_per_gop": round(size / 1024, 1),
                   "psnr_db": round(p, 2)}
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
