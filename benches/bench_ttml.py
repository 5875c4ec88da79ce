"""BASELINE config 1: TTML parse + render to overlay frames.

Measures ms/interval for the three render engines on the current backend:
  - atlas:  glyph-atlas device rasterization (instance compositor)
  - layers: host-drawn region layers + device composite
  - host:   pure CPU (the measured reference baseline)

The device engines are timed WITHOUT per-interval host fetches (one
block_until_ready at the end): in the production pipeline overlays stay
on-device for GOP burn-in and only encoded bits are fetched.

Run: python benches/bench_ttml.py  (FLUTPU_CPU=1 for the CPU backend)
Prints one JSON line per engine.
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

N_INTERVALS = 60  # one subtitle change per second over the 60 s clip
W, H = 640, 360   # BASELINE config 1 geometry


def _chk_impl(*fs):
    import jax.numpy as jnp
    return sum(f[0, 0, 3].astype(jnp.int32) for f in fs)


def _chk(*fs):
    import jax
    global _chk_jit
    if "_chk_jit" not in globals():
        _chk_jit = jax.jit(_chk_impl)
    return _chk_jit(*fs)


def make_doc(n: int) -> str:
    """n disjoint 1 s intervals across two styled regions (typical
    broadcast subtitle shape: text + translation, outline, colors)."""
    ps = []
    for i in range(n):
        ps.append(
            f'<p begin="{i}s" end="{i + 1}s" region="bottom" '
            f'tts:color="white" tts:textOutline="black 2px">'
            f'Subtitle line {i} with some longer text content</p>')
        ps.append(
            f'<p begin="{i}s" end="{i + 1}s" region="top" '
            f'tts:color="yellow">Speaker {i % 4}</p>')
    return f"""<?xml version="1.0"?>
<tt xmlns="http://www.w3.org/ns/ttml"
    xmlns:tts="http://www.w3.org/ns/ttml#styling">
  <head><layout>
    <region xml:id="top" tts:origin="5% 5%" tts:extent="90% 15%"/>
    <region xml:id="bottom" tts:origin="5% 75%" tts:extent="90% 20%"
            tts:backgroundColor="#00000080"/>
  </layout></head>
  <body><div>
    {chr(10).join(ps)}
  </div></body>
</tt>"""


def make_vertical_doc(n: int) -> str:
    """n 1 s intervals in a tbrl vertical region (round-3: vertical modes
    ride the device atlas path — pre-rotated tiles — instead of silently
    reverting to the host layer path)."""
    ps = [f'<p begin="{i}s" end="{i + 1}s" region="v" '
          f'tts:color="white">Vertical {i}</p>' for i in range(n)]
    return f"""<?xml version="1.0"?>
<tt xmlns="http://www.w3.org/ns/ttml"
    xmlns:tts="http://www.w3.org/ns/ttml#styling">
  <head><layout>
    <region xml:id="v" tts:origin="70% 10%" tts:extent="25% 80%"
            tts:writingMode="tbrl" tts:backgroundColor="#00004080"/>
  </layout></head>
  <body><div>
    {chr(10).join(ps)}
  </div></body>
</tt>"""


def bench_engine(engine: str, doc: str, tag: str = "") -> dict:
    import numpy as np
    from flutpu.core import Buffer, Harness

    device_out = engine != "host"  # overlays stay device-side (burn-in)

    def run() -> tuple:
        h_el = Harness(
            f"ttmlrender window-width={W} window-height={H} "
            f"render-engine={engine} "
            f"device-out={'true' if device_out else 'false'}")
        h_el.set_src_caps("application/ttml+xml")
        t0 = time.time()
        h_el.push(Buffer(doc.encode(), pts=0))
        h_el.push_eos()
        # the chain is synchronous: after push_eos every output buffer is
        # already queued — drain without a blocking tail timeout (a 2 s
        # final try_pull would bake +33 ms/interval into every engine)
        frames = []
        while True:
            b = h_el.try_pull(timeout=0.001)
            if b is None:
                break
            frames.append(b)
        if device_out:
            import numpy as _np
            # Force execution of every frame's producing program with ONE
            # scalar fetch: a checksum program taking all frames as inputs.
            # block_until_ready on large un-fetched outputs does not
            # reliably force execution on the remote backend, and per-array
            # fetches cost a ~30 ms link round trip each. (_chk is a
            # module-level jit so the warm run's compile is reused.)
            _np.asarray(_chk(*[b.data for b in frames]))
        dt = time.time() - t0
        h_el.teardown()
        return frames, dt

    frames, _ = run()      # warm: compiles + atlas population
    n_warm = len(frames)
    frames, dt = run()     # measured (atlas + compile caches hot)
    assert len(frames) == n_warm and n_warm >= N_INTERVALS, len(frames)
    alpha = np.asarray(frames[0].data)[..., 3]
    assert alpha.any(), "blank overlay"
    return {"metric": f"ttml_render_ms_per_interval_{engine}{tag}",
            "value": round(dt / len(frames) * 1000.0, 2),
            "unit": "ms/interval",
            "intervals": len(frames)}


def main():
    doc = make_doc(N_INTERVALS)
    results = {}
    for engine in ("host", "layers", "atlas"):
        r = bench_engine(engine, doc)
        results[engine] = r["value"]
        print(json.dumps(r), flush=True)
    if results.get("atlas") and results.get("host"):
        print(json.dumps({
            "metric": "ttml_render_speedup_atlas_vs_host",
            "value": round(results["host"] / results["atlas"], 2),
            "unit": "x"}), flush=True)
    # vertical-writing stream: previously excluded from the device path
    vdoc = make_vertical_doc(N_INTERVALS)
    print(json.dumps(bench_engine("atlas", vdoc, tag="_vertical")),
          flush=True)


if __name__ == "__main__":
    main()
