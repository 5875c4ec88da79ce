"""Microbench: the TTML device instance compositor in isolation.

Synthesizes a realistic instance stream (K intervals x N instances at
640x360) and times composite_instances_batch warm, forced by a scalar
fetch. Run with FLUTPU_CPU=1 for CPU.
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

K = 61          # intervals per batch (the bench_ttml shape)
N = 16          # instances per interval
W, H = 640, 360
T = 32          # atlas tiles


def make_stream(seed=0):
    rng = np.random.default_rng(seed)
    ints = np.zeros((K, N, 9), np.int32)
    cols = np.zeros((K, N, 4), np.float32)
    from flutpu.ttml.render.atlas import TILE_H, TILE_W
    for k in range(K):
        for i in range(N):
            x = int(rng.integers(-20, W - 40))
            y = int(rng.integers(-20, H - 40))
            w = int(rng.integers(16, TILE_W))
            h = int(rng.integers(8, TILE_H))
            ints[k, i] = (int(rng.integers(0, T)), x, y, w, h,
                          x, y, x + w, y + h)
            cols[k, i] = (*rng.random(3), 0.9)
    return ints, cols


def main():
    import jax
    import jax.numpy as jnp
    from flutpu.ttml.render.atlas import TILE_H, TILE_W
    from flutpu.ttml.render import device as D

    atlas = jnp.asarray(
        (np.random.default_rng(1).integers(0, 255, (T, TILE_H, TILE_W)))
        .astype(np.uint8))
    ints_np, cols_np = make_stream()
    ints, cols = jnp.asarray(ints_np), jnp.asarray(cols_np)

    for name in ("map", "vmap"):
        fn = (D.composite_instances_batch if name == "map"
              else D.composite_instances_batch_vmap)

        @jax.jit
        def forced(atlas, ints, cols, fn=fn):
            out = fn(atlas, ints, cols, window_h=H, window_w=W)
            return out.astype(jnp.int32).sum()

        np.asarray(forced(atlas, ints, cols))  # compile
        reps = 3
        t0 = time.time()
        for _ in range(reps):
            np.asarray(forced(atlas, ints, cols))
        ms = (time.time() - t0) / reps * 1000.0
        print(json.dumps({"metric": f"compositor_batch_ms_{name}",
                          "value": round(ms, 1), "unit": f"ms/{K}x{N}",
                          "ms_per_interval": round(ms / K, 2)}), flush=True)


if __name__ == "__main__":
    main()
