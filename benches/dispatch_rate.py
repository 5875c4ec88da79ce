"""Dispatch-rate experiment: how much of FVC v1's wall budget is the
per-dispatch cost, and does chunk batching
(encode_chunk_batch_dispatch_src) reclaim it? Prints issue + serial
finalize ms/chunk for single vs batch=2 dispatches.

Run: python benches/dispatch_rate.py"""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from flutpu.platform import enable_compile_cache
enable_compile_cache()
import jax.numpy as jnp
import numpy as np
from flutpu.codec.fvc import FvcEncoder
from flutpu.codec.ops.testsrc import gradient_ball_planes


def planar_src(ph, pw, n, start):
    return gradient_ball_planes(ph, pw, n, start)


def main():
    enc = FvcEncoder(quality=85)
    for rep in range(2):  # warm both program families + adaptive sizes
        h = enc.encode_chunk_dispatch_src(planar_src, jnp.float32(rep * 8),
                                          8, 1080, 1920)
        enc.encode_chunk_finalize(h)
        hb = enc.encode_chunk_batch_dispatch_src(
            planar_src, jnp.float32(rep * 16), 8, 1080, 1920, batch=2)
        enc.encode_chunk_batch_finalize(hb)

    t0 = time.time()
    handles = [enc.encode_chunk_dispatch_src(
        planar_src, jnp.float32(32 + 8 * i), 8, 1080, 1920)
        for i in range(6)]
    t_issue = (time.time() - t0) / 6 * 1000
    t0 = time.time()
    for hh in handles:
        enc.encode_chunk_finalize(hh)
    t_fin = (time.time() - t0) / 6 * 1000
    print(f"single: issue {t_issue:.1f} ms/chunk, serial finalize "
          f"{t_fin:.1f} ms/chunk", flush=True)

    t0 = time.time()
    handles = [enc.encode_chunk_batch_dispatch_src(
        planar_src, jnp.float32(96 + 16 * i), 8, 1080, 1920, batch=2)
        for i in range(3)]
    t_issue = (time.time() - t0) / 6 * 1000
    t0 = time.time()
    for hh in handles:
        enc.encode_chunk_batch_finalize(hh)
    t_fin = (time.time() - t0) / 6 * 1000
    print(f"batch2: issue {t_issue:.1f} ms/chunk, serial finalize "
          f"{t_fin:.1f} ms/chunk", flush=True)


if __name__ == "__main__":
    main()
