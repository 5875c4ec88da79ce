"""Throughput-first FVC encoding: B independent chunks per device
dispatch.

FVC's 8-frame bitstream GOP is fixed (an I frame must start every chunk
so hype can stitch), so the lever that amortizes the per-dispatch cost
is packing whole chunks:
``encode_chunk_batch_dispatch_src`` encodes B chunks in ONE program and
``encode_chunk_batch_finalize`` brings all of them back in ONE fetch.
Streams are byte-identical to B separate dispatches and each chunk
remains independently decodable.

Run: FLUTPU_CPU=1 python examples/fvc_batched.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("FLUTPU_CPU"):
    import jax
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from flutpu.codec.fvc import FvcDecoder, FvcEncoder
from flutpu.codec.ops.testsrc import gradient_ball_planes


def src(ph, pw, n, start):
    # channel-planar device source; host-fed frames would pay the upload
    # path and gain nothing from batching
    return gradient_ball_planes(ph, pw, n, start)


def main():
    enc = FvcEncoder(quality=85, motion=True)
    n, h, w, batch = 8, 270, 480, 2

    t0 = time.time()
    handle = enc.encode_chunk_batch_dispatch_src(
        src, jnp.float32(0), n, h, w, batch=batch)
    chunks = enc.encode_chunk_batch_finalize(handle)
    dt = time.time() - t0
    print(f"{batch} chunks x {n} frames in one dispatch+fetch: "
          f"{[len(c) for c in chunks]} bytes, {dt:.2f}s incl. compile")

    # chunks decode independently and in any order
    dec = FvcDecoder()
    f1, _ = dec.decode_chunk(chunks[1])
    f0, _ = dec.decode_chunk(chunks[0])
    print(f"decoded chunk shapes: {f0.shape} {f1.shape}")

    # identical to the per-chunk dispatch path
    single = []
    for b in range(batch):
        hh = enc.encode_chunk_dispatch_src(src, jnp.float32(b * n), n, h, w)
        single.append(enc.encode_chunk_finalize(hh))
    print("byte-identical to separate dispatches:", single == chunks)


if __name__ == "__main__":
    main()
