"""Chunk-parallel FVC encode of a synthetic clip, then decode + PSNR check.

Usage: python examples/encode_parallel.py [n_frames]
"""

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import os
if os.environ.get("FLUTPU_CPU"):  # force the CPU backend
    import jax
    jax.config.update("jax_platforms", "cpu")

import numpy as np

from flutpu.codec import FvcDecoder
from flutpu.codec.jpeg import psnr
from flutpu.core import parse_launch
from flutpu.core.elements import make_test_frame


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    p = parse_launch(
        f"videotestsrc num-buffers={n} pattern=ball width=320 height=240 "
        "! hype gop-size=5 encoder-1=fvcenc encoder-2=fvcenc encoder-3=fvcenc "
        "! appsink name=out")
    sink = p.get_by_name("out")
    p.play()
    chunks = []
    while (b := sink.try_pull_buffer(timeout=30)) is not None:
        chunks.append(bytes(b.data))
    p.stop()
    stream = b"".join(chunks)
    print(f"{n} frames -> {len(chunks)} chunks, {len(stream)} bytes "
          f"({len(stream) / n:.0f} B/frame)")
    dec = FvcDecoder().decode_stream(stream)
    ps = [psnr(make_test_frame("ball", 320, 240, i), dec[i]) for i in range(n)]
    print(f"decoded {dec.shape[0]} frames, PSNR min/mean = "
          f"{min(ps):.1f}/{sum(ps)/len(ps):.1f} dB")


if __name__ == "__main__":
    main()
