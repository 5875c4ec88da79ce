"""Chunk-per-device SPMD encode with tpuhype on a device mesh.

Runs on the cards of one host or a virtual CPU mesh:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 FLUTPU_CPU=1 \
      python examples/mesh_encode.py fvc-motion
  # sequence-parallel: 4 chunks x 2 row stripes, ring halo exchange
  XLA_FLAGS=--xla_force_host_platform_device_count=8 FLUTPU_CPU=1 \
      python examples/mesh_encode.py fvc-motion 2
"""

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import os
if os.environ.get("FLUTPU_CPU"):
    import jax
    jax.config.update("jax_platforms", "cpu")

import numpy as np

from flutpu.codec import FvcDecoder
from flutpu.codec.jpeg import decode_jpeg, psnr
from flutpu.core import parse_launch
from flutpu.core.bus import MessageType
from flutpu.core.elements import make_test_frame


def main():
    import jax
    codec = sys.argv[1] if len(sys.argv) > 1 else "fvc"
    spatial = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    chunks = min(8, len(jax.devices())) // spatial
    n = chunks * 2
    out = f"/tmp/mesh_encode.{'avi' if codec == 'jpeg' else 'fvc'}"
    sink = "avimux ! " if codec == "jpeg" else ""
    p = parse_launch(
        f"videotestsrc num-buffers={n} pattern=ball width=160 height=96 "
        f"! tpuhype gop-size=2 chunks={chunks} spatial={spatial} "
        f"codec={codec} quality=88 "
        f"! {sink}filesink location={out}")
    p.play()
    assert p.bus.timed_pop_filtered(300, [MessageType.EOS])
    p.stop()
    data = open(out, "rb").read()
    print(f"{codec}: {chunks}-chunk SPMD encode of {n} frames -> "
          f"{len(data)} bytes ({out})")
    if codec != "jpeg":
        dec = FvcDecoder().decode_stream(data)
        ref = make_test_frame("ball", 160, 96, n - 1)
        print(f"decoded {dec.shape}; last-frame psnr "
              f"{psnr(ref, dec[-1]):.1f} dB")


if __name__ == "__main__":
    main()
