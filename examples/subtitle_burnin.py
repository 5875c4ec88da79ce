"""Render TTML subtitles and burn them into video frames on device.

Usage: python examples/subtitle_burnin.py out.png
"""

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import os
if os.environ.get("FLUTPU_CPU"):  # force the CPU backend
    import jax
    jax.config.update("jax_platforms", "cpu")

import numpy as np

TTML = """<?xml version="1.0"?>
<tt xmlns="http://www.w3.org/ns/ttml" xmlns:tts="http://www.w3.org/ns/ttml#styling">
  <head><layout>
    <region xml:id="bottom" tts:origin="10% 78%" tts:extent="80% 18%"
            tts:backgroundColor="#00000090" tts:displayAlign="center"
            tts:textAlign="center"/>
  </layout></head>
  <body><div>
    <p begin="0s" end="5s" region="bottom" tts:color="white"
       tts:textOutline="black 2px">Subtitles, composited on the device.</p>
  </div></body>
</tt>"""


def main():
    import jax.numpy as jnp
    from flutpu.core import Buffer, Harness
    from flutpu.core.elements import make_test_frame
    from flutpu.ttml.render import overlay_on_frames

    h = Harness("ttmlrender window-width=640 window-height=360")
    h.set_src_caps("application/ttml+xml")
    h.push(Buffer(TTML.encode(), pts=0))
    h.push_eos()
    overlay = np.asarray(h.pull(timeout=20).data)
    h.teardown()

    video = np.stack([make_test_frame("gradient", 640, 360, i) for i in range(8)])
    burned = np.asarray(overlay_on_frames(jnp.asarray(video), jnp.asarray(overlay)))
    out = sys.argv[1] if len(sys.argv) > 1 else "/tmp/burnin.png"
    from PIL import Image
    Image.fromarray(burned[0]).save(out)
    print(f"wrote {out} ({burned.shape[0]} frames burned in)")


if __name__ == "__main__":
    main()
