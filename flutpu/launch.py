"""flutpu-launch — run textual pipeline descriptions (gst-launch analog).

    python -m flutpu.launch "videotestsrc num-buffers=30 ! hype gop-size=5 \
        encoder-1=tpujpegenc ! filesink location=/tmp/out.mjpeg"

Runs the pipeline to EOS (or error), printing bus messages. ``-v`` prints
caps negotiations and per-element state changes.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

if os.environ.get("FLUTPU_CPU"):  # force CPU before any jax-touching element
    import jax
    jax.config.update("jax_platforms", "cpu")

from .core import (Bin, EventType, MessageType, Pad, PadDirection, State,
                   parse_launch)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flutpu-launch")
    ap.add_argument("pipeline", nargs="+", help="pipeline description")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--timeout", type=float, default=0.0,
                    help="stop after N seconds (0 = run to EOS)")
    args = ap.parse_args(argv)
    from .platform import enable_compile_cache
    enable_compile_cache()

    desc = " ".join(args.pipeline)
    try:
        pipeline = parse_launch(desc)
    except (ValueError, KeyError) as e:
        print(f"ERROR: could not build pipeline: {e}", file=sys.stderr)
        return 1

    if args.verbose:
        for el in pipeline.iterate_elements():
            print(f"  element {el.name} ({el.FACTORY})", file=sys.stderr)

    eos = {"seen": False}

    def watch(msg):
        if msg.type == MessageType.EOS:
            eos["seen"] = True
        if args.verbose or msg.type in (MessageType.ERROR, MessageType.WARNING):
            print(f"bus: {msg}", file=sys.stderr)

    pipeline.bus.add_watch(watch)

    # attach an EOS detector to unlinked sink-less ends
    if pipeline.play().name == "FAILURE":
        print("ERROR: pipeline refused to start", file=sys.stderr)
        return 1
    print("Pipeline is PLAYING ...", file=sys.stderr)

    t0 = time.monotonic()
    try:
        while not eos["seen"]:
            time.sleep(0.05)
            if args.timeout and time.monotonic() - t0 > args.timeout:
                print("timeout reached", file=sys.stderr)
                break
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
    pipeline.stop()
    print("Pipeline stopped.", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
