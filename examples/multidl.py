"""Interactive-ish downloader demo (reference examples/multidl.c analog):
queue several downloads on one session, watch pipelining + bwmeter."""

import sys
import threading

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import os
if os.environ.get("FLUTPU_CPU"):  # force the CPU backend
    import jax
    jax.config.update("jax_platforms", "cpu")

from flutpu.fluc import bwmeter
from flutpu.io import Downloader


def main():
    urls = sys.argv[1:]
    if not urls:
        print("usage: python examples/multidl.py URL [URL...]")
        return
    done = threading.Event()
    remaining = [len(urls)]

    def data_cb(chunk, task):
        return True

    def done_cb(outcome, status, size, task):
        print(f"  {task.url}: {outcome.name} http={status} {size} bytes")
        remaining[0] -= 1
        if remaining[0] == 0:
            done.set()

    with Downloader(data_cb, done_cb) as dl:
        for u in urls:
            dl.new_task(u)
        done.wait(timeout=120)
    raw, avg, total = bwmeter.stats()
    print(f"bwmeter: raw={raw/1e6:.2f} Mbps avg={avg/1e6:.2f} Mbps total={total} B")


if __name__ == "__main__":
    main()
