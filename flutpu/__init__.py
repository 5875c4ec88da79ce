"""flutpu — accelerator-native media pipeline framework.

A ground-up rebuild of the capabilities of Fluendo's flu-plugins-oss
GStreamer suite in JAX, running its pixel work on the GPU:

- ``flutpu.core``     host dataflow (elements/pads/caps/events/queues/harness)
- ``flutpu.hype``     GOP-chunk parallel encoder: scatter / per-device encode /
                      ordered gather (reference: hype Rust plugin)
- ``flutpu.codec``    the device encode path — JAX colorspace, DCT,
                      quantization, Pallas entropy packing + host C++ coding
- ``flutpu.ttml``     TTML subtitle parse (host) and render (device kernels)
- ``flutpu.inject``   flow-synchronized hot-swap (reference: injectbin)
- ``flutpu.io``       downloader + bandwidth meter (reference: fludownloader,
                      fluc bwmeter)
- ``flutpu.fluc``     native concurrency/metrics SDK bindings
- ``flutpu.parallel`` device mesh utilities, shard_map runners
- ``flutpu.platform`` the platform (cpu | gpu) and the arms chosen from it
"""

__version__ = "0.1.0"

from . import core  # noqa: F401
