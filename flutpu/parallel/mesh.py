"""Device mesh utilities — the multi-device scaling layer.

The reference's only parallelism is GOP-chunk data parallelism over CPU
threads (SURVEY §2.5). Here the same strategy is expressed as a device mesh: a
jax.sharding.Mesh with a ``chunk`` axis (one GOP chunk per device) and an
optional ``spatial`` axis (rows of a frame across devices — the sequence/
tensor-parallel analog for very large frames). Chunk independence is
guaranteed by forced keyframes, so the encode step needs **zero collectives**
— wall-clock = slowest single chunk, exactly the reference's structural
property (BASELINE.md), but across devices instead of threads.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_chunk_mesh(n_devices: Optional[int] = None,
                    devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the ``chunk`` axis."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), ("chunk",))


def make_chunk_spatial_mesh(chunk: int, spatial: int,
                            devices: Optional[Sequence] = None) -> Mesh:
    """2-D mesh: GOP chunks × frame-row stripes. Row stripes shard the
    convert/DCT work of one chunk across ``spatial`` devices when a single
    frame is too large for one device's memory/step budget."""
    if devices is None:
        devices = jax.devices()
    n = chunk * spatial
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.array(devices[:n]).reshape(chunk, spatial)
    return Mesh(arr, ("chunk", "spatial"))


def chunk_sharding(mesh: Mesh, axis: int = 0, ndim: int = 5) -> NamedSharding:
    """NamedSharding placing array dim ``axis`` on the chunk mesh axis."""
    spec = [None] * ndim
    spec[axis] = "chunk"
    return NamedSharding(mesh, P(*spec))
