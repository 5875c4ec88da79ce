"""Multi-host scaling helpers — the network for chunk scatter, the
intra-host links (NVLink) inside a host.

SURVEY §5.8 contract: bulk pixel movement stays inside a host; the network
is only used for multi-host scatter of input chunks and gather of
bitstreams.
Because chunk encode needs zero collectives, the multi-host topology is
embarrassingly simple: each host feeds the chunks owned by its local
devices and stitches only its own outputs; one designated host (or the
caller) concatenates per-host bitstreams in chunk order.

This module cannot be exercised on single-host CI; it wires the standard
jax.distributed bootstrap and the per-host chunk assignment arithmetic, and
is covered by logic tests that fake the process topology.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed bootstrap (no-op when single-process)."""
    import jax
    if num_processes in (None, 1) and os.environ.get("JAX_NUM_PROCESSES") in (None, "1"):
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


@dataclass(frozen=True)
class ChunkAssignment:
    """Which GOP chunks of a batch this host owns."""
    process_id: int
    num_processes: int
    chunks_per_batch: int

    def local_chunks(self) -> List[int]:
        """Chunk indices whose devices live on this host (block layout:
        contiguous runs, matching jax's default device order so each
        chunk's data is produced where its chip is attached)."""
        per_host = self.chunks_per_batch // self.num_processes
        start = self.process_id * per_host
        return list(range(start, start + per_host))

    def owner_of(self, chunk: int) -> int:
        per_host = self.chunks_per_batch // self.num_processes
        return min(chunk // per_host, self.num_processes - 1)


def assignment(chunks_per_batch: Optional[int] = None) -> ChunkAssignment:
    import jax
    n_proc = jax.process_count()
    n_chunks = chunks_per_batch or jax.device_count()
    return ChunkAssignment(jax.process_index(), n_proc, n_chunks)


def stitch_order(per_host_payloads: Sequence[Tuple[int, bytes]]) -> bytes:
    """Gather step: concatenate (chunk_index, payload) pairs from all hosts
    in strict chunk order — the DCN-side analog of scenecollector's ordered
    drain."""
    return b"".join(p for _, p in sorted(per_host_payloads, key=lambda x: x[0]))
