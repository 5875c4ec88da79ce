"""tpujpegenc — the device intra-frame encoder element.

VideoEncoder element running the flutpu.codec.jpeg path: frames accumulate
into GOP batches on the host, each batch is one device dispatch
(convert+DCT+quant+zigzag for all frames at once), coefficients return in a
single transfer and are entropy-coded to JFIF bitstreams. Every frame is a
sync point, so hype chunk boundaries are bit-exact by construction.

Batch sizes are bucketed to powers of two to bound XLA recompiles
(static-shape discipline).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core import (Buffer, BufferFlags, Caps, FlowReturn, PropertySpec,
                    register)
from .base import VideoEncoder
from .jpeg import JpegEncoder, segmented_property

_BUCKETS = (1, 2, 4, 8, 16, 32)


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return _BUCKETS[-1]


@register
class TpuJpegEnc(VideoEncoder):
    """MJPEG encoder: whole-GOP device transforms + on-device entropy
    packing; every frame a sync point."""

    FACTORY = "tpujpegenc"
    SINK_CAPS = "video/x-raw, format=RGB"
    SRC_CAPS = "image/jpeg"
    PROPERTIES = [
        PropertySpec("quality", 85),
        PropertySpec("batch-frames", 8, "max frames batched per device dispatch"),
        PropertySpec("subsample", True, "4:2:0 chroma subsampling"),
        PropertySpec("engine", "auto", "auto | device | host entropy coding"),
        PropertySpec("segmented", "auto", "segment bitstream layout: device "
                     "word-aligned segments + host compaction (byte-identical "
                     "output). auto = the platform default "
                     "(flutpu.platform); true/false force either layout"),
    ]

    def __init__(self, name: Optional[str] = None, **props):
        super().__init__(name, **props)
        self._encoder: Optional[JpegEncoder] = None
        self._pending: List[Buffer] = []
        self._gop_size: Optional[int] = None  # learned from scene-new events
        self._frames_in_chunk = 0

    def _get_encoder(self) -> JpegEncoder:
        if self._encoder is None:
            self._encoder = JpegEncoder(
                quality=int(self.get_property("quality")),
                subsample=bool(self.get_property("subsample")),
                engine=str(self.get_property("engine")),
                segmented=segmented_property(self.get_property("segmented")))
        return self._encoder

    def do_set_property(self, name, value):
        if name in ("quality", "subsample", "engine", "segmented"):
            self._encoder = None  # rebuild with new tables

    def prewarm(self, caps=None) -> bool:
        """Compile the whole-GOP device program for ``caps``' geometry
        (and run it once) so an injectbin swap-in never first-compiles on
        the streaming thread."""
        if caps is None:
            return False
        w, h = caps.get("width"), caps.get("height")
        if not w or not h:
            return False
        n = _bucket(int(self.get_property("batch-frames")))
        frames = np.zeros((n, int(h), int(w), 3), np.uint8)
        self._get_encoder().encode_gop(frames)
        return True

    def set_format(self, caps: Caps) -> Optional[Caps]:
        fields = {k: v for k, v in caps.fields.items()
                  if k in ("width", "height", "framerate")}
        return Caps.new("image/jpeg", parsed=True, **fields)

    # -- encoding ----------------------------------------------------------
    def encode_frame(self, buf: Buffer, keyframe: bool) -> Optional[Buffer]:
        self._pending.append(buf)
        self._frames_in_chunk += 1
        chunk_done = (self._gop_size is not None
                      and self._frames_in_chunk >= self._gop_size)
        if chunk_done or len(self._pending) >= int(self.get_property("batch-frames")):
            self._flush_batch()
            if chunk_done:
                self._frames_in_chunk = 0
        return None

    def finish(self):
        self._flush_batch()
        return []

    def drain(self) -> None:
        self._flush_batch()

    def reset(self) -> None:
        self._pending = []
        self._frames_in_chunk = 0

    def on_custom_event(self, event) -> None:
        from ..hype.events import SceneNewEvent
        scene = SceneNewEvent.parse(event)
        if scene is not None:
            self._gop_size = scene.gop_size
            self._frames_in_chunk = 0

    def _flush_batch(self) -> None:
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        frames = np.stack([np.asarray(b.data) for b in batch])
        n = len(batch)
        bn = _bucket(n)
        if bn != n:  # pad to the bucket to reuse the compiled program
            pad = np.repeat(frames[-1:], bn - n, axis=0)
            frames = np.concatenate([frames, pad], axis=0)
        payloads = self._get_encoder().encode_gop(frames)[:n]
        for src, data in zip(batch, payloads):
            out = Buffer(data, pts=src.pts, dts=src.dts,
                         duration=src.duration, offset=src.offset)
            # intra-only: every frame is a sync point (no DELTA_UNIT)
            self.srcpad.push(out)
