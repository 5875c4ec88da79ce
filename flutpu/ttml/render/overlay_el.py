"""overlaycompositor — burn a sparse BGRA overlay stream into video.

The pipeline-element form of the burn-in kernel (the reference README
composes ttmlrender over video with GStreamer's ``compositor``): a ``video``
sink pad carries raw frames, an ``overlay`` sink pad carries ttmlrender's
sparse interval frames; each video frame is composited with the overlay
active at its timestamp (device kernel, batched when video arrives in
lists).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np

from ...core import (Buffer, Caps, Element, Event, EventType, FlowReturn,
                     Pad, PadDirection, register)
from .composite import overlay_on_frames


@register
class OverlayCompositor(Element):
    """Burns a sparse BGRA overlay stream into raw video frames."""

    FACTORY = "overlaycompositor"

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.video_pad = self.add_pad(Pad(
            "video", PadDirection.SINK, self,
            template_caps=Caps.from_string("video/x-raw, format=RGB")))
        self.overlay_pad = self.add_pad(Pad(
            "overlay", PadDirection.SINK, self,
            template_caps=Caps.from_string("video/x-raw, format=BGRA")))
        self.srcpad = self.add_pad(Pad("src", PadDirection.SRC, self))
        self.video_pad.chain_function = self._video_chain
        self.video_pad.event_function = self._video_event
        self.overlay_pad.chain_function = self._overlay_chain
        self.overlay_pad.event_function = self._overlay_event
        self._lock = threading.Lock()
        # (start, stop, overlay ndarray) intervals, sorted by start
        self._overlays: List[Tuple[int, Optional[int], np.ndarray]] = []

    def prewarm(self, caps=None) -> bool:
        """Compile the burn-in composite for ``caps``' geometry before an
        injectbin swap installs any dataflow block (see Element.prewarm)."""
        if caps is None:
            return False
        w, h = caps.get("width"), caps.get("height")
        if not w or not h:
            return False
        import jax.numpy as jnp
        frames = jnp.zeros((1, int(h), int(w), 3), jnp.uint8)
        ov = jnp.zeros((int(h), int(w), 4), jnp.uint8)
        np.asarray(overlay_on_frames(frames, ov))
        return True

    # -- overlay branch ----------------------------------------------------
    def _overlay_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        start = buf.pts if buf.pts is not None else 0
        stop = None if buf.duration is None else start + buf.duration
        with self._lock:
            self._overlays.append((start, stop, np.asarray(buf.data)))
            self._overlays.sort(key=lambda x: x[0])
        return FlowReturn.OK

    def _overlay_event(self, pad: Pad, event: Event) -> bool:
        return True  # overlay branch events terminate here

    # -- video branch ------------------------------------------------------
    def _active_overlay(self, pts: Optional[int]) -> Optional[np.ndarray]:
        if pts is None:
            return None
        with self._lock:
            # prune intervals that ended before this frame: video pts is
            # monotone on this pad, and a long-running pipeline otherwise
            # accumulates one full-frame RGBA array per subtitle interval
            # forever (~8 MB each at 1080p) with a linear scan per frame
            if self._overlays:
                self._overlays = [o for o in self._overlays
                                  if o[1] is None or pts < o[1]]
            for start, stop, ov in self._overlays:
                if start <= pts and (stop is None or pts < stop):
                    return ov
        return None

    def _video_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        ov = self._active_overlay(buf.pts)
        if ov is None or (ov[..., 3] == 0).all():
            return self.srcpad.push(buf)
        frame = np.asarray(buf.data)
        if ov.shape[:2] != frame.shape[:2]:
            # scale the overlay to the video geometry on first mismatch
            import jax.numpy as jnp
            from ...codec.ops.colorspace import scale_bilinear
            ov = np.clip(np.asarray(scale_bilinear(
                jnp.asarray(ov), frame.shape[0], frame.shape[1])) + 0.5,
                0, 255).astype(np.uint8)
        import jax.numpy as jnp
        out = np.asarray(overlay_on_frames(jnp.asarray(frame[None]),
                                           jnp.asarray(ov)))[0]
        res = buf.copy()
        res.data = out
        return self.srcpad.push(res)

    def _video_event(self, pad: Pad, event: Event) -> bool:
        return self.srcpad.push_event(event)
