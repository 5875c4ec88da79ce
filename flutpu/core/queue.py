"""Queue element — bounded thread-decoupling FIFO.

This is the framework's async boundary: upstream's thread enqueues, the
queue's own streaming thread dequeues and pushes downstream. Reference
analog: GStreamer ``queue`` elements giving each hype encoder branch its own
streaming thread (hype/src/outputselector/imp.rs:170-175, depth
SCENE_BUFFER_SIZE*2 = 40 buffers). On the device build this same boundary is
where host→device dispatch overlap happens.
"""

from __future__ import annotations

import queue as _pyqueue
import threading
from typing import Any, Optional

from .buffer import Buffer, BufferList
from .element import Element, PropertySpec, State, StateChange, StateChangeReturn
from .events import Event, EventType
from .pad import FlowReturn, Pad, PadDirection
from .registry import register

_SENTINEL = object()


@register
class Queue(Element):
    """Bounded FIFO decoupling upstream from its own streaming thread."""

    FACTORY = "queue"
    PROPERTIES = [
        PropertySpec("max-size-buffers", 40, "max queued items before upstream blocks"),
        # accepted for pipeline-description compatibility; only the buffer
        # count bounds this queue
        PropertySpec("max-size-bytes", 0, "accepted for launch-string "
                                          "compat; only buffer-count limits "
                                          "are enforced"),
        PropertySpec("max-size-time", 0, "accepted for launch-string compat"),
    ]

    def __init__(self, name: Optional[str] = None, **props):
        super().__init__(name, **props)
        self.sinkpad = self.add_pad(Pad("sink", PadDirection.SINK, self))
        self.srcpad = self.add_pad(Pad("src", PadDirection.SRC, self))
        self.sinkpad.chain_function = self._chain
        self.sinkpad.chain_list_function = self._chain_list
        self.sinkpad.event_function = self._sink_event
        self._queue: Optional[_pyqueue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._srcresult = FlowReturn.OK
        self._lock = threading.Lock()

    # -- dataflow ----------------------------------------------------------
    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        with self._lock:
            if not self._running or self._queue is None:
                return FlowReturn.FLUSHING
            if self._srcresult != FlowReturn.OK:
                return self._srcresult
            q = self._queue
        q.put(buf)  # blocks when full → backpressure on upstream thread
        return FlowReturn.OK

    def _chain_list(self, pad: Pad, buffers: BufferList) -> FlowReturn:
        with self._lock:
            if not self._running or self._queue is None:
                return FlowReturn.FLUSHING
            if self._srcresult != FlowReturn.OK:
                # propagate downstream flow errors to buffer-list pushers
                # exactly as _chain does for per-buffer pushers
                return self._srcresult
            q = self._queue
        q.put(buffers)
        return FlowReturn.OK

    def _sink_event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.FLUSH_START:
            # out-of-band: drain queue, forward immediately
            self._flush_queue()
            return self.srcpad.push_event(event)
        if event.type == EventType.FLUSH_STOP:
            self._flush_queue()
            with self._lock:
                self._srcresult = FlowReturn.OK
            return self.srcpad.push_event(event)
        with self._lock:
            if not self._running or self._queue is None:
                # pre-roll: forward synchronously (sticky events before start)
                return self.srcpad.push_event(event)
            q = self._queue
        q.put(event)
        return True

    def _flush_queue(self) -> None:
        q = self._queue
        if q is None:
            return
        try:
            while True:
                q.get_nowait()
        except _pyqueue.Empty:
            pass

    # -- streaming thread --------------------------------------------------
    def _loop(self) -> None:
        assert self._queue is not None
        while True:
            item = self._queue.get()
            if item is _SENTINEL:
                return
            if isinstance(item, Event):
                self.srcpad.push_event(item)
            elif isinstance(item, BufferList):
                ret = self.srcpad.push_list(item)
                if ret not in (FlowReturn.OK, FlowReturn.EOS):
                    with self._lock:
                        self._srcresult = ret
            else:
                ret = self.srcpad.push(item)
                if ret not in (FlowReturn.OK, FlowReturn.EOS):
                    with self._lock:
                        self._srcresult = ret

    # -- state -------------------------------------------------------------
    def change_state(self, transition: StateChange) -> StateChangeReturn:
        if transition == StateChange.READY_TO_PAUSED:
            maxb = int(self.get_property("max-size-buffers") or 0)
            self._queue = _pyqueue.Queue(maxsize=maxb)
            self._srcresult = FlowReturn.OK
            self._running = True
            self._thread = threading.Thread(
                target=self._loop, name=f"{self.name}-stream", daemon=True)
            self._thread.start()
        elif transition == StateChange.PAUSED_TO_READY:
            with self._lock:
                self._running = False
            if self._queue is not None:
                self._flush_queue()
                self._queue.put(_SENTINEL)
            if self._thread is not None:
                self._thread.join(timeout=5)
                self._thread = None
            self._queue = None
        return super().change_state(transition)
