"""flutpu.core — host-side streaming dataflow framework.

The GStreamer-role layer of the rebuild: elements, pads, caps,
buffers, events, bins, queues, a registry with a textual pipeline language,
and a push/pull test harness. All pixel math lives in flutpu.codec /
flutpu.ttml device kernels; this layer owns topology, ordering and time.
"""

from .buffer import (Buffer, BufferFlags, BufferList, CLOCK_TIME_NONE,
                     MSECOND, NSECOND, SECOND, USECOND)
from .caps import Caps, IntRange, ValueList
from .element import (Element, PropertySpec, State, StateChange,
                      StateChangeReturn)
from .events import (CapsEvent, CustomDownstreamEvent, CustomUpstreamEvent,
                     EosEvent, Event, EventType, FlushStartEvent,
                     FlushStopEvent, ForceKeyUnitEvent, GapEvent, SeekEvent,
                     Segment, SegmentEvent, StreamStartEvent, TagEvent)
from .pad import (FlowError, FlowReturn, GhostPad, Pad, PadDirection,
                  ProbeReturn, ProbeType)
from .bin import Bin, Pipeline
from .bus import Bus, Message, MessageType
from .registry import factories, make, register
from .parse import parse_launch, parse_bin_from_description
from .harness import Harness

__all__ = [
    "Buffer", "BufferFlags", "BufferList", "CLOCK_TIME_NONE", "MSECOND",
    "NSECOND", "SECOND", "USECOND", "Caps", "IntRange", "ValueList",
    "Element", "PropertySpec", "State", "StateChange", "StateChangeReturn",
    "CapsEvent", "CustomDownstreamEvent", "CustomUpstreamEvent", "EosEvent",
    "Event", "EventType", "FlushStartEvent", "FlushStopEvent",
    "ForceKeyUnitEvent", "GapEvent", "SeekEvent", "Segment", "SegmentEvent",
    "StreamStartEvent", "TagEvent", "FlowError", "FlowReturn", "GhostPad",
    "Pad", "PadDirection", "ProbeReturn", "ProbeType", "Bin", "Pipeline",
    "Bus", "Message", "MessageType", "factories", "make", "register",
    "parse_launch", "parse_bin_from_description", "Harness",
]
