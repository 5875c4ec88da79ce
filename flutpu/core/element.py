"""Element base class: state machine, properties, pads.

Rebuild of the GstElement/GObject contract: four states with stepped
transitions and per-transition hooks (the hype bin builds its topology at
NULL→READY, reference hype/src/hype/imp.rs:234-247), GObject-style properties
as the runtime config surface (SURVEY §5.6), and notify callbacks
(injectbin's ``notify::element``, gstinjectbin.c:188).
"""

from __future__ import annotations

import enum
import itertools
import threading
from typing import Any, Callable, Dict, List, Optional

from .caps import Caps
from .pad import FlowReturn, GhostPad, Pad, PadDirection


class State(enum.IntEnum):
    NULL = 0
    READY = 1
    PAUSED = 2
    PLAYING = 3


class StateChangeReturn(enum.Enum):
    SUCCESS = "success"
    FAILURE = "failure"
    NO_PREROLL = "no-preroll"


class StateChange(enum.Enum):
    NULL_TO_READY = (State.NULL, State.READY)
    READY_TO_PAUSED = (State.READY, State.PAUSED)
    PAUSED_TO_PLAYING = (State.PAUSED, State.PLAYING)
    PLAYING_TO_PAUSED = (State.PLAYING, State.PAUSED)
    PAUSED_TO_READY = (State.PAUSED, State.READY)
    READY_TO_NULL = (State.READY, State.NULL)


_name_counters: Dict[str, "itertools.count"] = {}
_name_lock = threading.Lock()


def _auto_name(factory: str) -> str:
    with _name_lock:
        c = _name_counters.setdefault(factory, itertools.count(0))
        return f"{factory}{next(c)}"


class PropertySpec:
    """Declared element property (GParamSpec analog)."""

    def __init__(self, name: str, default: Any = None, doc: str = "",
                 construct_only: bool = False, ptype: Optional[type] = None):
        self.name = name
        self.default = default
        self.doc = doc
        self.construct_only = construct_only
        self.ptype = ptype if ptype is not None else (type(default) if default is not None else None)


class Element:
    """Base streaming element.

    Subclasses declare ``FACTORY`` (registry name) and ``PROPERTIES``
    (list of PropertySpec), create pads in ``__init__``, and override
    ``change_state`` / chain functions.
    """

    FACTORY: str = ""
    PROPERTIES: List[PropertySpec] = []
    def __init__(self, name: Optional[str] = None, **props: Any):
        self.name = name or _auto_name(self.FACTORY or type(self).__name__.lower())
        self.pads: Dict[str, Pad] = {}
        self.state = State.NULL
        self.parent: Optional["Element"] = None
        self.locked_state = False
        self._props: Dict[str, Any] = {
            spec.name: spec.default for spec in self._all_prop_specs()
        }
        self._notify_cbs: Dict[str, List[Callable[["Element", str], None]]] = {}
        self._state_lock = threading.RLock()
        for k, v in props.items():
            self.set_property(k.replace("_", "-"), v)

    def prewarm(self, caps=None) -> bool:
        """Compile/warm any device programs this element will run for
        ``caps``, BEFORE it is linked into a flowing pipeline. Swap
        machinery (injectbin) calls this so a hot-swapped device stage
        never pays its first-buffer jit compile on the streaming thread —
        a first compile costs minutes on remote links, vs the reference's
        brief bounded block (gstinjectbin.c:131-174). Returns True when a
        program was warmed; the default has nothing to warm."""
        return False

    # -- properties --------------------------------------------------------
    @classmethod
    def _all_prop_specs(cls) -> List[PropertySpec]:
        specs: Dict[str, PropertySpec] = {}
        for klass in reversed(cls.__mro__):
            for spec in getattr(klass, "PROPERTIES", []) or []:
                specs[spec.name] = spec
        return list(specs.values())

    def _find_spec(self, name: str) -> Optional[PropertySpec]:
        for spec in self._all_prop_specs():
            if spec.name == name:
                return spec
        return None

    def set_property(self, name: str, value: Any) -> None:
        name = name.replace("_", "-")  # GObject-style name normalization
        spec = self._find_spec(name)
        if spec is None:
            raise KeyError(f"{type(self).__name__} has no property {name!r}")
        if spec.construct_only and self.state != State.NULL:
            raise RuntimeError(f"property {name!r} is construct-only")
        if spec.ptype is not None and value is not None and not isinstance(value, spec.ptype):
            try:
                value = spec.ptype(value)
            except (TypeError, ValueError):
                pass
        self._props[name] = value
        self.do_set_property(name, value)
        self.notify(name)

    def get_property(self, name: str) -> Any:
        name = name.replace("_", "-")  # GObject-style name normalization
        if name not in self._props:
            raise KeyError(f"{type(self).__name__} has no property {name!r}")
        override = self.do_get_property(name)
        return self._props[name] if override is None else override

    def do_set_property(self, name: str, value: Any) -> None:
        """Hook for side effects on property set."""

    def do_get_property(self, name: str) -> Any:
        """Hook to compute a property value; return None to use stored."""
        return None

    def connect_notify(self, prop: str, cb: Callable[["Element", str], None]) -> None:
        self._notify_cbs.setdefault(prop, []).append(cb)

    def notify(self, prop: str) -> None:
        for cb in self._notify_cbs.get(prop, []):
            cb(self, prop)

    # -- pads --------------------------------------------------------------
    def add_pad(self, pad: Pad) -> Pad:
        pad.element = self
        self.pads[pad.name] = pad
        return pad

    def remove_pad(self, pad: Pad) -> None:
        self.pads.pop(pad.name, None)
        pad.element = None

    def get_pad(self, name: str) -> Optional[Pad]:
        return self.pads.get(name)

    def src_pads(self) -> List[Pad]:
        return [p for p in self.pads.values() if p.direction == PadDirection.SRC]

    def sink_pads(self) -> List[Pad]:
        return [p for p in self.pads.values() if p.direction == PadDirection.SINK]

    def request_pad(self, template: str) -> Optional[Pad]:
        """Request-pad factory; subclasses with %u templates override."""
        return None

    def release_pad(self, pad: Pad) -> None:
        self.remove_pad(pad)

    @property
    def static_sink_pad(self) -> Optional[Pad]:
        pads = self.sink_pads()
        return pads[0] if pads else None

    @property
    def static_src_pad(self) -> Optional[Pad]:
        pads = self.src_pads()
        return pads[0] if pads else None

    def link(self, downstream: "Element") -> None:
        """Link this element's first free src pad to downstream's sink pad,
        creating request pads where templates allow."""
        src = next((p for p in self.src_pads() if not p.is_linked()), None)
        if src is None:
            src = self.request_pad("src_%u")
        if src is None:
            raise ValueError(f"{self.name}: no free src pad")
        sink = next((p for p in downstream.sink_pads() if not p.is_linked()), None)
        if sink is None:
            sink = downstream.request_pad("sink_%u")
        if sink is None:
            raise ValueError(f"{downstream.name}: no free sink pad")
        src.link(sink)

    # -- state -------------------------------------------------------------
    def set_state(self, target: State) -> StateChangeReturn:
        with self._state_lock:
            while self.state != target:
                step = 1 if target > self.state else -1
                nxt = State(self.state + step)
                transition = StateChange((self.state, nxt))
                ret = self.change_state(transition)
                if ret == StateChangeReturn.FAILURE:
                    return ret
                self.state = nxt
            return StateChangeReturn.SUCCESS

    def change_state(self, transition: StateChange) -> StateChangeReturn:
        """Per-transition hook; subclasses override and chain up."""
        if transition == StateChange.PAUSED_TO_READY:
            for pad in self.pads.values():
                pad.eos = False
        return StateChangeReturn.SUCCESS

    def sync_state_with_parent(self) -> StateChangeReturn:
        if self.parent is not None:
            return self.set_state(self.parent.state)
        return StateChangeReturn.SUCCESS

    # -- misc --------------------------------------------------------------
    def post_message(self, msg) -> None:
        el: Optional[Element] = self
        while el is not None:
            bus = getattr(el, "bus", None)
            if bus is not None:
                bus.post(msg)
                return
            el = el.parent

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name} [{self.state.name}]>"
