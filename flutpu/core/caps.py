"""Caps — typed media capability structures with negotiation semantics.

A rebuild of the GStreamer caps model the reference relies on for
element linking (see reference plugins/ttml/gstttmlbase.c caps negotiation and
hype/src/hype/imp.rs:34-63 which intersects encoder caps into a capsfilter).
Not a port: a small, functional structure model sufficient for the framework's
contracts — intersection, subset tests, fixation.
"""

from __future__ import annotations

import fractions
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

Fraction = fractions.Fraction


@dataclass(frozen=True)
class IntRange:
    """Inclusive integer range field value."""

    lo: int
    hi: int

    def __post_init__(self):
        if self.lo > self.hi:
            raise ValueError(f"empty range [{self.lo},{self.hi}]")

    def __contains__(self, v) -> bool:
        return isinstance(v, int) and self.lo <= v <= self.hi


@dataclass(frozen=True)
class ValueList:
    """Unordered set of alternative field values."""

    values: Tuple[Any, ...]

    def __contains__(self, v) -> bool:
        return v in self.values


def _intersect_value(a: Any, b: Any) -> Optional[Any]:
    """Intersect two field values; None means empty intersection."""
    if isinstance(a, IntRange) and isinstance(b, IntRange):
        lo, hi = max(a.lo, b.lo), min(a.hi, b.hi)
        if lo > hi:
            return None
        return lo if lo == hi else IntRange(lo, hi)
    if isinstance(a, IntRange):
        if isinstance(b, ValueList):
            vals = tuple(v for v in b.values if v in a)
            return _shrink_list(vals)
        return b if b in a else None
    if isinstance(b, IntRange):
        return _intersect_value(b, a)
    if isinstance(a, ValueList) and isinstance(b, ValueList):
        vals = tuple(v for v in a.values if v in b.values)
        return _shrink_list(vals)
    if isinstance(a, ValueList):
        return b if b in a.values else None
    if isinstance(b, ValueList):
        return a if a in b.values else None
    return a if a == b else None


def _shrink_list(vals: Tuple[Any, ...]) -> Optional[Any]:
    if not vals:
        return None
    if len(vals) == 1:
        return vals[0]
    return ValueList(vals)


def _split_top_level(s: str) -> list:
    """Split on commas outside {}/[]/() nesting."""
    parts, cur, depth = [], [], 0
    for ch in s:
        if ch in "{[(":
            depth += 1
        elif ch in "}])":
            depth = max(0, depth - 1)
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def _is_fixed_value(v: Any) -> bool:
    return not isinstance(v, (IntRange, ValueList))


def _fixate_value(v: Any) -> Any:
    if isinstance(v, IntRange):
        return v.lo
    if isinstance(v, ValueList):
        return v.values[0]
    return v


class Caps:
    """A media-type name plus a field dict. ``Caps.any()`` matches everything.

    Reference contract: GstCaps with a single structure (the reference never
    needs multi-structure caps in its own code paths).
    """

    __slots__ = ("media_type", "fields", "_any")

    def __init__(self, media_type: str = "", _any: bool = False, **fields: Any):
        self.media_type = media_type
        self.fields: Dict[str, Any] = dict(fields)
        self._any = _any

    # -- constructors ------------------------------------------------------
    @classmethod
    def any(cls) -> "Caps":
        return cls(_any=True)

    @classmethod
    def new(cls, media_type: str, **fields: Any) -> "Caps":
        return cls(media_type, **fields)

    @classmethod
    def from_string(cls, s: str) -> "Caps":
        """Parse ``video/x-raw, format=RGB, width=1, framerate=30/1``.
        Commas inside ``{a,b}`` lists and ``[lo,hi]`` ranges stay within
        their field (a bare ``s.split(",")`` tore those values apart and
        produced silently wrong caps)."""
        s = s.strip()
        if s in ("ANY", ""):
            return cls.any()
        parts = [p.strip() for p in _split_top_level(s)]
        media_type = parts[0]
        fields: Dict[str, Any] = {}
        for p in parts[1:]:
            if not p:
                continue
            k, _, v = p.partition("=")
            fields[k.strip().replace("-", "_")] = _parse_field_value(v.strip())
        return cls(media_type, **fields)

    # -- predicates --------------------------------------------------------
    @property
    def is_any(self) -> bool:
        return self._any

    def is_fixed(self) -> bool:
        return not self._any and all(_is_fixed_value(v) for v in self.fields.values())

    def intersect(self, other: "Caps") -> Optional["Caps"]:
        if self._any:
            return other.copy()
        if other._any:
            return self.copy()
        if self.media_type != other.media_type:
            return None
        out: Dict[str, Any] = {}
        for k in set(self.fields) | set(other.fields):
            a, b = self.fields.get(k), other.fields.get(k)
            if a is None:
                out[k] = b
            elif b is None:
                out[k] = a
            else:
                iv = _intersect_value(a, b)
                if iv is None:
                    return None
                out[k] = iv
        return Caps(self.media_type, **out)

    def can_intersect(self, other: "Caps") -> bool:
        return self.intersect(other) is not None

    def is_subset(self, superset: "Caps") -> bool:
        inter = self.intersect(superset)
        return inter is not None and inter == self

    def fixate(self, defaults: Optional[Dict[str, Any]] = None) -> "Caps":
        """Collapse ranges/lists to single values, preferring ``defaults``."""
        out: Dict[str, Any] = {}
        defaults = defaults or {}
        for k, v in self.fields.items():
            if _is_fixed_value(v):
                out[k] = v
            elif k in defaults and (_intersect_value(v, defaults[k]) is not None):
                out[k] = defaults[k]
            else:
                out[k] = _fixate_value(v)
        for k, v in defaults.items():
            out.setdefault(k, v)
        return Caps(self.media_type, **out)

    # -- utils -------------------------------------------------------------
    def copy(self) -> "Caps":
        c = Caps(self.media_type, _any=self._any, **self.fields)
        return c

    def with_fields(self, **fields: Any) -> "Caps":
        c = self.copy()
        c.fields.update(fields)
        return c

    def get(self, key: str, default: Any = None) -> Any:
        return self.fields.get(key, default)

    def __getitem__(self, key: str) -> Any:
        return self.fields[key]

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Caps)
            and self._any == other._any
            and self.media_type == other.media_type
            and self.fields == other.fields
        )

    def __hash__(self):
        return hash((self._any, self.media_type, tuple(sorted(self.fields.items(), key=lambda kv: kv[0]))))

    def __repr__(self) -> str:
        if self._any:
            return "Caps(ANY)"
        f = ", ".join(f"{k}={v}" for k, v in self.fields.items())
        return f"Caps({self.media_type}{', ' if f else ''}{f})"


def _parse_field_value(v: str) -> Any:
    if v.startswith("[") and v.endswith("]"):
        lo, hi = v[1:-1].split(",")
        return IntRange(int(lo), int(hi))
    if v.startswith("{") and v.endswith("}"):
        return ValueList(tuple(_parse_field_value(x.strip()) for x in v[1:-1].split(",")))
    if "/" in v and all(p.strip().lstrip("-").isdigit() for p in v.split("/", 1)):
        num, den = v.split("/", 1)
        return Fraction(int(num), int(den))
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v.strip('"')
