"""Decoder elements: jpegdec (our baseline JFIF subset) and fvcdec.

Host entropy decode (native C++) + device reconstruction
(flutpu.codec.decode). jpegdec parses the JFIF headers our encoder emits
(standard Annex-K Huffman tables assumed — the MJPEG interchange subset);
fvcdec consumes FVC chunks and emits one raw frame per coded frame.
Together with the encoders these enable full decode→process→encode
pipelines (BASELINE config 2's decode→overlay shape).
"""

from __future__ import annotations

import struct
from fractions import Fraction
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from ..core import (Buffer, Caps, Element, Event, EventType, FlowReturn,
                    Pad, PadDirection, PropertySpec, register)
from .decode import coefs_to_rgb, decode_scan_to_coefs
from .fvc import FvcDecoder
from .jpeg import _pad_to
from .ops.quant import inverse_zigzag_order


def parse_jfif(data: bytes):
    """Minimal JFIF parse: dimensions, qtables, subsampling, scan offset."""
    if data[:2] != b"\xff\xd8":
        return None
    pos = 2
    qtables = {}
    h = w = None
    subsample = True
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            return None
        marker = data[pos + 1]
        if marker == 0xD9:
            break
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        payload = data[pos + 4:pos + 2 + length]
        if marker == 0xDB:  # DQT (possibly several tables)
            p = 0
            zz = inverse_zigzag_order(8)
            while p < len(payload):
                tid = payload[p] & 0x0F
                tab = np.frombuffer(payload[p + 1:p + 65], np.uint8)
                qtables[tid] = tab.astype(np.int32)[zz].reshape(8, 8)
                p += 65
        elif marker == 0xC0:  # SOF0
            _, h, w, ncomp = struct.unpack(">BHHB", payload[:6])
            samp = payload[7]
            subsample = samp == 0x22
        elif marker == 0xDA:  # SOS: scan follows
            scan_start = pos + 2 + length
            return {"h": h, "w": w, "qtables": qtables,
                    "subsample": subsample, "scan": data[scan_start:-2]}
        pos += 2 + length
    return None


@register
class JpegDec(Element):
    """Decodes our baseline JFIF subset back to raw RGB frames."""

    FACTORY = "jpegdec"

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.sinkpad = self.add_pad(Pad(
            "sink", PadDirection.SINK, self,
            template_caps=Caps.from_string("image/jpeg")))
        self.srcpad = self.add_pad(Pad("src", PadDirection.SRC, self))
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._sink_event
        self._caps_sent = False

    def _sink_event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.CAPS:
            return True  # output caps derive from the bitstream
        return self.srcpad.push_event(event)

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        info = parse_jfif(bytes(buf.data))
        if info is None:
            return FlowReturn.ERROR
        h, w = info["h"], info["w"]
        mult = 16 if info["subsample"] else 8
        ph, pw = _pad_to(h, mult), _pad_to(w, mult)
        ybw, ybh = pw // 8, ph // 8
        cbw, cbh = (pw // 16, ph // 16) if info["subsample"] else (ybw, ybh)
        coefs = decode_scan_to_coefs(info["scan"], ybw, ybh, cbw, cbh,
                                     info["subsample"])
        if coefs is None:
            return FlowReturn.ERROR
        qy = jnp.asarray(info["qtables"].get(0))
        qc = jnp.asarray(info["qtables"].get(1, info["qtables"].get(0)))
        rgb = np.asarray(coefs_to_rgb(
            jnp.asarray(coefs[0]), jnp.asarray(coefs[1]),
            jnp.asarray(coefs[2]), qy, qc, h=h, w=w,
            subsample=info["subsample"]))
        if not self._caps_sent:
            self._caps_sent = True
            from ..core import CapsEvent
            self.srcpad.push_event(CapsEvent(Caps.new(
                "video/x-raw", format="RGB", width=w, height=h)))
        out = Buffer(rgb, pts=buf.pts, dts=buf.dts, duration=buf.duration,
                     offset=buf.offset)
        return self.srcpad.push(out)


@register
class FvcDec(Element):
    """Decodes FVC chunks to raw RGB frames (one buffer per coded
    frame)."""

    FACTORY = "fvcdec"

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.sinkpad = self.add_pad(Pad(
            "sink", PadDirection.SINK, self,
            template_caps=Caps.from_string("video/x-fvc")))
        self.srcpad = self.add_pad(Pad("src", PadDirection.SRC, self))
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._sink_event
        self._decoder = FvcDecoder()
        self._caps_sent = False
        self._tail = b""  # partial chunk bytes (byte-stream inputs)
        self._frame_count = 0

    def _sink_event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.CAPS:
            return True
        if event.type == EventType.FLUSH_STOP:
            self._tail = b""
        return self.srcpad.push_event(event)

    def _take_complete_chunk(self, data: bytes):
        """(chunk, remainder) if a full chunk is buffered, else (None,
        data). Mirrors FvcDecoder.split_stream but tolerates truncation
        (a streaming source delivers arbitrary byte blocks)."""
        import struct as _s
        from .fvc import MAGIC
        if len(data) < 12:
            return None, data
        if data[:4] != MAGIC:
            raise ValueError("bad FVC chunk boundary")
        ver, cflags, _, _, _, f = _s.unpack(">BBHHBB", data[4:12])
        end = 13 if ver >= 2 else 12
        if cflags & 16:
            end += 4  # explicit coded-size extension (striped encodes)
        if cflags & 32:
            end += 1  # B-frame bquality extension
        hdr = 7 if ver >= 2 else 5
        for _i in range(f):
            if len(data) - end < hdr:
                return None, data
            if ver >= 2:
                _, mv_len, plen = _s.unpack(">BHI", data[end:end + 7])
                end += 7 + mv_len + plen
            else:
                _, plen = _s.unpack(">BI", data[end:end + 5])
                end += 5 + plen
        if len(data) < end:
            return None, data
        return data[:end], data[end:]

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        data = self._tail + bytes(buf.data)
        ret = FlowReturn.OK
        while True:
            try:
                chunk, data = self._take_complete_chunk(data)
            except ValueError:
                self._tail = b""
                return FlowReturn.ERROR
            if chunk is None:
                break
            ret = self._decode_and_push(chunk, buf)
            if ret != FlowReturn.OK:
                break
        self._tail = data
        return ret

    def _decode_and_push(self, chunk: bytes, buf: Buffer) -> FlowReturn:
        try:
            frames, info = self._decoder.decode_chunk(chunk)
        except ValueError:
            return FlowReturn.ERROR
        if not self._caps_sent:
            self._caps_sent = True
            from ..core import CapsEvent
            self.srcpad.push_event(CapsEvent(Caps.new(
                "video/x-raw", format="RGB",
                width=info["width"], height=info["height"])))
        pts_list = buf.meta.get("frame_pts") or [None] * len(frames)
        dur = (buf.duration // len(frames)
               if buf.duration is not None else None)
        if dur is None:  # byte-stream input: synthesize from caps framerate
            fr = (self.sinkpad.caps.get("framerate")
                  if self.sinkpad.caps is not None else None)
            from fractions import Fraction
            fr = fr or Fraction(30, 1)
            dur = int(1_000_000_000 * fr.denominator / max(1, fr.numerator))
        for i in range(frames.shape[0]):
            pts = pts_list[i] if i < len(pts_list) else None
            if pts is None and buf.pts is not None and \
                    buf.meta.get("frame_pts"):
                pts = buf.pts + i * dur
            if pts is None:
                pts = self._frame_count * dur
            self._frame_count += 1
            ret = self.srcpad.push(Buffer(frames[i], pts=pts, duration=dur))
            if ret != FlowReturn.OK:
                return ret
        return FlowReturn.OK
