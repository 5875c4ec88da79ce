"""Baseline JPEG / MJPEG encoder — device transforms + host entropy coding.

The device encode path: a whole GOP of RGB frames is converted, DCT'd,
quantized and zigzagged in one jitted device program (batched over frames and
blocks); the entropy stage packs the bits on the device too, and only the
compressed words come back to the host, which wraps them into
standards-compliant JFIF bitstreams (C++ fast path, Python fallback). Output decodes with any JPEG
decoder — this is the interop-verifiable half of the codec (the GOP codec
with inter frames is flutpu.codec.fvc).
"""

from __future__ import annotations

import ctypes
import functools
import io
import struct
import threading
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import native, platform
from . import jpeg_tables as T
from .ops.colorspace import rgb_to_i420
from .ops.dct import blockize, plane_dct
from .ops.quant import (CHROMA_QTABLE, LUMA_QTABLE, quantize, scale_qtable,
                        zigzag_flatten, zigzag_order)


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


from ..core.log import category

CAT = category("devcodec", "adaptive device-program sizing")

# single worker serializing background compiles of GROWN program variants
# (adaptive prefix window / segment capacity): a grown static size is a
# fresh XLA program, so the streaming thread keeps dispatching the
# still-correct current program while this pool compiles the next one
# (the injectbin prewarm contract applied to the encoder's own adaptive
# shapes) — a compile on the streaming thread stalls the stream.
_GROW_POOL = None
_GROW_POOL_LOCK = threading.Lock()


def _grow_pool():
    global _GROW_POOL
    with _GROW_POOL_LOCK:
        if _GROW_POOL is None:
            from concurrent.futures import ThreadPoolExecutor
            _GROW_POOL = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="flutpu-grow")
        return _GROW_POOL


def _warm_grown(build, prefix, sw):
    """Compile + execute one GOP of the grown program variant on the warm
    worker."""
    return jax.block_until_ready(build(prefix, sw)[0]).shape


# ----------------------------------------------------------------------------
# device program
# ----------------------------------------------------------------------------

def _plane_to_zz(plane: jax.Array, qtab: jax.Array,
                 planar: Optional[bool] = None) -> jax.Array:
    """One channel plane → (F, BH, BW, 64) int16 zigzagged quantized
    coefficients (level shift, 8x8 DCT, quantize, zigzag). ``planar``
    picks the DCT formulation; None = the platform's
    (flutpu.platform.dct_planar)."""
    if planar is None:
        planar = platform.dct_planar()
    if not planar:
        coefs = plane_dct(plane - 128.0)
        return zigzag_flatten(quantize(coefs, qtab)).astype(jnp.int16)
    # plane-layout DCT + quantize (block-diagonal plane matmuls, no f32
    # blocking transposes); only the final int16 is blockized for the
    # zigzag gather
    from .ops.dct import plane_dct_planar
    from .ops.quant import quantize_planar
    qq = quantize_planar(plane_dct_planar(plane - 128.0), qtab)
    return zigzag_flatten(blockize(qq)).astype(jnp.int16)


@functools.partial(jax.jit, static_argnames=("pad_h", "pad_w", "subsample"))
def encode_gop_to_coefs(frames: jax.Array, qy: jax.Array, qc: jax.Array,
                        pad_h: int, pad_w: int, subsample: bool = True):
    """(F, H, W, 3) uint8 RGB → zigzagged quantized coefficients.

    Returns (y, cb, cr) int16 arrays of shape (F, BH, BW, 64). The whole GOP
    is one device program: colorspace convert, (optional) 4:2:0 subsample,
    level shift, 8x8 DCT as batched matmuls, quantize, zigzag gather.
    Device-resident sources use the channel-planar entry point
    (encode_gop_planes_to_coefs); this one serves host-fed interleaved
    frames.
    """
    f, h, w, _ = frames.shape
    x = frames.astype(jnp.float32)
    if pad_h != h or pad_w != w:
        x = jnp.pad(x, ((0, 0), (0, pad_h - h), (0, pad_w - w), (0, 0)),
                    mode="edge")
    if subsample:
        y, cb, cr = rgb_to_i420(x)
    else:
        from .ops.colorspace import rgb_to_ycbcr
        ycc = rgb_to_ycbcr(x)
        y, cb, cr = ycc[..., 0], ycc[..., 1], ycc[..., 2]
    return _plane_to_zz(y, qy), _plane_to_zz(cb, qc), _plane_to_zz(cr, qc)


@functools.partial(jax.jit, static_argnames=("pad_h", "pad_w", "subsample",
                                             "planar"))
def encode_gop_planes_to_coefs(r: jax.Array, g: jax.Array, b: jax.Array,
                               qy: jax.Array, qc: jax.Array,
                               pad_h: int, pad_w: int,
                               subsample: bool = True,
                               planar: Optional[bool] = None):
    """Channel-planar encode_gop_to_coefs: (r, g, b) uint8/f32 planes,
    each (F, H, W) → the same (y, cb, cr) int16 zigzag coefficients,
    byte-identical (same per-channel math and expression order; edge pad
    commutes with the f32 cast). The interleaved layout never exists.
    ``planar`` picks the DCT formulation (None = the platform's)."""
    from .ops.colorspace import planes_to_i420, ycbcr_from_channels
    f, h, w = r.shape

    def pad(p):
        p = p.astype(jnp.float32)
        if pad_h != h or pad_w != w:
            p = jnp.pad(p, ((0, 0), (0, pad_h - h), (0, pad_w - w)),
                        mode="edge")
        return p

    if subsample:
        y, cb, cr = planes_to_i420(pad(r), pad(g), pad(b))
    else:
        y, cb, cr = ycbcr_from_channels(pad(r), pad(g), pad(b))
    return (_plane_to_zz(y, qy, planar), _plane_to_zz(cb, qc, planar),
            _plane_to_zz(cr, qc, planar))


def _planes_front_end(r, g, b, qy, qc, pad_h: int, pad_w: int,
                      subsample: bool, overlay=None):
    """Front end of every planar encode path: optional BGRA overlay
    burn-in, then convert → 4:2:0 → DCT → quantize → zigzag as plain XLA
    (it is memory-bound, and XLA fuses the elementwise stages)."""
    if overlay is not None:
        from ..ttml.render import overlay_on_planes
        r, g, b = overlay_on_planes(r, g, b, overlay)
    return encode_gop_planes_to_coefs(r, g, b, qy, qc, pad_h=pad_h,
                                      pad_w=pad_w, subsample=subsample)


# ----------------------------------------------------------------------------
# host: headers
# ----------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=(
    "pad_h", "pad_w", "subsample", "layout", "prefix_words", "use_pallas",
    "seg_words"))
def _gop_dispatch_program(frames, qy, qc, overlay, pad_h, pad_w, subsample,
                          layout, prefix_words, use_pallas,
                          seg_words=None):
    """ONE device program: optional BGRA overlay burn-in → convert/DCT/
    quant/zigzag → entropy pack → combined (bits + prefix) output. With
    ``seg_words`` the round-4 SEGMENT layout replaces the block-granular
    concat: combined is (F, 1 + S + prefix) — aligned words, per-segment
    bit counts, word-aligned stream (host compacts)."""
    from .ops.entropy import (encode_gop_scans_combined,
                              encode_gop_scans_segmented)
    # interleaved frames take the planar front end via plane extraction
    yq, cbq, crq = _planes_front_end(
        frames[..., 0], frames[..., 1], frames[..., 2], qy, qc,
        pad_h=pad_h, pad_w=pad_w, subsample=subsample, overlay=overlay)
    if seg_words is not None:
        return encode_gop_scans_segmented(
            yq, cbq, crq, layout=layout, prefix_words=prefix_words,
            seg_words=seg_words, use_pallas=use_pallas)
    return encode_gop_scans_combined(
        yq, cbq, crq, layout=layout, prefix_words=prefix_words,
        use_pallas=use_pallas)


@functools.partial(jax.jit, static_argnames=(
    "src_fn", "pad_h", "pad_w", "subsample", "layout", "prefix_words",
    "use_pallas", "seg_words"))
def _gop_dispatch_program_src(start, qy, qc, overlay, src_fn, pad_h, pad_w,
                              subsample, layout, prefix_words, use_pallas,
                              seg_words=None):
    """_gop_dispatch_program with an on-device frame SOURCE fused in:
    ``src_fn(pad_h, pad_w, start) -> (F, pad_h, pad_w, 3) uint8`` traces
    into the same single program as the burn-in + encode: one dispatch
    per GOP, and the frames never round-trip through device memory as a
    separate program's output."""
    from .ops.entropy import (encode_gop_scans_combined,
                              encode_gop_scans_segmented)
    frames = src_fn(pad_h, pad_w, start)
    if isinstance(frames, (tuple, list)):
        # channel-planar source (e.g. testsrc.gradient_ball_planes): the
        # interleaved (F, H, W, 3) layout never exists in the program
        r, g, b = frames
        yq, cbq, crq = _planes_front_end(
            r, g, b, qy, qc, pad_h=pad_h, pad_w=pad_w,
            subsample=subsample, overlay=overlay)
    else:
        # interleaved source: extract planes (see _gop_dispatch_program)
        yq, cbq, crq = _planes_front_end(
            frames[..., 0], frames[..., 1], frames[..., 2], qy, qc,
            pad_h=pad_h, pad_w=pad_w, subsample=subsample, overlay=overlay)
    if seg_words is not None:
        return encode_gop_scans_segmented(
            yq, cbq, crq, layout=layout, prefix_words=prefix_words,
            seg_words=seg_words, use_pallas=use_pallas)
    return encode_gop_scans_combined(
        yq, cbq, crq, layout=layout, prefix_words=prefix_words,
        use_pallas=use_pallas)


def _marker(tag: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, tag, len(payload) + 2) + payload


def _dqt(qy: np.ndarray, qc: np.ndarray) -> bytes:
    zz = zigzag_order(8)
    payload = b""
    for tid, tab in ((0, qy), (1, qc)):
        payload += bytes([tid]) + bytes(int(v) for v in tab.flatten()[zz])
    return _marker(0xDB, payload)


def _sof0(h: int, w: int, subsample: bool) -> bytes:
    y_sampling = 0x22 if subsample else 0x11
    comps = [(1, y_sampling, 0), (2, 0x11, 1), (3, 0x11, 1)]
    payload = struct.pack(">BHHB", 8, h, w, len(comps))
    for cid, samp, tq in comps:
        payload += struct.pack(">BBB", cid, samp, tq)
    return _marker(0xC0, payload)


def _dht() -> bytes:
    payload = b""
    for tc_th, bits, vals in (
            (0x00, T.DC_LUMA_BITS, T.DC_LUMA_VALS),
            (0x10, T.AC_LUMA_BITS, T.AC_LUMA_VALS),
            (0x01, T.DC_CHROMA_BITS, T.DC_CHROMA_VALS),
            (0x11, T.AC_CHROMA_BITS, T.AC_CHROMA_VALS)):
        payload += bytes([tc_th]) + bytes(bits) + bytes(vals)
    return _marker(0xC4, payload)


def _sos() -> bytes:
    payload = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return _marker(0xDA, payload)


_APP0 = _marker(0xE0, b"JFIF\x00\x01\x01\x00" + struct.pack(">HH", 1, 1) + b"\x00\x00")


def jpeg_headers(h: int, w: int, qy: np.ndarray, qc: np.ndarray,
                 subsample: bool) -> bytes:
    return (b"\xff\xd8" + _APP0 + _dqt(qy, qc) + _sof0(h, w, subsample)
            + _dht() + _sos())


# ----------------------------------------------------------------------------
# host: entropy coding
# ----------------------------------------------------------------------------

def _encode_scan_python(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                        subsample: bool) -> bytes:
    """Pure-Python fallback scan encoder (MCU-interleaved, DC-predicted)."""
    tabs = T.code_tables()
    dcl, acl = tabs["dc_luma"], tabs["ac_luma"]
    dcc, acc = tabs["dc_chroma"], tabs["ac_chroma"]
    out = bytearray()
    acc_bits = 0
    nbits = 0

    def put(code: int, length: int):
        nonlocal acc_bits, nbits
        acc_bits = (acc_bits << length) | (code & ((1 << length) - 1))
        nbits += length
        while nbits >= 8:
            nbits -= 8
            b = (acc_bits >> nbits) & 0xFF
            out.append(b)
            if b == 0xFF:
                out.append(0x00)
        acc_bits &= (1 << nbits) - 1

    def block(z: np.ndarray, pred: int, dct_tab, act_tab) -> int:
        dc = int(z[0])
        diff = dc - pred
        s = abs(diff).bit_length()
        c, l = dct_tab[s]
        put(c, l)
        if s:
            put(diff if diff >= 0 else diff + (1 << s) - 1, s)
        run = 0
        for k in range(1, 64):
            v = int(z[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                c, l = act_tab[0xF0]
                put(c, l)
                run -= 16
            sz = abs(v).bit_length()
            c, l = act_tab[(run << 4) | sz]
            put(c, l)
            put(v if v >= 0 else v + (1 << sz) - 1, sz)
            run = 0
        if run:
            c, l = act_tab[0x00]
            put(c, l)
        return dc

    py = pcb = pcr = 0
    ybh, ybw = y.shape[:2]
    if subsample:
        for my in range(ybh // 2):
            for mx in range(ybw // 2):
                for sy in range(2):
                    for sx in range(2):
                        py = block(y[2 * my + sy, 2 * mx + sx], py, dcl, acl)
                pcb = block(cb[my, mx], pcb, dcc, acc)
                pcr = block(cr[my, mx], pcr, dcc, acc)
    else:
        for by in range(ybh):
            for bx in range(ybw):
                py = block(y[by, bx], py, dcl, acl)
                pcb = block(cb[by, bx], pcb, dcc, acc)
                pcr = block(cr[by, bx], pcr, dcc, acc)
    if nbits:
        put((1 << (8 - nbits)) - 1, 8 - nbits)
    return bytes(out)


@functools.lru_cache()
def _native_tables():
    arrs = T.code_arrays()
    out = {}
    for name, (codes, lengths) in arrs.items():
        out[name] = (
            np.ascontiguousarray(codes),
            np.ascontiguousarray(lengths),
        )
    return out


def _encode_scan_native(lib, y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                        subsample: bool) -> Optional[bytes]:
    tabs = _native_tables()
    ybh, ybw = y.shape[:2]
    cbh, cbw = cb.shape[:2]
    cap = y.nbytes + cb.nbytes + cr.nbytes + (1 << 16)
    out = np.empty(cap, dtype=np.uint8)
    c = ctypes

    def i16p(a):
        return a.ctypes.data_as(c.POINTER(c.c_int16))

    def tp(name):
        codes, lengths = tabs[name]
        return (codes.ctypes.data_as(c.POINTER(c.c_uint32)),
                lengths.ctypes.data_as(c.POINTER(c.c_uint8)))

    dcl = tp("dc_luma"); acl = tp("ac_luma")
    dcc = tp("dc_chroma"); acc = tp("ac_chroma")
    n = lib.flu_jpeg_encode_scan(
        i16p(y), ybw, ybh, i16p(cb), i16p(cr), cbw, cbh,
        1 if subsample else 0, 3,
        dcl[0], dcl[1], acl[0], acl[1], dcc[0], dcc[1], acc[0], acc[1],
        out.ctypes.data_as(c.POINTER(c.c_uint8)), cap)
    if n < 0:
        return None
    return out[:n].tobytes()


def encode_scan(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                subsample: bool) -> bytes:
    """Entropy-code one frame's coefficient planes ((BH,BW,64) int16 each)."""
    y = np.ascontiguousarray(y, dtype=np.int16)
    cb = np.ascontiguousarray(cb, dtype=np.int16)
    cr = np.ascontiguousarray(cr, dtype=np.int16)
    lib = native.get_lib()
    if lib is not None:
        data = _encode_scan_native(lib, y, cb, cr, subsample)
        if data is not None:
            return data
    return _encode_scan_python(y, cb, cr, subsample)


# ----------------------------------------------------------------------------
# public encoder
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _slice_words(n: int):
    """Jitted device slice so only the used prefix is fetched."""
    return jax.jit(lambda p: p[:, :n])


def resolve_segmented(explicit, use_pallas: bool) -> bool:
    """Resolve the segment-bitstream-layout default.

    Precedence: explicit arg > FLUTPU_SEGMENTED env (``0``/``false``/``no``
    force off, anything else forces on) > the platform default
    (flutpu.platform.segmented_default) where the Pallas packer runs;
    block concatenation with the scan packer."""
    if explicit is not None:
        return bool(explicit)
    from ..core.env import env_flag
    env = env_flag("FLUTPU_SEGMENTED")
    if env is not None:
        return env
    return bool(use_pallas) and platform.segmented_default()


def segmented_property(value) -> Optional[bool]:
    """Map an element ``segmented`` property (auto/true/false, any case,
    or a bool) to the encoder constructor arg (None = platform default)."""
    s = str(value).strip().lower()
    if s in ("auto", "", "none"):
        return None
    return s not in ("0", "false", "no")


class JpegEncoder:
    """Stateless-per-GOP JPEG encoder.

    engine:
      - "device": full entropy packing on the device
        (flutpu.codec.ops.entropy) — only compressed bits are fetched
        (~100 KB/frame instead of ~12 MB of raw coefficients)
      - "host": coefficients transferred, C++/Python Huffman on the host
      - "auto" (default): device engine, host fallback on cap overflow
    """

    # bit-capacity caps per block for the device engine's static output
    # buffer: start small (32 bytes/block), escalate on overflow (dense
    # content), final fallback to the host engine. Each cap is one compiled
    # variant per geometry.
    CAP_LADDER = (256, 1024, 1664)
    _WORD_BUCKET = 16 * 1024  # transfer granularity: 64 KB

    #: segment layout: blocks per segment and the adaptive
    #: per-segment staging capacity start/cap (words). The cap is the
    #: theoretical CAP_LADDER[-1] bound for SEG_G blocks.
    SEG_G = 16
    SEG_WORDS0 = 64

    def __init__(self, quality: int = 85, subsample: bool = True,
                 engine: str = "auto", use_pallas: Optional[bool] = None,
                 segmented: Optional[bool] = None):
        self.quality = quality
        self.subsample = subsample
        self.engine = engine
        # Pallas pack kernel or lax.scan packer: the platform decides
        # unless the caller asks (flutpu.platform.pack_kernel)
        self.use_pallas = platform.pack_kernel(use_pallas)
        # segment bitstream layout: device concat replaced by word-aligned
        # segment placement + host compaction (entropy.py). The platform
        # picks the default; FLUTPU_SEGMENTED=0/1 force-overrides it.
        self.segmented = resolve_segmented(segmented, self.use_pallas)
        self._seg_words = self.SEG_WORDS0
        self._seg_used_words = 0
        self._prefix_used_words: Optional[int] = None
        self._prefix_window: Optional[int] = None
        self._grow_pending = None   # (target sizes, Future) — see
        # _maybe_adopt_or_warm: grown programs compile off-thread.
        # The adaptive state above is read-modify-written from BOTH the
        # dispatch thread (_maybe_adopt_or_warm) and the pipelined
        # finalize workers (_note_*_usage / _overflow_sizes) — RLock, so
        # the overflow path can call the note/target helpers it shares
        # with the callers
        self._adapt_lock = threading.RLock()
        self.qy = scale_qtable(LUMA_QTABLE, quality)
        self.qc = scale_qtable(CHROMA_QTABLE, quality)
        self._qy_dev = jnp.asarray(self.qy)
        self._qc_dev = jnp.asarray(self.qc)

    def _coefs(self, frames: np.ndarray):
        f, h, w, _ = frames.shape
        mult = 16 if self.subsample else 8
        ph, pw = _pad_to(h, mult), _pad_to(w, mult)
        return encode_gop_to_coefs(
            jnp.asarray(frames), self._qy_dev, self._qc_dev,
            pad_h=ph, pad_w=pw, subsample=self.subsample)

    def encode_gop(self, frames: np.ndarray) -> List[bytes]:
        """(F, H, W, 3) uint8 RGB → one JFIF bytestream per frame."""
        f, h, w, _ = frames.shape
        coefs = self._coefs(frames)
        hdr = jpeg_headers(h, w, self.qy, self.qc, self.subsample)
        # scan_planes owns engine selection, the single-fetch combined
        # device path (adaptive window, segment layout) and the overflow
        # ladder/host fallbacks
        return [hdr + s + b"\xff\xd9" for s in self.scan_planes(coefs)]

    # -- async pipeline API (overlap dispatch with host finalization) ------
    # (the fused one-program dispatch lives at module level:
    # _gop_dispatch_program)
    # Fixed compressed-prefix fetched together with the bit counts: ONE
    # host transfer per GOP; the full packed buffer stays on device for
    # the rare prefix overflow.
    PREFIX_WORDS = 32768  # 128 KB per frame

    # adaptive-prefix buckets: tracking the previous GOP's actual bit
    # usage trims the fetch toward the true compressed size. The 10%
    # headroom rides out ordinary inter-GOP variance, and a content spike
    # costs one cap-ladder re-dispatch + estimate reset, not corruption.
    _PREFIX_BUCKET = 2048

    def _prefix_target(self) -> Optional[int]:
        """Pure policy half of the adaptive compressed-prefix window,
        with HYSTERESIS. Every distinct window value is a distinct static
        ``prefix_words`` → a full program recompile, so the window must
        not track usage closely: FVC residual streams drift ~1%/GOP, and
        a bucket boundary just above the estimate would recompile
        mid-pipeline.
        Policy: keep the current window while usage stays ≥2% below it;
        when growing, jump to usage*1.15 + 512 rounded up a bucket, so
        another grow needs >10% further drift. Shrink only via the
        overflow/spike reset. Returns the window the NEXT program should
        use WITHOUT adopting it (adoption = _prefix_estimate for the
        synchronous paths, _maybe_adopt_or_warm for streaming ones)."""
        used = getattr(self, "_prefix_used_words", None)
        if used is None:
            return None
        w = getattr(self, "_prefix_window", None)
        if w is not None and used * 1.02 + 128 <= w:
            return w
        est = int(used * 1.15) + 512
        est = ((est + self._PREFIX_BUCKET - 1)
               // self._PREFIX_BUCKET) * self._PREFIX_BUCKET
        return max(8192, est, w or 0)

    def _prefix_estimate(self) -> Optional[int]:
        """Adopt the target window immediately. Synchronous paths only
        (warmup, host-frame scan_planes, CPU backends): adopting a grown
        window makes the very next dispatch compile it on the calling
        thread."""
        est = self._prefix_target()
        if est is not None:
            self._prefix_window = est
        return est

    def _note_prefix_usage(self, used_words: int) -> None:
        """Record actual usage as a RUNNING MAX (monotone → the derived
        window never bounces between values); cleared by the spike
        reset."""
        with self._adapt_lock:
            prev = getattr(self, "_prefix_used_words", None) or 0
            self._prefix_used_words = max(prev, int(used_words))

    def _note_seg_usage(self, max_seg_bits: int) -> None:
        """Record the densest segment's usage (running max, mirroring the
        prefix usage). Capacity growth is decided by ``_seg_target`` and
        adopted synchronously here only on CPU backends — on the card
        adoption happens in ``_maybe_adopt_or_warm`` once the grown
        program has compiled OFF the streaming thread (a grown
        ``seg_words`` is a new static shape)."""
        used_words = (int(max_seg_bits) + 31) // 32
        with self._adapt_lock:
            self._seg_used_words = max(
                getattr(self, "_seg_used_words", 0), used_words)
            self._seg_gops = getattr(self, "_seg_gops", 0) + 1
            if not self._grow_async():
                self._seg_words = self._seg_target()

    def _seg_target(self) -> int:
        """Pure policy: staging capacity for the NEXT program — grow-only,
        doubling while the recorded densest segment exceeds 75% of
        capacity. Capacity costs device time (the staging buffer is
        zeroed per dispatch), so it stays as small as the content allows
        rather than pinned at the 832-word ladder bound. During WARMUP
        (first GOPs) the capacity covers 2x the observed usage: content
        classes whose densest segment jumps GOP-to-GOP (motion residuals,
        burn-in edges) outgrow a tighter warmup margin, and light streams
        (usage < capacity/2) are unaffected."""
        used = getattr(self, "_seg_used_words", 0)
        cap = _pad_to(self.SEG_G * self.CAP_LADDER[-1] // 32, 8)
        target = self._seg_words
        while used * 4 > target * 3 and target < cap:
            target = min(_pad_to(target * 2, 8), cap)
        if getattr(self, "_seg_gops", 0) <= 2 and used:
            target = min(cap, max(target, _pad_to(2 * used, 8)))
        return target

    def _grow_async(self) -> bool:
        """Grow window/capacity off the streaming thread? On the card a
        grown static size means a fresh compile, so the stream keeps
        dispatching the still-correct current program while the grow pool
        compiles the bigger one. On CPU compiles are cheap and synchronous
        adoption keeps tests deterministic."""
        return platform.grow_async()

    def _maybe_adopt_or_warm(self, build) -> Tuple[Optional[int], int]:
        """Streaming-path sizing: called by every dispatch entry with
        ``build(prefix_words, seg_words) -> (combined, prefix, sw)`` (the
        entry's own fused program at explicit sizes; it normalizes/caps
        its arguments and reports what it actually used). Returns the
        (prefix_window, seg_words) THIS dispatch should ride, and manages
        the background grow: adopt a finished warm, or submit one when
        the recorded usage outgrows the current sizes."""
        with self._adapt_lock:
            return self._maybe_adopt_or_warm_locked(build)

    def _maybe_adopt_or_warm_locked(self, build):
        tgt_w = self._prefix_target()
        if getattr(self, "_prefix_window", None) is None and tgt_w:
            # first derivation = warmup: there is no compiled adaptive
            # program to keep riding yet; adopt synchronously
            self._prefix_window = tgt_w
        if not self._grow_async():
            if tgt_w is not None:
                self._prefix_window = tgt_w
            self._seg_words = self._seg_target()
            return getattr(self, "_prefix_window", None), self._seg_words
        if getattr(self, "_seg_gops", 0) <= 2:
            # warmup: adopt the capacity synchronously — no program is
            # warm yet, and compiling the right size once beats compiling
            # a doomed small one first
            self._seg_words = self._seg_target()
        pending = getattr(self, "_grow_pending", None)
        if pending is not None:
            (pw_, sw_), fut = pending
            if fut.done():
                self._grow_pending = None
                if fut.exception() is None:
                    if pw_ is not None:
                        self._prefix_window = max(
                            pw_, getattr(self, "_prefix_window", None) or 0)
                    self._seg_words = max(sw_, self._seg_words)
                    CAT.info("adopted grown program: window=%s seg_words=%s",
                             self._prefix_window, self._seg_words)
                else:
                    CAT.warning("background grow failed: %s",
                                pending[1].exception())
        else:
            cur_w = getattr(self, "_prefix_window", None)
            tgt_s = self._seg_target()
            if (tgt_w or 0) > (cur_w or 0) or tgt_s > self._seg_words:
                tgt = (max(tgt_w or 0, cur_w or 0) or None,
                       max(tgt_s, self._seg_words))
                CAT.info("warming grown program: window=%s seg_words=%s",
                         *tgt)
                self._grow_pending = (tgt, _grow_pool().submit(
                    _warm_grown, build, tgt[0], tgt[1]))
        return getattr(self, "_prefix_window", None), self._seg_words

    def _overflow_sizes(self, used_words: int,
                        seg_need_words: Optional[int]):
        """Sizes for a true-overflow redispatch, PREFERRING a pending
        background warm that already covers the need — its compile is
        underway, and waiting for it beats compiling yet another size."""
        with self._adapt_lock:
            self._note_prefix_usage(int(used_words))
            if seg_need_words:
                self._seg_used_words = max(
                    getattr(self, "_seg_used_words", 0),
                    int(seg_need_words))
            pending = getattr(self, "_grow_pending", None)
            covers = False
            if pending is not None:
                (pw_, sw_), fut = pending
                w_ok = (pw_ or 0) >= used_words or (
                    pw_ is None
                    and (getattr(self, "_prefix_window", None) or 0)
                    >= used_words)
                covers = w_ok and (not seg_need_words
                                   or sw_ >= seg_need_words)
        if covers:
            # wait for the covering compile WITHOUT the lock: a finalize
            # worker must not block the dispatch thread's sizing calls
            # for the duration of a compile
            try:
                fut.result()
                with self._adapt_lock:
                    if getattr(self, "_grow_pending", None) is pending:
                        self._grow_pending = None
                    if pw_ is not None:
                        self._prefix_window = max(
                            pw_, getattr(self, "_prefix_window", None) or 0)
                    self._seg_words = max(sw_, self._seg_words)
                    return self._prefix_window, self._seg_words
            except Exception as e:
                CAT.warning("pending warm failed during overflow: %s", e)
                with self._adapt_lock:
                    if getattr(self, "_grow_pending", None) is pending:
                        self._grow_pending = None
        with self._adapt_lock:
            new_prefix = self._prefix_estimate()
            self._seg_words = max(self._seg_words, self._seg_target())
            return new_prefix, self._seg_words

    def _reset_prefix_spike(self) -> None:
        """Spike reset (content burst beyond the adaptive sizes): clear
        the usage record and window so the next derivation starts fresh.
        Takes the adapt lock — finalize workers reset concurrently with
        other workers' locked read-modify-writes, and a lock-free reset
        could be half-undone by a racing _note_prefix_usage (leaving
        window None with a huge recorded usage → a spike-sized program
        compiled synchronously on the streaming thread)."""
        with self._adapt_lock:
            self._prefix_used_words = None
            self._prefix_window = None

    def _prefix_cap(self, layout) -> int:
        """Geometry-scaled compressed-prefix cap: ~1 word (32 bits) per
        block covers ~2.7x typical q85 usage, so 4K scans (~74K words vs
        the 1080p-sized 32768 constant) no longer overflow into the
        cap-ladder fallback on EVERY GOP; the theoretical per-block
        ladder bound still applies."""
        theo = _pad_to(layout.n_blocks * self.CAP_LADDER[-1] // 32,
                       self._WORD_BUCKET)
        geo = _pad_to(max(self.PREFIX_WORDS, layout.n_blocks),
                      self._WORD_BUCKET)
        return min(geo, theo)

    def encode_gop_dispatch(self, frames_dev: jax.Array, h: int, w: int,
                            overlay: Optional[jax.Array] = None):
        """Dispatch the full device encode of a GOP already resident on
        device ((F, PH, PW, 3) uint8, dims pre-padded). Non-blocking;
        returns an opaque handle for ``encode_gop_finalize``.

        The whole GOP — optional subtitle burn-in, convert/DCT/quant,
        entropy pack — runs as ONE fused program, which saves the
        intermediate round trips through device memory. ``overlay`` is an
        (h', w', 4) BGRA frame composited over every frame first."""
        from .ops.entropy import mcu_layout
        ph, pw = frames_dev.shape[1], frames_dev.shape[2]
        if self.subsample:
            layout = mcu_layout(pw // 8, ph // 8, pw // 16, ph // 16, True)
        else:
            layout = mcu_layout(pw // 8, ph // 8, pw // 8, ph // 8, False)
        cap = self._prefix_cap(layout)

        def build(prefix_w, sw_w):
            p = min(cap, prefix_w or cap)
            s = sw_w if self.segmented else None
            return _gop_dispatch_program(
                frames_dev, self._qy_dev, self._qc_dev, overlay,
                pad_h=ph, pad_w=pw, subsample=self.subsample, layout=layout,
                prefix_words=p, use_pallas=self.use_pallas,
                seg_words=s), p, s

        build.prefix_cap = cap  # _refinalize_grown coverage check
        win, sw = self._maybe_adopt_or_warm(build)
        combined, prefix, sw = build(win, sw)
        return (combined, frames_dev, overlay, prefix, h, w,
                self._n_segs(layout) if self.segmented else 0, sw, build)

    def encode_gop_dispatch_src(self, src_fn, start, h: int, w: int,
                                ph: int, pw: int,
                                overlay: Optional[jax.Array] = None):
        """encode_gop_dispatch with the frame SOURCE fused into the same
        device program: ``src_fn(ph, pw, start) -> (F, ph, pw, 3) uint8``
        OR a channel-planar ``(r, g, b)`` tuple of (F, ph, pw) planes
        (preferred: the interleaved layout never exists). One dispatch
        instead of two per GOP. Finalize with ``encode_gop_finalize``."""
        from .ops.entropy import mcu_layout
        if self.subsample:
            layout = mcu_layout(pw // 8, ph // 8, pw // 16, ph // 16, True)
        else:
            layout = mcu_layout(pw // 8, ph // 8, pw // 8, ph // 8, False)
        cap = self._prefix_cap(layout)

        def build(prefix_w, sw_w):
            p = min(cap, prefix_w or cap)
            s = sw_w if self.segmented else None
            return _gop_dispatch_program_src(
                start, self._qy_dev, self._qc_dev, overlay, src_fn,
                pad_h=ph, pad_w=pw, subsample=self.subsample, layout=layout,
                prefix_words=p, use_pallas=self.use_pallas,
                seg_words=s), p, s

        build.prefix_cap = cap  # _refinalize_grown coverage check
        win, sw = self._maybe_adopt_or_warm(build)
        combined, prefix, sw = build(win, sw)

        # frames synthesize lazily for the rare host/ladder fallback (a
        # planar src is stacked to the interleaved form the fallback
        # re-encode expects — identical values, rare path)
        def lazy_frames():
            out = src_fn(ph, pw, start)
            if isinstance(out, (tuple, list)):
                out = jnp.stack(out, axis=-1)
            return out

        return (combined, lazy_frames, overlay, prefix, h, w,
                self._n_segs(layout) if self.segmented else 0, sw, build)

    def _n_segs(self, layout) -> int:
        """Segments per frame in the segment layout (frame blocks padded
        to a SEG_G multiple)."""
        return (layout.n_blocks + self.SEG_G - 1) // self.SEG_G

    def encode_gop_finalize(self, handle) -> List[bytes]:
        """Blocking half: one fetch, stuff, wrap headers."""
        from .ops.entropy import (compact_segments_finalize,
                                  stuff_and_finalize)
        combined, frames_dev, overlay, prefix, h, w, n_segs, sw, build = \
            handle
        arr = np.asarray(combined)  # single transfer: bits + prefixes
        hdr = jpeg_headers(h, w, self.qy, self.qc, self.subsample)
        if n_segs:
            # segment layout: [0]=aligned words, [1..S]=segment bits,
            # [S+1..]=word-aligned stream (host compacts). Overflow is
            # judged against the capacity the DISPATCH compiled with
            # (``sw`` from the handle) — pipelined finalize can observe a
            # grown ``self._seg_words``.
            used = arr[:, 0].astype(np.int64)
            segbits = arr[:, 1:1 + n_segs].astype(np.int64)
            if (used > prefix).any() or (segbits > sw * 32).any():
                return self._refinalize_grown(handle, hdr, used, segbits)
            self._note_prefix_usage(int(used.max()))
            self._note_seg_usage(int(segbits.max()))
            return [hdr + compact_segments_finalize(segbits[i],
                                                    arr[i, 1 + n_segs:])
                    + b"\xff\xd9" for i in range(arr.shape[0])]
        bits_host = arr[:, 0].astype(np.int64)
        if (bits_host > prefix * 32).any():
            return self._refinalize_grown(handle, hdr,
                                          (bits_host + 31) // 32, None)
        self._note_prefix_usage((bits_host.max() + 31) // 32)
        return [hdr + stuff_and_finalize(arr[i, 1:], int(bits_host[i]))
                + b"\xff\xd9" for i in range(arr.shape[0])]

    def _refinalize_grown(self, handle, hdr: bytes, used_words,
                          segbits) -> List[bytes]:
        """Mid-stream overflow (rare — the background grow usually runs
        ahead of content drift): the device reported the TRUE usage, so
        grow window/capacity to cover it and redispatch the SAME program
        family ONCE — the grown program is exactly the one subsequent
        GOPs dispatch, so its compile was needed anyway."""
        combined, frames, overlay, prefix, h, w, n_segs, sw, build = handle
        if build is None:  # safety: a redispatch still overflowed
            self._reset_prefix_spike()
            return self._finalize_overflow(handle, hdr)
        seg_need = None
        if n_segs and segbits is not None and (segbits > sw * 32).any():
            seg_need = (int(segbits.max()) + 31) // 32
        w_need = int(np.max(used_words))
        new_prefix, new_sw = self._overflow_sizes(w_need, seg_need)
        new_prefix = new_prefix or prefix
        # the redispatch is only worth its (possible) compile if the
        # grown sizes COVER the device-reported need — "grew a bit" is not
        # enough: a need above the geometry cap / capacity ladder bound
        # would deterministically overflow again, so go straight to the
        # ladder/host fallback without compiling or fetching a doomed
        # program. eff_p mirrors build's own cap clamp.
        cap = getattr(build, "prefix_cap", None)
        eff_p = min(cap, new_prefix) if cap else new_prefix
        if w_need > eff_p or (seg_need and seg_need > new_sw):
            self._reset_prefix_spike()
            return self._finalize_overflow(handle, hdr)
        CAT.info("overflow redispatch: window %s->%s seg_words %s->%s",
                 prefix, new_prefix, sw, new_sw)
        combined2, p2, s2 = build(new_prefix, new_sw)
        if p2 < w_need or (seg_need and (s2 or 0) < seg_need):
            # safety for builds without a prefix_cap attribute: the
            # normalized sizes still don't cover the need — don't fetch
            # a guaranteed second overflow
            self._reset_prefix_spike()
            return self._finalize_overflow(handle, hdr)
        return self.encode_gop_finalize(
            (combined2, frames, overlay, p2, h, w, n_segs, s2, None))

    def _finalize_overflow(self, handle, hdr: bytes) -> List[bytes]:
        """Rare spike path shared by both combined layouts: re-encode the
        GOP through the cap ladder from (re-synthesized) frames."""
        _, frames_dev, overlay, _, _, _, _, _, _ = handle
        if callable(frames_dev):   # src-fused dispatch: re-synthesize
            frames_dev = frames_dev()
        ph, pw = frames_dev.shape[1], frames_dev.shape[2]
        if overlay is not None:
            from ..ttml.render import overlay_on_frames
            frames_dev = overlay_on_frames(frames_dev, overlay)
        coefs = encode_gop_to_coefs(
            frames_dev, self._qy_dev, self._qc_dev, pad_h=ph, pad_w=pw,
            subsample=self.subsample)
        scans = self._scans_device(coefs) or self._scans_host(coefs)
        return [hdr + s + b"\xff\xd9" for s in scans]

    def scan_planes(self, coefs) -> List[bytes]:
        """Entropy-code already-quantized (F, BH, BW, 64) int16 zigzag
        coefficient planes to baseline scans (no JFIF wrapper). Shared by
        the JPEG and FVC encoders: device engine with a single combined
        fetch per GOP, cap-ladder escalation, host fallback."""
        if self.engine in ("device", "auto"):
            from .ops.entropy import (compact_segments_finalize,
                                      encode_gop_scans_combined,
                                      encode_gop_scans_segmented,
                                      mcu_layout, stuff_and_finalize)
            yq, cbq, crq = coefs
            layout = mcu_layout(yq.shape[2], yq.shape[1],
                                cbq.shape[2], cbq.shape[1], self.subsample)
            prefix = self._prefix_cap(layout)
            est = self._prefix_estimate()
            if est is not None:
                prefix = min(prefix, est)
            if self.segmented:
                n_segs = self._n_segs(layout)
                cap = self._prefix_cap(layout)
                for attempt in range(2):
                    combined = encode_gop_scans_segmented(
                        jnp.asarray(yq), jnp.asarray(cbq), jnp.asarray(crq),
                        layout=layout, prefix_words=prefix,
                        seg_words=self._seg_words,
                        use_pallas=self.use_pallas)
                    arr = np.asarray(combined)
                    used = arr[:, 0].astype(np.int64)
                    segbits = arr[:, 1:1 + n_segs].astype(np.int64)
                    if not ((used > prefix).any()
                            or (segbits > self._seg_words * 32).any()):
                        self._note_prefix_usage(int(used.max()))
                        self._note_seg_usage(int(segbits.max()))
                        return [compact_segments_finalize(
                            segbits[i], arr[i, 1 + n_segs:])
                            for i in range(arr.shape[0])]
                    if attempt:
                        break
                    # the device reported the TRUE usage: grow to cover it
                    # and retry the SAME segmented program once (the grown
                    # sizes are what later GOPs use) before the ladder
                    self._note_prefix_usage(int(used.max()))
                    prefix = min(cap, self._prefix_estimate() or prefix)
                    self._seg_used_words = max(
                        getattr(self, "_seg_used_words", 0),
                        (int(segbits.max()) + 31) // 32)
                    self._seg_words = max(self._seg_words,
                                          self._seg_target())
                scans = self._scans_device(coefs)
                if scans is not None:
                    return scans
                if self.engine == "device":
                    raise OverflowError("device entropy cap exceeded")
                return self._scans_host(coefs)
            combined = encode_gop_scans_combined(
                jnp.asarray(yq), jnp.asarray(cbq), jnp.asarray(crq),
                layout=layout, prefix_words=prefix,
                use_pallas=self.use_pallas)
            arr = np.asarray(combined)  # ONE transfer: bits + prefixes
            bits_host = arr[:, 0].astype(np.int64)
            if not (bits_host > prefix * 32).any():
                # track actual usage for the adaptive window (mirror of
                # encode_gop_finalize — a stale low estimate would make
                # every later call overflow into the double-dispatch path)
                self._note_prefix_usage((bits_host.max() + 31) // 32)
                return [stuff_and_finalize(arr[i, 1:], int(bits_host[i]))
                        for i in range(arr.shape[0])]
            self._reset_prefix_spike()
            scans = self._scans_device(coefs)  # rare: dense content
            if scans is not None:
                return scans
            if self.engine == "device":
                raise OverflowError("device entropy cap exceeded")
        return self._scans_host(coefs)

    def _scans_host(self, coefs) -> List[bytes]:
        yq, cbq, crq = (np.asarray(c) for c in coefs)
        f = yq.shape[0]
        if f > 1 and native.get_lib() is not None:
            # the C coder releases the GIL: thread across frames
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=min(f, 8)) as pool:
                return list(pool.map(
                    lambda i: encode_scan(yq[i], cbq[i], crq[i],
                                          self.subsample), range(f)))
        return [encode_scan(yq[i], cbq[i], crq[i], self.subsample)
                for i in range(f)]

    def _scans_device(self, coefs) -> Optional[List[bytes]]:
        from .ops.entropy import encode_gop_scans, mcu_layout, stuff_and_finalize
        yq, cbq, crq = coefs
        f, ybh, ybw = yq.shape[:3]
        cbh, cbw = cbq.shape[1:3]
        layout = mcu_layout(ybw, ybh, cbw, cbh, self.subsample)
        for cap in self.CAP_LADDER:
            out_words = _pad_to(layout.n_blocks * cap // 32,
                                self._WORD_BUCKET)
            packed, bits = encode_gop_scans(yq, cbq, crq, layout=layout,
                                            out_words=out_words,
                                            use_pallas=self.use_pallas)
            bits_host = np.asarray(bits)
            if (bits_host > out_words * 32).any():
                continue  # escalate cap (dense content)
            words_needed = int((bits_host.max() + 31) // 32)
            fetch = min(out_words,
                        _pad_to(max(words_needed, 1), self._WORD_BUCKET))
            packed_host = np.asarray(_slice_words(fetch)(packed))
            return [stuff_and_finalize(packed_host[i], int(bits_host[i]))
                    for i in range(f)]
        return None  # beyond the ladder → host engine

    def encode_frame(self, frame: np.ndarray) -> bytes:
        return self.encode_gop(frame[None])[0]


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode with an independent decoder (PIL) — interop check for tests."""
    from PIL import Image
    img = Image.open(io.BytesIO(data))
    return np.asarray(img.convert("RGB"))


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0 ** 2 / mse)
