"""On-device JPEG entropy packing.

Only the compressed bits (~100 KB per 1080p frame) leave the device; the
host byte-stuffs and wraps headers. Entropy coding is serial only in its
textbook form. Here it is re-expressed as data-parallel passes:

1. per-block symbol/bit-length computation (vectorized over all blocks in
   MCU order; run-lengths via cumulative max, DC prediction via static
   prev-same-component shifts)
2. intra-block bit packing: each block (or each segment of ``seg_g``
   consecutive blocks) packs its slots into its own word buffer — the
   Pallas kernel of ``pack_kernel.py`` on the card, a ``lax.scan`` over
   the slots as the plain reference
3. inter-block concatenation: either block-granular (for each output
   word, the blocks overlapping it) or segment-granular (segments land
   word-aligned on the device and the host compacts them)

The result is bit-identical to the host C++ encoder (tests enforce it).
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import jpeg_tables as T

# Max blocks overlapping one 32-bit output word. A block is at least
# DC(>=2 bits) + EOB(>=2 bits) = 4 bits, so at most ceil(31/4) = 8 blocks
# can START inside a word, plus the one containing its first bit.
_MAX_SPAN = 9
_BLOCK_WORDS = 64  # per-block staging buffer (52 words true worst case)
_NUM_SLOTS = 1 + 63 * 3 + 1  # DC + 3 per AC position + EOB


class McuLayout:
    """Static (per geometry) index maps for MCU-ordered processing.

    Hashable by geometry key so it can be a jit static argument."""

    __slots__ = ("block_sel", "comp_is_chroma", "prev_same_comp",
                 "n_blocks", "max_span", "_key")

    def __init__(self, block_sel, comp_is_chroma, prev_same_comp,
                 n_blocks, key):
        self.block_sel = block_sel          # (B,) into concat [Y|Cb|Cr]
        self.comp_is_chroma = comp_is_chroma  # (B,) 0/1
        self.prev_same_comp = prev_same_comp  # (B,) prev same-comp idx, -1 first
        self.n_blocks = n_blocks
        # worst-case blocks overlapping one 32-bit output word, derived
        # from the actual Huffman-table minima (vs the conservative
        # _MAX_SPAN): fewer overlap candidates = fewer gathers in concat
        self.max_span = _layout_max_span(comp_is_chroma)
        self._key = key

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, McuLayout) and self._key == other._key

    def __repr__(self):
        return f"McuLayout{self._key}"


@functools.lru_cache()
def _min_block_bits() -> Tuple[int, int]:
    """Provable minimum bits of one encoded block, per component class.

    A block always emits a DC slot (code + size extra bits) and ends with
    either an EOB code or — when coefficient 63 is nonzero — at least one
    AC code + extra bits; take the minimum over both tails."""
    dc_code, dc_len, ac_code, ac_len = _device_tables()
    mins = []
    for comp in range(2):
        dc_min = min(int(dc_len[comp, s]) + s for s in range(12))
        tail_min = int(ac_len[comp, 0x00])  # EOB
        for run in range(16):
            for size in range(1, 11):
                tail_min = min(tail_min,
                               int(ac_len[comp, (run << 4) | size]) + size)
        mins.append(dc_min + tail_min)
    return mins[0], mins[1]


def _layout_max_span(comp_is_chroma: np.ndarray) -> int:
    """Max blocks overlapping one 32-bit word for this MCU comp sequence:
    1 (the block containing the word's first bit) + the most block STARTS
    that fit strictly inside the remaining 31 bits at table-minimum
    sizes."""
    luma_min, chroma_min = _min_block_bits()
    minbits = np.where(np.asarray(comp_is_chroma) > 0, chroma_min,
                       luma_min).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(minbits)])
    # starts at i, i+1, ... while cum[j] - cum[i] <= 31
    ends = np.searchsorted(cum, cum[:-1] + 31, side="right")
    return int((ends - np.arange(len(minbits))).max()) + 1


@functools.lru_cache(maxsize=32)
def mcu_layout(ybw: int, ybh: int, cbw: int, cbh: int,
               subsample: bool) -> McuLayout:
    """Block processing order of a baseline interleaved scan.

    4:2:0 MCU = 4 Y (2x2) + Cb + Cr; 4:4:4 MCU = Y + Cb + Cr. Y blocks
    occupy rows [0, ybw*ybh) of the concatenated coefficient array, Cb the
    next cbw*cbh, then Cr.
    """
    order = []
    comp = []
    y_base, cb_base = 0, ybw * ybh
    cr_base = cb_base + cbw * cbh
    if subsample:
        for my in range(ybh // 2):
            for mx in range(ybw // 2):
                for sy in range(2):
                    for sx in range(2):
                        order.append(y_base + (2 * my + sy) * ybw + (2 * mx + sx))
                        comp.append(0)
                order.append(cb_base + my * cbw + mx)
                comp.append(1)
                order.append(cr_base + my * cbw + mx)
                comp.append(2)
    else:
        for by in range(ybh):
            for bx in range(ybw):
                order.append(y_base + by * ybw + bx)
                comp.append(0)
                order.append(cb_base + by * ybw + bx)
                comp.append(1)
                order.append(cr_base + by * ybw + bx)
                comp.append(2)
    order = np.asarray(order, dtype=np.int32)
    comp = np.asarray(comp, dtype=np.int32)
    prev = np.full(len(order), -1, dtype=np.int32)
    last: Dict[int, int] = {}
    for i, c in enumerate(comp):
        if int(c) in last:
            prev[i] = last[int(c)]
        last[int(c)] = i
    return McuLayout(order, (comp > 0).astype(np.int32), prev, len(order),
                     key=(ybw, ybh, cbw, cbh, subsample))


@functools.lru_cache()
def _device_tables():
    """Huffman tables as (2, 256) arrays [luma, chroma] for code and len."""
    arrs = T.code_arrays()
    dc_code = np.stack([arrs["dc_luma"][0], arrs["dc_chroma"][0]]).astype(np.int32)
    dc_len = np.stack([arrs["dc_luma"][1], arrs["dc_chroma"][1]]).astype(np.int32)
    ac_code = np.stack([arrs["ac_luma"][0], arrs["ac_chroma"][0]]).astype(np.int32)
    ac_len = np.stack([arrs["ac_luma"][1], arrs["ac_chroma"][1]]).astype(np.int32)
    return dc_code, dc_len, ac_code, ac_len


def _magnitude(v: jnp.ndarray, max_bits: int) -> jnp.ndarray:
    """JPEG size category of |v| via thresholds (branchless)."""
    a = jnp.abs(v)
    size = jnp.zeros_like(v)
    for i in range(max_bits):
        size = size + (a >= (1 << i)).astype(v.dtype)
    return size


def _slot_pieces(zz: jnp.ndarray, comp_chroma: jnp.ndarray):
    """Shared symbol computation for both slot-table layouts: returns
    (dc_len, dc_val, A_len, A_val, B_len, B_val, C_len, C_val, eob_len,
    eob_val) — DC/EOB are (B,), AC pieces are (B, 63)."""
    dc_code_np, dc_len_np, ac_code_np, ac_len_np = _device_tables()
    b = zz.shape[0]
    comp = comp_chroma  # (B,)

    # --- DC slot ---------------------------------------------------------
    diff = zz[:, 0]
    dsize = _magnitude(diff, 12)
    dc_code = jnp.asarray(dc_code_np)[comp, dsize]
    dc_len = jnp.asarray(dc_len_np)[comp, dsize]
    extra = jnp.where(diff < 0, diff + (1 << dsize) - 1, diff)
    dc_slot_len = dc_len + dsize
    dc_slot_val = (dc_code << dsize) | (extra & ((1 << dsize) - 1))

    # --- AC run-lengths --------------------------------------------------
    ac = zz[:, 1:]  # (B, 63) positions k=1..63
    k = jnp.arange(1, 64, dtype=jnp.int32)[None, :]
    nz = (ac != 0)
    marked = jnp.where(nz, k, 0)
    prev_incl = jax.lax.cummax(marked, axis=1)
    prev = jnp.concatenate(
        [jnp.zeros((b, 1), jnp.int32), prev_incl[:, :-1]], axis=1)
    run = k - prev - 1  # zeros since previous nonzero (valid where nz)

    asize = _magnitude(ac, 11)
    zrl_count = jnp.where(nz, run >> 4, 0)
    rem = run & 15
    sym = (rem << 4) | asize
    ac_code = jnp.asarray(ac_code_np)[comp[:, None], sym]
    ac_len = jnp.asarray(ac_len_np)[comp[:, None], sym]
    aextra = jnp.where(ac < 0, ac + (1 << asize) - 1, ac)

    # comp is binary: ZRL/EOB lookups are plain selects
    zrl_code = jnp.where(comp == 1, int(ac_code_np[1, 0xF0]),
                         int(ac_code_np[0, 0xF0]))
    zrl_len = jnp.where(comp == 1, int(ac_len_np[1, 0xF0]),
                        int(ac_len_np[0, 0xF0]))

    # slot A: up to two ZRLs; slot B: third ZRL; slot C: code + extra bits
    c2 = jnp.minimum(zrl_count, 2)
    slotA_len = jnp.where(nz, c2 * zrl_len[:, None], 0)
    zc = zrl_code[:, None]
    zl = zrl_len[:, None]
    slotA_val = jnp.where(c2 == 2, (zc << zl) | zc, jnp.where(c2 == 1, zc, 0))
    slotB_len = jnp.where(nz & (zrl_count >= 3), zrl_len[:, None], 0)
    slotB_val = jnp.where(slotB_len > 0, zc, 0)
    slotC_len = jnp.where(nz, ac_len + asize, 0)
    slotC_val = jnp.where(
        nz, (ac_code << asize) | (aextra & ((1 << asize) - 1)), 0)

    # --- EOB slot --------------------------------------------------------
    last_nz = prev_incl[:, -1]  # 0 when no nonzero AC
    eob_needed = last_nz < 63
    eob_code = jnp.where(comp == 1, int(ac_code_np[1, 0x00]),
                         int(ac_code_np[0, 0x00]))
    eob_len_t = jnp.where(comp == 1, int(ac_len_np[1, 0x00]),
                          int(ac_len_np[0, 0x00]))
    eob_len = jnp.where(eob_needed, eob_len_t, 0)
    eob_val = jnp.where(eob_needed, eob_code, 0)

    return (dc_slot_len, dc_slot_val, slotA_len, slotA_val, slotB_len,
            slotB_val, slotC_len, slotC_val, eob_len, eob_val)


def _slot_tables(zz: jnp.ndarray, comp_chroma: jnp.ndarray):
    """Per-block per-slot (length, value) arrays.

    zz: (B, 64) int32 zigzagged quantized coefficients in MCU order with the
    DC channel already replaced by the DC *difference*.
    Returns lens, vals: (B, _NUM_SLOTS) int32.
    """
    b = zz.shape[0]
    (dc_slot_len, dc_slot_val, slotA_len, slotA_val, slotB_len, slotB_val,
     slotC_len, slotC_val, eob_len, eob_val) = _slot_pieces(
        zz, comp_chroma)

    # interleave AC slots: (B, 63, 3) → (B, 189)
    ac_lens = jnp.stack([slotA_len, slotB_len, slotC_len], axis=-1).reshape(b, -1)
    ac_vals = jnp.stack([slotA_val, slotB_val, slotC_val], axis=-1).reshape(b, -1)

    lens = jnp.concatenate(
        [dc_slot_len[:, None], ac_lens, eob_len[:, None]], axis=1)
    vals = jnp.concatenate(
        [dc_slot_val[:, None], ac_vals, eob_val[:, None]], axis=1)
    return lens, vals


_NUM_SLOTS_M = 1 + 63 + 1  # merged: DC + one 64-bit slot per AC pos + EOB


def _shl64(hi: jnp.ndarray, lo: jnp.ndarray, s: jnp.ndarray):
    """(hi, lo) uint32 pair << s for s in [0, 31]."""
    s = s.astype(jnp.uint32)
    spill = jnp.where(s > 0, lo >> ((32 - s) & 31), 0)
    return (hi << s) | spill, lo << s


def _slot_tables_merged(zz: jnp.ndarray, comp_chroma: jnp.ndarray):
    """Merged-slot variant of _slot_tables: per AC position the up-to-three
    codes (ZRL pair, third ZRL, AC code + extra bits) compose into ONE
    64-bit slot, shrinking the slot axis 191 -> 65 so the bit-pack loop
    bound drops ~3x (the pack kernel iterates to the LAST active slot).

    Returns (lens, his, los): (B, 65) int32/uint32/uint32; slot value is
    the low ``len`` bits of (hi << 32) | lo, len <= 59.
    """
    (dc_len, dc_val, la, va, lb, vb, lc, vc, eob_len, eob_val) = \
        _slot_pieces(zz, comp_chroma)
    va = va.astype(jnp.uint32)
    vb = vb.astype(jnp.uint32)
    vc = vc.astype(jnp.uint32)
    hi = jnp.zeros_like(va)
    lo = va
    hi, lo = _shl64(hi, lo, lb)
    lo = lo | vb
    hi, lo = _shl64(hi, lo, lc)
    lo = lo | vc
    mlen = la + lb + lc

    dc_val = dc_val.astype(jnp.uint32)
    eob_val = eob_val.astype(jnp.uint32)
    lens_m = jnp.concatenate([dc_len[:, None], mlen, eob_len[:, None]],
                             axis=1)
    his_m = jnp.concatenate(
        [jnp.zeros_like(dc_val)[:, None], hi,
         jnp.zeros_like(eob_val)[:, None]], axis=1)
    los_m = jnp.concatenate([dc_val[:, None], lo, eob_val[:, None]], axis=1)
    return lens_m, his_m, los_m


def _place96(hi: jnp.ndarray, lo: jnp.ndarray, slen: jnp.ndarray,
             q: jnp.ndarray):
    """Place a len-bit value (low bits of hi:lo) at bit offset q of a
    96-bit window; returns (c0, c1, c2) uint32 MSB-first. Valid for
    slen >= 1, q in [0, 31] (masked out by callers when slen == 0)."""
    t = q + slen
    r = jnp.clip(96 - t, 0, 95)            # left shift of (0, hi, lo)
    k = r >> 5
    m = (r & 31).astype(jnp.uint32)
    minv = ((32 - m) & 31).astype(jnp.uint32)
    spill_hi = jnp.where(m > 0, hi >> minv, 0)
    spill_lo = jnp.where(m > 0, lo >> minv, 0)
    c0 = jnp.where(k == 0, spill_hi,
                   jnp.where(k == 1, (hi << m) | spill_lo, lo << m))
    c1 = jnp.where(k == 0, (hi << m) | spill_lo,
                   jnp.where(k == 1, lo << m, 0))
    c2 = jnp.where(k == 0, lo << m, 0)
    return c0, c1, c2


def _pack_block_bits64(lens: jnp.ndarray, his: jnp.ndarray,
                       los: jnp.ndarray, n_words: int = _BLOCK_WORDS):
    """64-bit-slot variant of _pack_block_bits (bit-identical stream).

    lens: (B, S) int32, his/los: (B, S) uint32. Returns (buf (B, n_words)
    uint32 MSB-first, nbits (B,) int32); bits past ``n_words`` words are
    dropped but still counted.
    """
    b, s = lens.shape
    word_iota = jnp.arange(n_words, dtype=jnp.int32)[None, :]

    def step(carry, xs):
        buf, off = carry
        slen, hi, lo = xs
        c0, c1, c2 = _place96(hi, lo, slen, off & 31)
        widx = (off >> 5)[:, None]
        active = (slen > 0)[:, None]
        upd = (jnp.where(active & (word_iota == widx), c0[:, None], 0)
               | jnp.where(active & (word_iota == widx + 1), c1[:, None], 0)
               | jnp.where(active & (word_iota == widx + 2), c2[:, None], 0))
        return (buf | upd, off + slen), None

    buf0 = jnp.zeros((b, n_words), jnp.uint32)
    off0 = jnp.zeros((b,), jnp.int32)
    (buf, nbits), _ = jax.lax.scan(
        step, (buf0, off0), (lens.T, his.T, los.T))
    return buf, nbits


def _pack_segments_scan(zz: jnp.ndarray, comp: jnp.ndarray, seg_g: int,
                        n_words: int):
    """Plain reference of the segment packer: the slot scan run over the
    concatenated slots of each segment's ``seg_g`` blocks. zz (B, 64)
    int32 DC-differenced MCU-ordered blocks, comp (B,) int32 (0 luma,
    1 chroma, -1 padding: no bits). Returns (buf (S, n_words) uint32,
    nbits (S,) int32), S = B / seg_g."""
    lens, his, los = _slot_tables_merged(zz, jnp.maximum(comp, 0))
    lens = jnp.where((comp >= 0)[:, None], lens, 0)
    s = zz.shape[0] // seg_g
    return _pack_block_bits64(lens.reshape(s, -1), his.reshape(s, -1),
                              los.reshape(s, -1), n_words=n_words)


def pack_segments(zz: jnp.ndarray, comp: jnp.ndarray, seg_g: int,
                  n_words: int, use_pallas: bool):
    """Segment packer: the Pallas kernel (``pack_kernel.pack_segments``)
    or the plain scan. Bit-identical either way; see
    ``_pack_segments_scan`` for the arguments."""
    if use_pallas:
        from .pack_kernel import pack_segments as kernel
        return kernel(zz, comp, seg_g=seg_g, n_words=n_words)
    return _pack_segments_scan(zz, comp, seg_g, n_words)


def _pack_block_bits(lens: jnp.ndarray, vals: jnp.ndarray):
    """Pack per-slot bits into per-block word buffers.

    lens/vals: (B, S). Returns (buf (B, 64) uint32 MSB-first, nbits (B,)).
    lax.scan over slots; every block advances in lockstep.
    """
    b, s = lens.shape
    word_iota = jnp.arange(_BLOCK_WORDS, dtype=jnp.int32)[None, :]

    def step(carry, xs):
        buf, off = carry
        slen, sval = xs  # (B,)
        total = (off & 31) + slen
        sval = sval.astype(jnp.uint32)
        # first word contribution: bits [off, min(off+len, word end))
        sh1 = jnp.clip(32 - total, 0, 31).astype(jnp.uint32)
        sh1b = jnp.clip(total - 32, 0, 31).astype(jnp.uint32)
        w0 = jnp.where(total <= 32, sval << sh1, sval >> sh1b)
        # second word contribution when the slot spans the boundary
        sh2 = jnp.clip(64 - total, 1, 32).astype(jnp.uint32)
        w1 = jnp.where(total > 32, sval << (sh2 & 31), 0).astype(jnp.uint32)
        widx = (off >> 5)[:, None]
        active = (slen > 0)[:, None]
        buf = buf | jnp.where(active & (word_iota == widx), w0[:, None], 0)
        buf = buf | jnp.where(active & (word_iota == widx + 1), w1[:, None], 0)
        return (buf, off + slen), None

    buf0 = jnp.zeros((b, _BLOCK_WORDS), jnp.uint32)
    off0 = jnp.zeros((b,), jnp.int32)
    (buf, nbits), _ = jax.lax.scan(
        step, (buf0, off0), (lens.T, vals.T))
    return buf, nbits


def _concat_blocks(buf: jnp.ndarray, nbits: jnp.ndarray, out_words: int,
                   max_span: int = _MAX_SPAN):
    """Concatenate per-block bitstrings into one stream.

    buf: (B, 64) uint32 MSB-first, nbits: (B,). Returns (out (out_words,)
    uint32, total_bits). Pure gathers: for each output word, OR the shifted
    contributions of the ≤max_span blocks overlapping it (max_span derived
    from the Huffman-table minima by the layout; every block carries at
    least DC+EOB bits, so nbits is provably positive and never gathered in
    the overlap loop).
    """
    b = buf.shape[0]
    offsets = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(nbits)]).astype(jnp.int32)  # (B+1,)
    total_bits = offsets[-1]

    w = jnp.arange(out_words, dtype=jnp.int32)
    wbit = w << 5
    first = jnp.searchsorted(offsets, wbit, side="right").astype(jnp.int32) - 1
    first = jnp.clip(first, 0, b - 1)

    buf_word0 = buf[:, 0]

    # contributor j=0: the block CONTAINING the word start — needs two
    # arbitrary block words, fetched as flat 1-D gathers (same gather
    # species as the j>=1 path; 32x less data than a 64-wide row gather)
    flat = buf.reshape(-1)
    blk = first
    o = offsets[blk]
    nb = nbits[blk]
    valid = (o <= wbit) & (o + nb > wbit)
    pos = wbit - o                 # >= 0 for the containing block
    p = (pos & 31).astype(jnp.uint32)
    k0 = jnp.clip(pos >> 5, 0, _BLOCK_WORDS - 1)
    base = blk * _BLOCK_WORDS + k0
    b0 = flat[base]
    b1 = flat[jnp.minimum(base + 1, b * _BLOCK_WORDS - 1)]
    inside = (b0 << p) | jnp.where(p > 0, b1 >> ((32 - p) & 31), 0)
    out = jnp.where(valid, inside, 0)

    # contributors j>=1 START inside the word, so only their first buffer
    # word matters — two 1-D gathers each (start offset + first word)
    for j in range(1, max_span):
        blk = jnp.clip(first + j, 0, b - 1)
        o = offsets[blk]
        valid = (o > wbit) & (o < wbit + 32) & (first + j < b)
        lead = jnp.clip(o - wbit, 0, 31).astype(jnp.uint32)
        out = out | jnp.where(valid, buf_word0[blk] >> lead, 0)
    return out, total_bits


def _coarse_first(offsets: jnp.ndarray, n_queries: int, stride_log2: int,
                  refine_levels: int) -> jnp.ndarray:
    """first[w] = index of the last block whose start bit is <= w*32, for
    w in [0, n_queries) — a bucketed binary search.

    A flat searchsorted costs log2(B) ~ 16 gather levels per word; instead
    searchsorted runs only on the 1/2**stride_log2 coarse bucket
    boundaries, and each word refines within its bucket in
    ``refine_levels`` levels (bounded by the provable max blocks per
    bucket from the Huffman minima). Returns int32 (n_queries,), clipped
    to [0, B-2] block indices (offsets has B+1 entries)."""
    nblocks = offsets.shape[0] - 1
    stride = 1 << stride_log2
    n_coarse = (n_queries + stride - 1) >> stride_log2
    cq = (jnp.arange(n_coarse + 1, dtype=jnp.int32) << (stride_log2 + 5))
    cfirst = jnp.searchsorted(offsets, cq, side="right").astype(jnp.int32) - 1
    cfirst = jnp.clip(cfirst, 0, nblocks - 1)

    w = jnp.arange(n_queries, dtype=jnp.int32)
    wbit = w << 5
    lo = jnp.repeat(cfirst[:-1], stride)[:n_queries]
    hi = jnp.repeat(cfirst[1:], stride)[:n_queries]
    # invariant: offsets[lo] <= wbit and first[w] in [lo, hi]
    for _ in range(refine_levels):
        mid = (lo + hi + 1) >> 1
        go = offsets[mid] <= wbit
        lo = jnp.where(go, mid, lo)
        hi = jnp.where(go, hi, mid - 1)
    return lo


def _concat_blocks_v2(buf: jnp.ndarray, nbits: jnp.ndarray, out_words: int,
                      min_block_bits: int = 4):
    """Prefix-sum formulation of _concat_blocks (bit-identical output).

    Two structural wins over the max_span gather loop:
      1. All blocks STARTING inside a word occupy disjoint bit ranges of
         that word, so OR == ADD — and they are consecutive blocks, so
         their combined contribution is a difference of two entries of a
         modular inclusive cumsum over per-block first-word contributions
         (2 gathers replacing 2*(max_span-1) ~ 16).
      2. The per-word binary search runs bucketed (_coarse_first): ~8
         gather levels instead of log2(B) ~ 16.
    """
    b = buf.shape[0]
    offsets = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(nbits)]).astype(jnp.int32)
    total_bits = offsets[-1]

    # bucket size bound: stride*32 bits / provable min block bits
    import os
    stride_log2 = int(os.environ.get("FLUTPU_CONCAT_STRIDE_LOG2", "4"))
    max_per_bucket = ((1 << stride_log2) * 32) // max(1, min_block_bits) + 1
    levels = max(1, int(np.ceil(np.log2(max_per_bucket + 1))))
    first_ext = _coarse_first(offsets, out_words + 1, stride_log2, levels)
    first = first_ext[:-1]

    w = jnp.arange(out_words, dtype=jnp.int32)
    wbit = w << 5

    # j=0: the block CONTAINING the word start (arbitrary staging words,
    # flat 1-D gathers). Blocks tile the bit range contiguously and every
    # block has > 0 bits, so the containing block is valid for exactly the
    # words before the stream end — no nbits gather needed.
    flat = buf.reshape(-1)
    fo_ext = offsets[first_ext]            # start bit of first[*] blocks
    o = fo_ext[:-1]
    valid = wbit < total_bits
    pos = wbit - o
    p = (pos & 31).astype(jnp.uint32)
    k0 = jnp.clip(pos >> 5, 0, _BLOCK_WORDS - 1)
    base = first * _BLOCK_WORDS + k0
    b0 = flat[base]
    b1 = flat[jnp.minimum(base + 1, b * _BLOCK_WORDS - 1)]
    inside = (b0 << p) | jnp.where(p > 0, b1 >> ((32 - p) & 31), 0)
    out = jnp.where(valid, inside, 0)

    # blocks starting strictly inside word w: consecutive range
    # (first[w], L[w]] where L excludes a block starting exactly at the
    # next word boundary (at most one, since every block has > 0 bits)
    bsc = buf[:, 0] >> (offsets[:-1] & 31).astype(jnp.uint32)
    csum = jnp.cumsum(bsc.astype(jnp.uint32))   # modular inclusive scan
    first_next = first_ext[1:]
    L = first_next - (fo_ext[1:] == wbit + 32).astype(jnp.int32)
    extra = csum[L] - csum[first]               # 0 when L == first
    return out + jnp.where(L > first, extra, 0), total_bits


def _concat_blocks_v3(buf: jnp.ndarray, nbits: jnp.ndarray, out_words: int):
    """Scatter formulation of the block concat (bit-identical to v2).

    v2's cost is dominated by per-word binary-search refinement plus five
    per-word gathers. v3 inverts the mapping: each BLOCK knows its start
    word statically (offsets >> 5), so
      - first[w] (containing block) = cummax of a scatter-max of block
        indices into their start words,
      - fo[w] (its start bit)      = cummax of a scatter-max of offsets
        (monotone in block index, so the cummax propagates correctly),
      - extra[w] (OR of blocks starting strictly inside w) = scatter-ADD
        of per-block first-word contributions (disjoint bits → OR == ADD),
        excluding word-aligned starts (those are containing blocks).
    Two 32K gathers (the containing block's staging words) remain.
    FLUTPU_CONCAT selects the formulation (v3 by default)."""
    b = buf.shape[0]
    offsets = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(nbits)]).astype(jnp.int32)
    total_bits = offsets[-1]
    starts = offsets[:-1]                       # (B,)
    wob = starts >> 5                           # start word per block
    bidx = jnp.arange(b, dtype=jnp.int32)

    # containing block of word w = LAST block with starts <= w*32, i.e.
    # with ceil(starts/32) <= w — so blocks scatter into their CEIL word
    # (a word-aligned start lands in its own word, an interior start in
    # the next) and a cummax propagates forward. (Scattering into the
    # floor word is wrong: an interior block of word w would shadow an
    # aligned block of word w despite starting AFTER wbit.)
    # OOB starts — blocks past the prefix window — drop.
    wce = (starts + 31) >> 5
    first = jax.lax.cummax(
        jnp.full((out_words,), -1, jnp.int32)
        .at[wce].max(bidx, mode="drop"))
    first = jnp.clip(first, 0, b - 1)
    fo = jax.lax.cummax(
        jnp.zeros((out_words,), jnp.int32)
        .at[wce].max(starts, mode="drop"))

    # blocks starting strictly inside a word: disjoint-bit ADD
    bsc = buf[:, 0] >> (starts & 31).astype(jnp.uint32)
    extra = jnp.zeros((out_words,), jnp.uint32).at[wob].add(
        jnp.where((starts & 31) != 0, bsc, 0), mode="drop")

    w = jnp.arange(out_words, dtype=jnp.int32)
    wbit = w << 5
    valid = wbit < total_bits
    pos = wbit - fo
    p = (pos & 31).astype(jnp.uint32)
    k0 = jnp.clip(pos >> 5, 0, _BLOCK_WORDS - 1)
    flat = buf.reshape(-1)
    base = first * _BLOCK_WORDS + k0
    b0 = flat[base]
    b1 = flat[jnp.minimum(base + 1, b * _BLOCK_WORDS - 1)]
    inside = (b0 << p) | jnp.where(p > 0, b1 >> ((32 - p) & 31), 0)
    return jnp.where(valid, inside, 0) + extra, total_bits


def _concat_blocks_v4(buf: jnp.ndarray, nbits: jnp.ndarray, out_words: int):
    """v3 with the per-BLOCK scatter traffic cut to one map.

    v3 deposits three B-sized scatters (first, fo, extra). Here only the
    containing-block map stays a scatter; its start bit is a per-WORD
    gather from offsets, and the strictly-inside contributions come from
    v2's modular-cumsum range difference (cumsum = log-depth rolls, two
    per-word gathers). ~B scattered + ~5*out_words gathered elements vs
    v3's ~3B scattered. Bit-identical to v1/v2/v3."""
    b = buf.shape[0]
    offsets = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(nbits)]).astype(jnp.int32)
    total_bits = offsets[-1]
    starts = offsets[:-1]
    bidx = jnp.arange(b, dtype=jnp.int32)

    # containing block per word (ceil-word scatter-max + cummax — see v3)
    wce = (starts + 31) >> 5
    first = jax.lax.cummax(
        jnp.full((out_words + 1,), -1, jnp.int32)
        .at[wce].max(bidx, mode="drop"))
    first = jnp.clip(first, 0, b - 1)
    fo_ext = offsets[first]                     # (out_words+1,) gather
    first, first_next = first[:-1], first[1:]

    w = jnp.arange(out_words, dtype=jnp.int32)
    wbit = w << 5
    valid = wbit < total_bits
    pos = wbit - fo_ext[:-1]
    p = (pos & 31).astype(jnp.uint32)
    k0 = jnp.clip(pos >> 5, 0, _BLOCK_WORDS - 1)
    flat = buf.reshape(-1)
    base = first * _BLOCK_WORDS + k0
    b0 = flat[base]
    b1 = flat[jnp.minimum(base + 1, b * _BLOCK_WORDS - 1)]
    inside = (b0 << p) | jnp.where(p > 0, b1 >> ((32 - p) & 31), 0)
    out = jnp.where(valid, inside, 0)

    # strictly-inside blocks (first, L]: modular cumsum range difference
    bsc = buf[:, 0] >> (starts & 31).astype(jnp.uint32)
    csum = jnp.cumsum(bsc.astype(jnp.uint32))
    L = first_next - (fo_ext[1:] == wbit + 32).astype(jnp.int32)
    extra = csum[L] - csum[first]               # 0 when L == first
    return out + jnp.where(L > first, extra, 0), total_bits


def _concat_blocks_v5(buf: jnp.ndarray, nbits: jnp.ndarray, out_words: int):
    """v3 with only the fo scatter replaced by a per-word gather
    (offsets[first]); the extra scatter-add stays. Bit-identical."""
    b = buf.shape[0]
    offsets = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(nbits)]).astype(jnp.int32)
    total_bits = offsets[-1]
    starts = offsets[:-1]
    bidx = jnp.arange(b, dtype=jnp.int32)

    wce = (starts + 31) >> 5
    first = jax.lax.cummax(
        jnp.full((out_words,), -1, jnp.int32)
        .at[wce].max(bidx, mode="drop"))
    first = jnp.clip(first, 0, b - 1)
    fo = offsets[first]

    bsc = buf[:, 0] >> (starts & 31).astype(jnp.uint32)
    wob = starts >> 5
    extra = jnp.zeros((out_words,), jnp.uint32).at[wob].add(
        jnp.where((starts & 31) != 0, bsc, 0), mode="drop")

    w = jnp.arange(out_words, dtype=jnp.int32)
    wbit = w << 5
    valid = wbit < total_bits
    pos = wbit - fo
    p = (pos & 31).astype(jnp.uint32)
    k0 = jnp.clip(pos >> 5, 0, _BLOCK_WORDS - 1)
    flat = buf.reshape(-1)
    base = first * _BLOCK_WORDS + k0
    b0 = flat[base]
    b1 = flat[jnp.minimum(base + 1, b * _BLOCK_WORDS - 1)]
    inside = (b0 << p) | jnp.where(p > 0, b1 >> ((32 - p) & 31), 0)
    return jnp.where(valid, inside, 0) + extra, total_bits


def _mcu_blocks(yq, cbq, crq, layout: McuLayout):
    """Shared front half of the scan encoders: MCU reorder (structural
    reshape/transpose where the interleave allows) + DC prediction.
    Returns (mcu (F, B, 64) int32 DC-diffed blocks, comp (B,) int32)."""
    f = yq.shape[0]
    prev_np = np.asarray(layout.prev_same_comp)
    comp = jnp.asarray(layout.comp_is_chroma)

    # MCU reordering: the standard interleave patterns are pure
    # reshape/transpose/concat — no gather at all (4:2:0: [my, sy, mx, sx]
    # → [my, mx, sy, sx] luma transpose, then [4Y|Cb|Cr] concat per MCU;
    # 4:4:4: a plain [Y|Cb|Cr] interleave). The arbitrary-layout gather
    # remains as the fallback.
    ybw, ybh, cbw, cbh, subsample = layout._key
    y32 = yq.reshape(f, ybh, ybw, 64).astype(jnp.int32)
    cb32 = cbq.reshape(f, cbh, cbw, 64).astype(jnp.int32)
    cr32 = crq.reshape(f, cbh, cbw, 64).astype(jnp.int32)
    if subsample and ybh % 2 == 0 and ybw % 2 == 0:
        ym = y32.reshape(f, ybh // 2, 2, ybw // 2, 2, 64) \
            .transpose(0, 1, 3, 2, 4, 5).reshape(f, -1, 4, 64)
        m = ym.shape[1]
        mcu = jnp.concatenate(
            [ym, cb32.reshape(f, m, 1, 64), cr32.reshape(f, m, 1, 64)],
            axis=2).reshape(f, -1, 64)
    elif not subsample:
        mcu = jnp.concatenate(
            [y32.reshape(f, -1, 1, 64), cb32.reshape(f, -1, 1, 64),
             cr32.reshape(f, -1, 1, 64)], axis=2).reshape(f, -1, 64)
    else:
        allb = jnp.concatenate([y32.reshape(f, -1, 64),
                                cb32.reshape(f, -1, 64),
                                cr32.reshape(f, -1, 64)], axis=1)
        mcu = allb[:, jnp.asarray(layout.block_sel)]

    # DC prediction: prev-same-component deltas in MCU order take only a
    # few distinct values (e.g. {1, 3, 6} for 4:2:0), so the per-block
    # gather becomes a few masked static shifts
    deltas_np = np.arange(len(prev_np)) - prev_np
    uniq = np.unique(deltas_np[prev_np >= 0])

    def dc_diff(blocks):
        dc = blocks[:, 0]
        if 0 < len(uniq) <= 4:
            prev_dc = jnp.zeros_like(dc)
            for d in uniq:
                mask = jnp.asarray((deltas_np == d) & (prev_np >= 0))
                prev_dc = jnp.where(mask, jnp.roll(dc, int(d)), prev_dc)
        else:
            prev = jnp.asarray(prev_np)
            prev_dc = jnp.where(prev >= 0, dc[jnp.clip(prev, 0)], 0)
        # concatenate instead of .at[:,0].set — the scatter form triggers an
        # XLA:CPU fusion miscompile under vmap (observed jax 0.9: wrong DC
        # diffs downstream); concat is also cheaper to fuse
        return jnp.concatenate([(dc - prev_dc)[:, None], blocks[:, 1:]],
                               axis=1)

    return jax.vmap(dc_diff)(mcu), comp         # (F, B, 64), (B,)


def _concat_segments_aligned(segbuf: jnp.ndarray, segbits: jnp.ndarray,
                             out_words: int):
    """Word-ALIGNED segment placement (the round-4 concat replacement).

    segbuf (S, C) uint32 per-segment packed bits, segbits (S,) int32.
    Each segment lands at the next 32-bit word boundary — no bit shifts,
    no per-word OR of neighbors, no binary search: the containing segment
    per output word is one scatter + cummax (every segment starts at its
    own word exactly), and the word value is ONE flat gather. Dynamic-
    indexed elements per frame: ~S scatter + 2*out_words gather/cummax —
    ~6x fewer than _concat_blocks_v3's block-granular machinery. The
    word-alignment padding (avg 16 bits per ~16-block segment, ~6% of the
    stream) is removed HOST-side by compact_aligned_segments inside the
    already-overlapped threaded finalize, reproducing the byte-identical
    JPEG stream."""
    s_count, c = segbuf.shape
    wcnt = (segbits + 31) >> 5                      # (S,) words used
    ends = jnp.cumsum(wcnt).astype(jnp.int32)
    fo = jnp.concatenate([jnp.zeros(1, jnp.int32), ends[:-1]])
    total_words = ends[-1]
    sidx = jnp.arange(s_count, dtype=jnp.int32)
    # padding segments (segbits == 0) share fo with their successor —
    # drop them from the scatters (OOB target)
    tgt = jnp.where(wcnt > 0, fo, out_words)
    first = jax.lax.cummax(
        jnp.full((out_words,), -1, jnp.int32).at[tgt].max(sidx,
                                                          mode="drop"))
    first = jnp.clip(first, 0, s_count - 1)
    fw = jax.lax.cummax(
        jnp.zeros((out_words,), jnp.int32).at[tgt].max(fo, mode="drop"))
    w = jnp.arange(out_words, dtype=jnp.int32)
    k = w - fw
    flat = segbuf.reshape(-1)
    out = flat[first * c + jnp.clip(k, 0, c - 1)]
    valid = (w < total_words) & (k < c)
    return jnp.where(valid, out, 0), total_words


@functools.partial(jax.jit,
                   static_argnames=("layout", "prefix_words", "seg_g",
                                    "seg_words", "use_pallas"))
def encode_gop_scans_segmented(yq, cbq, crq, layout: McuLayout,
                               prefix_words: int, seg_g: int = 16,
                               seg_words: int = 64,
                               use_pallas: bool = False):
    """Segment-layout scan encode: the packer packs ``seg_g``
    consecutive blocks per lane into contiguous bit segments, the device
    word-aligns whole segments (no block-granular concat), and the host
    bit-compacts. Returns combined (F, 1 + S + prefix_words) uint32 per
    frame: [0] = aligned words used (prefix-overflow check), [1..S] =
    per-segment bit counts (capacity check + host compaction), [S+1..] =
    the word-aligned stream. Decode side: byte-identical to the block
    concat after compact_aligned_segments + stuff_and_finalize.
    ``use_pallas`` selects the Pallas packer over the plain scan.
    """
    f = yq.shape[0]
    mcu, comp = _mcu_blocks(yq, cbq, crq, layout)
    b = mcu.shape[1]
    b_pad = ((b + seg_g - 1) // seg_g) * seg_g
    if b_pad != b:   # pad per frame so segments never span frames
        mcu = jnp.concatenate(
            [mcu, jnp.zeros((f, b_pad - b, 64), jnp.int32)], axis=1)
        comp_f = jnp.concatenate(
            [comp, jnp.full((b_pad - b,), -1, jnp.int32)])
    else:
        comp_f = comp
    s_per_frame = b_pad // seg_g
    segbuf, segbits = pack_segments(
        mcu.reshape(f * b_pad, 64), jnp.tile(comp_f, f), seg_g=seg_g,
        n_words=seg_words, use_pallas=use_pallas)
    segbuf = segbuf.reshape(f, s_per_frame, seg_words)
    segbits = segbits.reshape(f, s_per_frame)
    out, total_words = jax.vmap(
        lambda sb, sn: _concat_segments_aligned(sb, sn, prefix_words))(
        segbuf, segbits)
    return jnp.concatenate(
        [total_words.astype(jnp.uint32)[:, None],
         segbits.astype(jnp.uint32), out], axis=1)


def compact_aligned_segments(seg_bits: np.ndarray, words: np.ndarray):
    """Host half of the segment layout: merge word-aligned segments into
    the exact contiguous bitstream (vectorized numpy; runs on the
    threaded-finalize pool). seg_bits (S,) per-segment bit counts
    (zeros = padding segments), words (>= sum ceil(bits/32),) uint32.
    Returns (stream_words uint32, total_bits)."""
    seg_bits = np.asarray(seg_bits, np.int64)
    seg_bits = seg_bits[seg_bits > 0]
    if seg_bits.size == 0:
        return np.zeros(0, np.uint32), 0
    wcnt = (seg_bits + 31) >> 5
    src_end = np.cumsum(wcnt)
    total_bits = int(seg_bits.sum())
    bo = np.cumsum(seg_bits) - seg_bits            # dest bit offset/seg
    j = int(src_end[-1])
    seg_of = np.repeat(np.arange(len(seg_bits)), wcnt)
    k = np.arange(j, dtype=np.int64) - np.repeat(src_end - wcnt, wcnt)
    w = np.asarray(words[:j], np.uint32)
    p = (bo[seg_of] & 31).astype(np.uint32)
    d = ((bo[seg_of] >> 5) + k).astype(np.int64)
    hi = w >> p
    lo = np.where(p > 0, w << ((32 - p) & np.uint32(31)), 0) \
        .astype(np.uint32)
    # consecutive segments own disjoint bit ranges → OR == ADD, and a
    # float64 bincount is ~4x faster than bitwise_or.at: disjoint-bit
    # uint32 sums stay < 2^32 < 2^53, so the accumulation is exact
    n_out = int((total_bits + 31) // 32) + 1
    out = (np.bincount(d, weights=hi.astype(np.float64), minlength=n_out)
           + np.bincount(d + 1, weights=lo.astype(np.float64),
                         minlength=n_out))
    out = out.astype(np.uint64).astype(np.uint32)
    return out[:(total_bits + 31) // 32], total_bits


def _resolve_concat(concat):
    """Resolve the concat-formulation override BEFORE the jit boundary.
    Reading os.environ inside a traced body bakes the first trace's value
    into the (concat=None) cache entry — an in-process env sweep would
    silently measure the same program in both arms."""
    import os
    if concat is None:
        concat = os.environ.get("FLUTPU_CONCAT", "v3")
    return concat


def encode_gop_scans(yq: jnp.ndarray, cbq: jnp.ndarray, crq: jnp.ndarray,
                     layout: McuLayout, out_words: int,
                     use_pallas: bool = False,
                     concat: Optional[str] = None):
    """Env-resolving entry for :func:`_encode_gop_scans` (see its doc)."""
    return _encode_gop_scans(yq, cbq, crq, layout=layout,
                             out_words=out_words, use_pallas=use_pallas,
                             concat=_resolve_concat(concat))


@functools.partial(jax.jit,
                   static_argnames=("layout", "out_words", "use_pallas",
                                    "concat"))
def _encode_gop_scans(yq: jnp.ndarray, cbq: jnp.ndarray, crq: jnp.ndarray,
                      layout: McuLayout, out_words: int,
                      use_pallas: bool = False, concat: str = "v3"):
    """(F, BH, BW, 64) int16 coefficient planes → packed scan bits.

    Returns (packed (F, out_words) uint32, bits (F,) int32). With
    ``use_pallas`` the intra-block packing runs as the Pallas kernel
    (pack_kernel.py: coefficients read once, finished words written once)
    instead of the lax.scan formulation — same bits.
    """
    f = yq.shape[0]
    mcu, comp = _mcu_blocks(yq, cbq, crq, layout)
    b = mcu.shape[1]
    buf, nbits = pack_segments(mcu.reshape(f * b, 64), jnp.tile(comp, f),
                               seg_g=1, n_words=_BLOCK_WORDS,
                               use_pallas=use_pallas)
    buf = buf.reshape(f, b, _BLOCK_WORDS)
    nbits = nbits.reshape(f, b)
    luma_min, chroma_min = _min_block_bits()
    mbb = min(luma_min, chroma_min)
    if concat == "v3":
        return jax.vmap(
            lambda bb, nn: _concat_blocks_v3(bb, nn, out_words))(buf, nbits)
    if concat == "v4":
        return jax.vmap(
            lambda bb, nn: _concat_blocks_v4(bb, nn, out_words))(buf, nbits)
    if concat == "v5":
        return jax.vmap(
            lambda bb, nn: _concat_blocks_v5(bb, nn, out_words))(buf, nbits)
    return jax.vmap(
        lambda bb, nn: _concat_blocks_v2(bb, nn, out_words,
                                         min_block_bits=mbb))(
        buf, nbits)


def encode_gop_scans_combined(yq, cbq, crq, layout: McuLayout,
                              prefix_words: int, use_pallas: bool = False,
                              concat: Optional[str] = None):
    """Env-resolving entry for :func:`_encode_gop_scans_combined`."""
    return _encode_gop_scans_combined(
        yq, cbq, crq, layout=layout, prefix_words=prefix_words,
        use_pallas=use_pallas, concat=_resolve_concat(concat))


@functools.partial(jax.jit,
                   static_argnames=("layout", "prefix_words", "use_pallas",
                                    "concat"))
def _encode_gop_scans_combined(yq, cbq, crq, layout: McuLayout,
                               prefix_words: int, use_pallas: bool = False,
                               concat: str = "v3"):
    """Single-fetch variant: returns combined (F, 1+prefix_words) uint32
    where combined[f, 0] is the frame's bit count and combined[f, 1:] the
    packed scan words. The concat stage only materializes the prefix
    window (typical scans use <10% of the worst-case cap — gathering the
    full cap costs 12x more); a frame whose bit count exceeds the prefix
    falls back to the caller's cap-ladder path."""
    packed, bits = _encode_gop_scans(yq, cbq, crq, layout=layout,
                                     out_words=prefix_words,
                                     use_pallas=use_pallas, concat=concat)
    return jnp.concatenate(
        [bits.astype(jnp.uint32)[:, None], packed], axis=1)


def compact_segments_finalize(seg_bits: np.ndarray,
                              words: np.ndarray) -> bytes:
    """compact_aligned_segments + stuff_and_finalize in ONE native pass
    (C++ BitWriter, GIL-free — the numpy pair measured 0.96 ms/frame on
    the threaded finalize pool and was the largest un-overlapped host
    cost of the segment layout). Byte-identical to the numpy pair, which
    remains as the fallback when the toolchain is absent."""
    from ...native import get_lib
    lib = get_lib()
    if lib is not None and hasattr(lib, "flu_compact_segments_finalize"):
        import ctypes
        sb = np.ascontiguousarray(seg_bits, dtype=np.uint32)
        w = np.ascontiguousarray(words, dtype=np.uint32)
        total_bits = int(sb.astype(np.int64).sum())
        cap = 2 * ((total_bits + 7) // 8) + 2
        out = np.empty(cap, np.uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        n = lib.flu_compact_segments_finalize(
            sb.ctypes.data_as(u32p), len(sb), w.ctypes.data_as(u32p),
            len(w), 1, out.ctypes.data_as(u8p), cap)
        if n >= 0:
            return out[:n].tobytes()
    stream, total = compact_aligned_segments(seg_bits, words)
    return stuff_and_finalize(stream, total)


def stuff_and_finalize(words: np.ndarray, total_bits: int) -> bytes:
    """Host finalization: trim, pad final byte with 1-bits, 0xFF byte
    stuffing. Vectorized numpy; input ~100 KB."""
    nbytes = (int(total_bits) + 7) // 8
    raw = np.ascontiguousarray(words).astype(">u4").tobytes()[:nbytes]
    arr = np.frombuffer(raw, dtype=np.uint8).copy()
    rem = int(total_bits) & 7
    if rem:
        arr[-1] |= (1 << (8 - rem)) - 1
    # byte stuffing: insert 0x00 after every 0xFF
    ff = arr == 0xFF
    if ff.any():
        out = np.zeros(len(arr) + int(ff.sum()), dtype=np.uint8)
        pos = np.arange(len(arr)) + np.cumsum(ff) - ff
        out[pos] = arr
        # the inserted zeros are already 0
        return out.tobytes()
    return arr.tobytes()
