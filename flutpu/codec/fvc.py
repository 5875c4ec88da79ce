"""FVC — the framework's GOP video codec (I + P frames, DCT domain).

Where MJPEG (flutpu.codec.jpeg) is intra-only, FVC adds temporal
prediction: P frames carry the difference of *quantized* DCT coefficients
against the previous reconstructed frame, accumulated losslessly on both
sides (no drift: encoder and decoder integrate the same clamped residuals).
This is what makes hype's GOP chunking semantically real — a P frame
depends on its predecessors, so chunks are only independently decodable
because the scatter forces an I frame at every chunk start
(reference hype/src/outputselector/imp.rs:39-43), and stitching is
bit-exact by construction.

Device design: the temporal accumulation is a lax.scan over the GOP on device
(carry = reconstructed coefficient planes); residual planes then reuse the
whole JPEG entropy pipeline (MCU ordering, DC prediction, zigzag RLE,
device bit packing). Residuals clamp to ±1023 so every value
stays within the standard Huffman tables' magnitude categories; an I frame
is simply a residual against the zero state.

Bitstream (container): per-GOP chunk header
    'FVC1' | u8 version | u8 flags(bit0=subsample) | u16 width |
    u16 height | u8 quality | u8 n_frames
version 1: per frame  u8 frame_type (0=I 1=P) | u32 payload_len | payload
(payload = byte-stuffed entropy scan of the residual planes).
version 2 (motion mode): one extra header byte u8 search_range, then per
frame  u8 frame_type | u16 mv_len | u32 payload_len | mv_len motion vector
bytes (P frames; (H/16)x(W/16)x2 int8 dy,dx on the luma macroblock grid,
zlib-compressed when header flags bit1 is set — raw vectors cost
2 B/macroblock and compress ~100x on smooth fields; in HALF-PIXEL units
when flags bit2 is set; flags bit3 = the in-loop reconstruction used the
planar DCT formulation — decoders must reconstruct through the same
formulation or P-chain state drifts; flags bit4 = an explicit coded-size
extension (u16 coded_width | u16 coded_height, after the v2 search_range
byte) when the coded geometry exceeds the minimum macroblock padding —
spatially striped encodes pad H to 16*stripes) | payload. v2 P frames code the pixel-domain residual against the
motion-compensated previous reconstruction (hybrid loop with in-loop
recon — see fvc_mc_encode_chunk). Frame types are decided per frame in
the encode scan (intra wins when flat prediction beats motion — the
in-codec scene-cut detector); any frame may be I, not just chunk starts.

flags bit5 = the chunk may contain B frames (frame_type 2): bidirectional
NON-REFERENCE frames predicted per 16x16 macroblock from the surrounding
reconstructed anchor frames (the nearest earlier and later I/P frame in
the chunk). A B frame's motion block decompresses to
mbh*mbw*2 forward int8 vectors | mbh*mbw*2 backward int8 vectors |
mbh*mbw uint8 modes (0=bidirectional average, 1=forward, 2=backward,
3=flat-128 intra). Frames stay in DISPLAY order in the container — the
whole chunk decodes at once (anchor scan, then every B frame in one
parallel pass), so no reorder machinery exists on either side. B frames
never enter the in-loop reconstruction chain (see fvc_mc_encode_chunk_b).
B frames do not combine with subpel (flags bit2 with bit5 is invalid).
"""

from __future__ import annotations

import functools
import struct
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import platform
from ..core import Buffer, BufferFlags, Caps, PropertySpec, register
from .base import VideoEncoder
from .decode import coefs_to_rgb, decode_scan_to_coefs
from .jpeg import _pad_to, encode_gop_to_coefs, segmented_property
from .ops.quant import CHROMA_QTABLE, LUMA_QTABLE, scale_qtable

MAGIC = b"FVC1"
VERSION = 1
_CLAMP = 1023  # keeps every residual within standard-table magnitude range


@jax.jit
def fvc_residuals(yq, cbq, crq):
    """Quantized coefficient planes (F, BH, BW, 64) → clamped residual
    planes (int16) via a device scan. The zero initial state makes frame 0
    the I frame; each subsequent frame codes against the reconstruction."""

    def step(carry, xs):
        outs = []
        new_carry = []
        for coef, rec in zip(xs, carry):
            resid = jnp.clip(coef.astype(jnp.int32) - rec, -_CLAMP, _CLAMP)
            new_carry.append(rec + resid)
            outs.append(resid.astype(jnp.int16))
        return tuple(new_carry), tuple(outs)

    # derive the zero init from the data (not jnp.zeros) so the carry
    # carries the same varying-manual-axes as the inputs under shard_map
    init = tuple(a[0].astype(jnp.int32) * 0 for a in (yq, cbq, crq))
    _, (ry, rcb, rcr) = jax.lax.scan(step, init, (yq, cbq, crq))
    return ry, rcb, rcr


@functools.partial(jax.jit, static_argnames=("pad_h", "pad_w",
                                             "search_range", "hier",
                                             "subpel", "planar",
                                             "spatial_axis", "n_spatial"))
def fvc_mc_encode_chunk(frames: jax.Array, qy: jax.Array, qc: jax.Array,
                        pad_h: int, pad_w: int, search_range: int = 7,
                        hier: bool = False, subpel: bool = False,
                        planar: Optional[bool] = None,
                        spatial_axis: Optional[str] = None,
                        n_spatial: int = 1):
    """Motion-compensated chunk encode (FVC v2): classic hybrid loop as a
    device scan — per frame: full-search motion estimation against the
    reconstructed reference (flutpu.codec.ops.motion), motion-compensated
    prediction, DCT+quantization of the pixel residual, and in-loop
    reconstruction so encoder and decoder track identical state.

    Returns (ry, rcb, rcr) int16 zigzagged residual coefficients and
    mvs (F, mbh, mbw, 2) int8 (frame 0's vectors are zero/ignored: I frame
    predicts a flat 128)."""
    from .ops.colorspace import planes_to_i420, rgb_to_i420
    from .ops.dct import blockize, plane_dct_planar, plane_idct_planar
    from .ops.quant import (dequantize_planar, quantize_planar,
                            zigzag_flatten)
    from .ops.motion import (motion_compensate, motion_compensate_subpel,
                             motion_search, motion_search_hier,
                             subpel_refine)

    if isinstance(frames, (tuple, list)):
        # channel-planar input (r, g, b): the interleaved (F, H, W, 3)
        # layout never exists (see jpeg.encode_gop_planes_to_coefs);
        # bit-identical.
        rp, gp, bp = frames
        f, h, w = rp.shape

        def padp(p):
            p = p.astype(jnp.float32)
            if pad_h != h or pad_w != w:
                p = jnp.pad(p, ((0, 0), (0, pad_h - h), (0, pad_w - w)),
                            mode="edge")
            return p

        y, cb, cr = planes_to_i420(padp(rp), padp(gp), padp(bp))
    else:
        f, h, w, _ = frames.shape
        x = frames.astype(jnp.float32)
        if pad_h != h or pad_w != w:
            x = jnp.pad(x, ((0, 0), (0, pad_h - h), (0, pad_w - w), (0, 0)),
                        mode="edge")
        y, cb, cr = rgb_to_i420(x)

    # the DCT/IDCT formulation is part of the CODEC STATE, not a local
    # optimization: P frames chain off reconstructed pixels, so a decoder
    # that reconstructs through the other formulation drifts one f32
    # rounding at a time through the whole chain (ADVICE r2). The chosen
    # formulation travels in the chunk header (flags bit 3) so any decoder
    # matches it exactly; ``planar=None`` resolves to the platform's form
    # (flutpu.platform.dct_planar).
    use_planar = platform.dct_planar() if planar is None else bool(planar)

    def code_plane(resid, qtab):
        # plane-layout DCT/IDCT (dct.plane_dct_planar) or 8x8 einsums
        if not use_planar:
            from .ops.dct import plane_dct, plane_idct
            from .ops.quant import dequantize, quantize
            coefs = jnp.clip(quantize(plane_dct(resid), qtab),
                             -_CLAMP, _CLAMP)
            rec_resid = plane_idct(dequantize(coefs, qtab))
            return zigzag_flatten(coefs).astype(jnp.int16), rec_resid
        cp = jnp.clip(quantize_planar(plane_dct_planar(resid), qtab),
                      -_CLAMP, _CLAMP)
        rec_resid = plane_idct_planar(dequantize_planar(cp, qtab))
        return (zigzag_flatten(blockize(cp)).astype(jnp.int16), rec_resid)

    # Sequence-parallel mode: ``frames`` is a row STRIPE of the
    # real frame, sharded over the ``spatial_axis`` mesh axis inside a
    # shard_map. Motion search/compensation exchange ±r edge rows with
    # ring neighbors (two ppermutes per plane per frame — the only
    # collectives in the codec) and the per-frame mode decision
    # reduces via psum so every stripe picks the same frame type.
    # Per-pixel results are bit-identical to the unsharded formulation
    # (ring wrap ≡ jnp.roll wrap); only an exact SAD tie in the mode
    # decision could differ (f32 partial-sum order).
    if spatial_axis is not None and (hier or subpel):
        raise ValueError("spatial sharding supports full-search "
                         "integer-pel motion only")

    def step(carry, xs):
        rec_y, rec_cb, rec_cr, idx = carry
        cy, ccb, ccr = xs
        if spatial_axis is not None:
            from .ops.motion import (exchange_row_halos,
                                     motion_compensate_striped,
                                     motion_search_striped)
            rc_halo = (search_range + 1) // 2
            ph_y = exchange_row_halos(rec_y, search_range, spatial_axis,
                                      n_spatial)
            mv = motion_search_striped(cy, ph_y,
                                       search_range=search_range)
            pred_p_y = motion_compensate_striped(
                ph_y, mv, search_range, search_range)
            mc_c = lambda p, m: motion_compensate_striped(
                exchange_row_halos(p, rc_halo, spatial_axis, n_spatial),
                m, rc_halo, search_range, mb=8)
        else:
            search = motion_search_hier if hier else motion_search
            mv = search(cy, rec_y, search_range=search_range)
            if subpel:
                # half-pel refinement: vectors leave in HALF-PIXEL units
                mv = subpel_refine(cy, rec_y, mv)
                mc_y = lambda p, m: motion_compensate_subpel(p, m)
                mc_c = lambda p, m: motion_compensate_subpel(p, m, mb=8)
            else:
                mc_y = lambda p, m: motion_compensate(
                    p, m, search_range=search_range)
                mc_c = lambda p, m: motion_compensate(
                    p, m, search_range=search_range, mb=8)
            pred_p_y = mc_y(rec_y, mv)
        # per-frame mode decision: an I frame here IS "predict flat 128",
        # so whichever prediction leaves less luma residual wins — this is
        # the scene-cut detector inside the codec (a cut makes the motion
        # prediction worse than flat)
        sad_p = jnp.abs(cy - pred_p_y).sum()
        sad_i = jnp.abs(cy - 128.0).sum()
        if spatial_axis is not None:
            # all stripes must make the SAME frame-type decision
            sad_p = jax.lax.psum(sad_p, spatial_axis)
            sad_i = jax.lax.psum(sad_i, spatial_axis)
        is_i = (idx == 0) | (sad_i < sad_p)
        mv = jnp.where(is_i, jnp.zeros_like(mv), mv)
        pred_y = jnp.where(is_i, 128.0, pred_p_y)
        pcb, pcr = mc_c(rec_cb, mv), mc_c(rec_cr, mv)
        pred_cb = jnp.where(is_i, 128.0, pcb)
        pred_cr = jnp.where(is_i, 128.0, pcr)
        oy, ry_rec = code_plane(cy - pred_y, qy)
        ocb, rcb_rec = code_plane(ccb - pred_cb, qc)
        ocr, rcr_rec = code_plane(ccr - pred_cr, qc)
        rec_y = jnp.clip(pred_y + ry_rec, 0.0, 255.0)
        rec_cb = jnp.clip(pred_cb + rcb_rec, 0.0, 255.0)
        rec_cr = jnp.clip(pred_cr + rcr_rec, 0.0, 255.0)
        return (rec_y, rec_cb, rec_cr, idx + 1), (oy, ocb, ocr,
                                                  mv.astype(jnp.int8),
                                                  is_i.astype(jnp.int8))

    # data-derived zero init: keeps shard_map varying-manual-axes consistent
    init = (y[0] * 0.0, cb[0] * 0.0, cr[0] * 0.0, jnp.int32(0))
    _, (ry, rcb, rcr, mvs, itypes) = jax.lax.scan(step, init, (y, cb, cr))
    return ry, rcb, rcr, mvs, itypes


# ---------------------------------------------------------------------------
# B-frames (v2 header flags bit 5) — bidirectional prediction.
#
# GOP structure with ``bframes=b``: anchors (I/P) every b+1 frames plus the
# last frame; the frames between two anchors are B frames predicted from
# BOTH surrounding reconstructed anchors. B frames are NON-REFERENCE (no
# frame chains off them), which is exactly what makes them device-shaped:
# the anchor chain stays a lax.scan, and every B frame then encodes in an
# embarrassingly parallel pass against the already-reconstructed anchor
# pair — no sequential dependency, no in-loop reconstruction, no extra
# HBM-resident carry. Per 16x16 macroblock the encoder picks one of four
# prediction modes (0=bidirectional average, 1=forward, 2=backward,
# 3=flat-128 intra) by residual SAD; the mode plane and both vector
# fields travel in the bitstream, so the decode is pure selection — the
# encoder-side tie-breaking never has to be reproduced. The reference
# delegates encoding to x264 (which owns B-frames there); this is the
# framework-native equivalent for the FVC codec.
# ---------------------------------------------------------------------------

def _bframe_structure(f: int, bframes: int):
    """Static anchor/B index maps for an ``f``-frame chunk.

    Returns (anchor_idx, b_idx, prev_map, next_map): display indices of
    anchors and B frames, and for each B frame the position IN THE ANCHOR
    ARRAY of its previous/next reference."""
    s = bframes + 1
    anchor_idx = list(range(0, f, s))
    if anchor_idx[-1] != f - 1:
        anchor_idx.append(f - 1)
    aset = set(anchor_idx)
    b_idx = [i for i in range(f) if i not in aset]
    prev_map, next_map = [], []
    for j in b_idx:
        k = max(p for p, a in enumerate(anchor_idx) if a < j)
        prev_map.append(k)
        next_map.append(k + 1)
    return anchor_idx, b_idx, prev_map, next_map


@functools.partial(jax.jit, static_argnames=(
    "pad_h", "pad_w", "search_range", "bframes", "hier", "planar",
    "spatial_axis", "n_spatial"))
def fvc_mc_encode_chunk_b(frames, qy, qc, pad_h: int, pad_w: int,
                          search_range: int = 7, bframes: int = 1,
                          hier: bool = False,
                          planar: Optional[bool] = None,
                          qy_b=None, qc_b=None,
                          spatial_axis: Optional[str] = None,
                          n_spatial: int = 1):
    """Bidirectional chunk encode (FVC v2 + flags bit 5).

    Anchor frames (every ``bframes+1``, plus the last frame) run the same
    hybrid scan as fvc_mc_encode_chunk; the in-between B frames encode in
    one parallel pass against their reconstructed anchor pair.

    ``qy_b``/``qc_b``: quant tables for the B residuals (default = the
    anchor tables). B frames are non-reference, so coarser B quantization
    never propagates — the classic rate-allocation lever that makes B
    frames pay (the encoder sets them from ``bquality``, which travels
    in the header).

    Returns, all in DISPLAY order:
      ry/rcb/rcr  (F, BH, BW, 64) int16 zigzag residual coefficients
      fwd         (F, mbh, mbw, 2) int8 forward vectors (anchor P vectors
                  live here; zeroed where a B macroblock doesn't use them)
      bwd         (F, mbh, mbw, 2) int8 backward vectors (B frames only)
      modes       (F, mbh, mbw) int8 per-macroblock B prediction mode
                  (0=bi 1=fwd 2=bwd 3=flat; zero for anchors)
      ftypes      (F,) int8 — 0=P anchor, 1=I anchor, 2=B

    ``spatial_axis``/``n_spatial`` (round 4): sequence-parallel mode —
    ``frames`` is a row STRIPE of the real frame inside a shard_map, and
    both the anchor scan and the parallel B pass exchange ±r halo rows
    with ring ppermutes (ops/motion.py striped formulations;
    bit-identical per pixel to the unsharded codec, like
    fvc_mc_encode_chunk's spatial arm). The anchor frame-type decision
    psum-reduces; the per-macroblock B mode decision is stripe-local
    because stripes are macroblock-aligned.
    """
    from .ops.colorspace import planes_to_i420, rgb_to_i420
    from .ops.dct import blockize, plane_dct_planar, plane_idct_planar
    from .ops.quant import (dequantize_planar, quantize_planar,
                            zigzag_flatten)
    from .ops.motion import (_mb_sums, motion_compensate, motion_search,
                             motion_search_hier)

    if isinstance(frames, (tuple, list)):
        rp, gp, bp = frames
        f, h, w = rp.shape

        def padp(p):
            p = p.astype(jnp.float32)
            if pad_h != h or pad_w != w:
                p = jnp.pad(p, ((0, 0), (0, pad_h - h), (0, pad_w - w)),
                            mode="edge")
            return p

        y, cb, cr = planes_to_i420(padp(rp), padp(gp), padp(bp))
    else:
        f, h, w, _ = frames.shape
        x = frames.astype(jnp.float32)
        if pad_h != h or pad_w != w:
            x = jnp.pad(x, ((0, 0), (0, pad_h - h), (0, pad_w - w), (0, 0)),
                        mode="edge")
        y, cb, cr = rgb_to_i420(x)

    use_planar = platform.dct_planar() if planar is None else bool(planar)
    if qy_b is None:
        qy_b = qy
    if qc_b is None:
        qc_b = qc

    def code_plane(resid, qtab):
        # identical expressions to fvc_mc_encode_chunk.code_plane — the
        # formulation is codec state (header flags bit 3)
        if not use_planar:
            from .ops.dct import plane_dct, plane_idct
            from .ops.quant import dequantize, quantize
            coefs = jnp.clip(quantize(plane_dct(resid), qtab),
                             -_CLAMP, _CLAMP)
            rec_resid = plane_idct(dequantize(coefs, qtab))
            return zigzag_flatten(coefs).astype(jnp.int16), rec_resid
        cp = jnp.clip(quantize_planar(plane_dct_planar(resid), qtab),
                      -_CLAMP, _CLAMP)
        rec_resid = plane_idct_planar(dequantize_planar(cp, qtab))
        return (zigzag_flatten(blockize(cp)).astype(jnp.int16), rec_resid)

    if spatial_axis is not None and hier:
        raise ValueError("spatial sharding supports full-search "
                         "integer-pel motion only")
    if spatial_axis is not None:
        from .ops.motion import (exchange_row_halos,
                                 motion_compensate_striped,
                                 motion_search_striped)
        rc_halo = (search_range + 1) // 2

        def search_mc(cy, ref):
            ph = exchange_row_halos(ref, search_range, spatial_axis,
                                    n_spatial)
            mv = motion_search_striped(cy, ph, search_range=search_range)
            return mv, motion_compensate_striped(ph, mv, search_range,
                                                 search_range)

        def mc_chroma(pcb, pcr, mv):
            def one(p):
                return motion_compensate_striped(
                    exchange_row_halos(p, rc_halo, spatial_axis,
                                       n_spatial),
                    mv, rc_halo, search_range, mb=8)
            return one(pcb), one(pcr)
    else:
        def search_mc(cy, ref):
            search = motion_search_hier if hier else motion_search
            mv = search(cy, ref, search_range=search_range)
            return mv, motion_compensate(ref, mv,
                                         search_range=search_range)

        def mc_chroma(pcb, pcr, mv):
            return (motion_compensate(pcb, mv,
                                      search_range=search_range, mb=8),
                    motion_compensate(pcr, mv,
                                      search_range=search_range, mb=8))

    anchor_idx, b_idx, prev_map, next_map = _bframe_structure(f, bframes)
    a_arr = jnp.asarray(anchor_idx)
    ay, acb, acr = y[a_arr], cb[a_arr], cr[a_arr]

    # -- anchor chain: the v2 hybrid scan, additionally emitting the
    # reconstructed planes the B pass references ------------------------
    def astep(carry, xs):
        rec_y, rec_cb, rec_cr, idx = carry
        cy, ccb, ccr = xs
        mv, pred_p_y = search_mc(cy, rec_y)
        sad_p = jnp.abs(cy - pred_p_y).sum()
        sad_i = jnp.abs(cy - 128.0).sum()
        if spatial_axis is not None:
            # all stripes must make the SAME frame-type decision
            sad_p = jax.lax.psum(sad_p, spatial_axis)
            sad_i = jax.lax.psum(sad_i, spatial_axis)
        is_i = (idx == 0) | (sad_i < sad_p)
        mv = jnp.where(is_i, jnp.zeros_like(mv), mv)
        pred_y = jnp.where(is_i, 128.0, pred_p_y)
        pcb, pcr = mc_chroma(rec_cb, rec_cr, mv)
        pred_cb = jnp.where(is_i, 128.0, pcb)
        pred_cr = jnp.where(is_i, 128.0, pcr)
        oy, ry_rec = code_plane(cy - pred_y, qy)
        ocb, rcb_rec = code_plane(ccb - pred_cb, qc)
        ocr, rcr_rec = code_plane(ccr - pred_cr, qc)
        rec_y = jnp.clip(pred_y + ry_rec, 0.0, 255.0)
        rec_cb = jnp.clip(pred_cb + rcb_rec, 0.0, 255.0)
        rec_cr = jnp.clip(pred_cr + rcr_rec, 0.0, 255.0)
        return ((rec_y, rec_cb, rec_cr, idx + 1),
                (oy, ocb, ocr, mv.astype(jnp.int8), is_i.astype(jnp.int8),
                 rec_y, rec_cb, rec_cr))

    init = (ay[0] * 0.0, acb[0] * 0.0, acr[0] * 0.0, jnp.int32(0))
    _, (aoy, aocb, aocr, amv, ais_i, rec_ys, rec_cbs, rec_crs) = \
        jax.lax.scan(astep, init, (ay, acb, acr))

    # data-derived zeros (not jnp.zeros): keeps the varying-manual-axes
    # annotation of the outputs consistent under shard_map (CLAUDE.md)
    zero_mv = amv * 0
    zero_mode = amv[..., 0] * 0

    if b_idx:
        # -- B pass: every B frame against its reconstructed anchor pair,
        # batched over the frame axis (lax.map — each step reuses the
        # single-frame search kernels) -----------------------------------
        p_arr = jnp.asarray(prev_map)
        n_arr = jnp.asarray(next_map)
        b_arr = jnp.asarray(b_idx)

        def bstep(xs):
            cy, ccb, ccr, py, pcb_r, pcr_r, ny, ncb_r, ncr_r = xs
            fwd, pred_f = search_mc(cy, py)
            bwd, pred_b = search_mc(cy, ny)
            pred_bi = (pred_f + pred_b) * 0.5
            costs = jnp.stack([
                _mb_sums(jnp.abs(cy - pred_bi), 16),
                _mb_sums(jnp.abs(cy - pred_f), 16),
                _mb_sums(jnp.abs(cy - pred_b), 16),
                _mb_sums(jnp.abs(cy - 128.0), 16)])
            mode = jnp.argmin(costs, axis=0).astype(jnp.int8)  # tie → bi
            mpx = jnp.repeat(jnp.repeat(mode, 16, axis=0), 16, axis=1)
            pred_y = jnp.where(
                mpx == 0, pred_bi, jnp.where(
                    mpx == 1, pred_f, jnp.where(mpx == 2, pred_b, 128.0)))
            fcb, fcr = mc_chroma(pcb_r, pcr_r, fwd.astype(jnp.int32))
            bcb, bcr = mc_chroma(ncb_r, ncr_r, bwd.astype(jnp.int32))
            mpc = jnp.repeat(jnp.repeat(mode, 8, axis=0), 8, axis=1)

            def sel_c(fc, bc):
                return jnp.where(
                    mpc == 0, (fc + bc) * 0.5, jnp.where(
                        mpc == 1, fc, jnp.where(mpc == 2, bc, 128.0)))

            pred_cb = sel_c(fcb, bcb)
            pred_cr = sel_c(fcr, bcr)
            oy, _ = code_plane(cy - pred_y, qy_b)
            ocb, _ = code_plane(ccb - pred_cb, qc_b)
            ocr, _ = code_plane(ccr - pred_cr, qc_b)
            # zero unused vectors: smaller zlib'd fields, and the decode
            # never reads them
            use_f = ((mode == 0) | (mode == 1))[..., None]
            use_b = ((mode == 0) | (mode == 2))[..., None]
            fwd8 = jnp.where(use_f, fwd, 0).astype(jnp.int8)
            bwd8 = jnp.where(use_b, bwd, 0).astype(jnp.int8)
            return oy, ocb, ocr, fwd8, bwd8, mode

        boy, bocb, bocr, bfwd, bbwd, bmode = jax.lax.map(
            bstep, (y[b_arr], cb[b_arr], cr[b_arr],
                    rec_ys[p_arr], rec_cbs[p_arr], rec_crs[p_arr],
                    rec_ys[n_arr], rec_cbs[n_arr], rec_crs[n_arr]))
        # interleave back to display order (static permutation gather)
        perm = np.argsort(np.asarray(anchor_idx + b_idx))
        cat = lambda a, b: jnp.concatenate([a, b], axis=0)[perm]
        ry, rcb, rcr = cat(aoy, boy), cat(aocb, bocb), cat(aocr, bocr)
        fwd = cat(amv, bfwd)
        bwd = cat(zero_mv, bbwd)
        modes = cat(zero_mode, bmode)
        ftypes = cat(ais_i, jnp.full((len(b_idx),), 2, jnp.int8))
    else:
        ry, rcb, rcr = aoy, aocb, aocr
        fwd, bwd, modes, ftypes = amv, zero_mv, zero_mode, ais_i
    return ry, rcb, rcr, fwd, bwd, modes, ftypes


@functools.partial(jax.jit, static_argnames=("search_range", "planar"))
def fvc_mc_decode_chunk_b(a_ry, a_rcb, a_rcr, a_mvs, a_itypes,
                          b_ry, b_rcb, b_rcr, b_fwd, b_bwd, b_modes,
                          prev_map, next_map, qy, qc,
                          search_range: int = 7,
                          planar: Optional[bool] = None,
                          qy_b=None, qc_b=None):
    """Device decode of a B-frame chunk: anchors through the v2 scan
    (fvc_mc_decode_chunk), then all B frames in one parallel selection
    pass. ``prev_map``/``next_map`` index the anchor arrays per B frame;
    ``qy_b``/``qc_b`` dequantize the B residuals (header ``bquality``).
    Returns anchor recon planes and B recon planes (caller interleaves
    to display order)."""
    from .ops.motion import motion_compensate

    if qy_b is None:
        qy_b = qy
    if qc_b is None:
        qc_b = qc
    a_out = fvc_mc_decode_chunk(a_ry, a_rcb, a_rcr, a_mvs, a_itypes,
                                qy, qc, search_range=search_range,
                                subpel=False, planar=planar)
    ay, acb, acr = a_out

    def bstep(xs):
        qy_c, qcb_c, qcr_c, fwd, bwd, mode, py, pcb, pcr, ny, ncb, ncr = xs
        fwd = fwd.astype(jnp.int32)
        bwd = bwd.astype(jnp.int32)
        pred_f = motion_compensate(py, fwd, search_range=search_range)
        pred_b = motion_compensate(ny, bwd, search_range=search_range)
        mpx = jnp.repeat(jnp.repeat(mode, 16, axis=0), 16, axis=1)
        pred_y = jnp.where(
            mpx == 0, (pred_f + pred_b) * 0.5, jnp.where(
                mpx == 1, pred_f, jnp.where(mpx == 2, pred_b, 128.0)))
        fcb = motion_compensate(pcb, fwd, search_range=search_range, mb=8)
        fcr = motion_compensate(pcr, fwd, search_range=search_range, mb=8)
        bcb = motion_compensate(ncb, bwd, search_range=search_range, mb=8)
        bcr = motion_compensate(ncr, bwd, search_range=search_range, mb=8)
        mpc = jnp.repeat(jnp.repeat(mode, 8, axis=0), 8, axis=1)

        def sel_c(fc, bc):
            return jnp.where(
                mpc == 0, (fc + bc) * 0.5, jnp.where(
                    mpc == 1, fc, jnp.where(mpc == 2, bc, 128.0)))

        rec_y = jnp.clip(
            pred_y + _plane_from_coefs(qy_c, qy_b, planar=planar),
            0.0, 255.0)
        rec_cb = jnp.clip(
            sel_c(fcb, bcb) + _plane_from_coefs(qcb_c, qc_b, planar=planar),
            0.0, 255.0)
        rec_cr = jnp.clip(
            sel_c(fcr, bcr) + _plane_from_coefs(qcr_c, qc_b, planar=planar),
            0.0, 255.0)
        return rec_y, rec_cb, rec_cr

    by, bcb, bcr = jax.lax.map(
        bstep, (b_ry, b_rcb, b_rcr, b_fwd, b_bwd, b_modes,
                ay[prev_map], acb[prev_map], acr[prev_map],
                ay[next_map], acb[next_map], acr[next_map]))
    return (ay, acb, acr), (by, bcb, bcr)


@jax.jit
def fvc_accumulate(ry, rcb, rcr):
    """Decoder-side: residual planes → absolute coefficient planes
    (cumulative sum over the frame axis — the inverse scan)."""
    return (jnp.cumsum(ry.astype(jnp.int32), axis=0),
            jnp.cumsum(rcb.astype(jnp.int32), axis=0),
            jnp.cumsum(rcr.astype(jnp.int32), axis=0))


@functools.partial(jax.jit, static_argnames=(
    "pad_h", "pad_w", "subsample", "layout", "prefix_words", "use_pallas",
    "seg_words"))
def _fvc_gop_program_v1(frames, qy, qc, pad_h, pad_w, subsample, layout,
                        prefix_words, use_pallas, seg_words=None):
    """ONE fused device program per GOP: convert → DCT → quantize →
    temporal residuals → entropy pack → combined (bits + prefix) output:
    a single dispatch + single fetch per GOP. ``seg_words`` selects the
    segment layout (see jpeg._gop_dispatch_program)."""
    from .ops.entropy import (encode_gop_scans_combined,
                              encode_gop_scans_segmented)
    if isinstance(frames, (tuple, list)):
        # planar front end (jpeg._planes_front_end): v1 residuals
        # accumulate in the quantized-coefficient domain, so the
        # formulation choice cannot drift a P chain
        from .jpeg import _planes_front_end
        coefs = _planes_front_end(
            *frames, qy, qc, pad_h=pad_h, pad_w=pad_w, subsample=subsample)
    else:
        from .jpeg import _planes_front_end
        coefs = _planes_front_end(
            frames[..., 0], frames[..., 1], frames[..., 2], qy, qc,
            pad_h=pad_h, pad_w=pad_w, subsample=subsample)
    ry, rcb, rcr = fvc_residuals(*coefs)
    if seg_words is not None:
        return encode_gop_scans_segmented(
            ry, rcb, rcr, layout=layout, prefix_words=prefix_words,
            seg_words=seg_words, use_pallas=use_pallas)
    return encode_gop_scans_combined(ry, rcb, rcr, layout=layout,
                                     prefix_words=prefix_words,
                                     use_pallas=use_pallas)


@functools.partial(jax.jit, static_argnames=(
    "pad_h", "pad_w", "search_range", "layout", "prefix_words",
    "use_pallas", "hier", "subpel", "planar", "seg_words", "bframes"))
def _fvc_gop_program_v2(frames, qy, qc, pad_h, pad_w, search_range, layout,
                        prefix_words, use_pallas, hier=False, subpel=False,
                        planar=None, seg_words=None, bframes=0,
                        qy_b=None, qc_b=None):
    """v1 program with the motion-compensated hybrid loop; motion vectors
    are bitcast into extra uint32 columns of the combined output so the
    whole GOP is still ONE fetch. ``bframes`` > 0 selects the
    bidirectional structure (fvc_mc_encode_chunk_b): the side columns
    then carry fwd + bwd vectors and the per-macroblock mode plane."""
    from .ops.entropy import (encode_gop_scans_combined,
                              encode_gop_scans_segmented)
    if bframes:
        ry, rcb, rcr, fwd, bwd, modes, ftypes = fvc_mc_encode_chunk_b(
            frames, qy, qc, pad_h=pad_h, pad_w=pad_w,
            search_range=search_range, bframes=bframes, hier=hier,
            planar=planar, qy_b=qy_b, qc_b=qc_b)
        f = fwd.shape[0]
        side = jnp.concatenate([fwd.reshape(f, -1), bwd.reshape(f, -1),
                                modes.reshape(f, -1)], axis=1)
        itypes = ftypes
    else:
        ry, rcb, rcr, mvs, itypes = fvc_mc_encode_chunk(
            frames, qy, qc, pad_h=pad_h, pad_w=pad_w,
            search_range=search_range, hier=hier, subpel=subpel,
            planar=planar)
        f = mvs.shape[0]
        side = mvs.reshape(f, -1)
    if seg_words is not None:
        combined = encode_gop_scans_segmented(
            ry, rcb, rcr, layout=layout, prefix_words=prefix_words,
            seg_words=seg_words, use_pallas=use_pallas)
    else:
        combined = encode_gop_scans_combined(ry, rcb, rcr, layout=layout,
                                             prefix_words=prefix_words,
                                             use_pallas=use_pallas)
    pad = (-side.shape[1]) % 4
    if pad:
        side = jnp.pad(side, ((0, 0), (0, pad)))
    mv_words = jax.lax.bitcast_convert_type(
        side.reshape(f, -1, 4), jnp.uint32)
    itype_word = itypes.astype(jnp.uint32)[:, None]
    return jnp.concatenate([combined, mv_words, itype_word], axis=1)


@functools.partial(jax.jit, static_argnames=(
    "src_fn", "n", "pad_h", "pad_w", "subsample", "layout", "prefix_words",
    "use_pallas", "seg_words"))
def _fvc_gop_program_v1_src(start, qy, qc, src_fn, n, pad_h, pad_w,
                            subsample, layout, prefix_words, use_pallas,
                            seg_words=None):
    """v1 program with an on-device frame source fused in (one dispatch
    per GOP instead of source + encode — see
    jpeg._gop_dispatch_program_src)."""
    frames = src_fn(pad_h, pad_w, n, start)
    return _fvc_gop_program_v1(frames, qy, qc, pad_h=pad_h, pad_w=pad_w,
                               subsample=subsample, layout=layout,
                               prefix_words=prefix_words,
                               use_pallas=use_pallas, seg_words=seg_words)


@functools.partial(jax.jit, static_argnames=(
    "src_fn", "n", "pad_h", "pad_w", "search_range", "layout",
    "prefix_words", "use_pallas", "hier", "subpel", "planar", "seg_words",
    "bframes"))
def _fvc_gop_program_v2_src(start, qy, qc, src_fn, n, pad_h, pad_w,
                            search_range, layout, prefix_words, use_pallas,
                            hier=False, subpel=False, planar=None,
                            seg_words=None, bframes=0, qy_b=None,
                            qc_b=None):
    frames = src_fn(pad_h, pad_w, n, start)
    return _fvc_gop_program_v2(frames, qy, qc, pad_h=pad_h, pad_w=pad_w,
                               search_range=search_range, layout=layout,
                               prefix_words=prefix_words,
                               use_pallas=use_pallas, hier=hier,
                               subpel=subpel, planar=planar,
                               seg_words=seg_words, bframes=bframes,
                               qy_b=qy_b, qc_b=qc_b)


@functools.partial(jax.jit, static_argnames=(
    "src_fn", "n", "batch", "pad_h", "pad_w", "subsample", "search_range",
    "layout", "prefix_words", "use_pallas", "hier", "subpel", "planar",
    "seg_words", "bframes", "motion"))
def _fvc_gop_program_batched_src(start, qy, qc, src_fn, n, batch, pad_h,
                                 pad_w, subsample, layout, prefix_words,
                                 use_pallas, motion=False, search_range=7,
                                 hier=False, subpel=False, planar=None,
                                 seg_words=None, bframes=0, qy_b=None,
                                 qc_b=None):
    """``batch`` independent chunks in ONE device program → ONE dispatch
    and ONE fetch for batch*n frames. FVC's 8-frame bitstream GOP cannot
    grow the way the JPEG dispatch batch can (16-frame batching,
    bench.py), so batching whole chunks amortizes the per-dispatch cost.
    Chunks stay bitstream-independent (an I frame starts each), so the
    output is byte-identical to ``batch`` separate dispatches.
    Output: (batch, F, X) — rows are the per-chunk combined arrays."""
    rows = []
    for b in range(batch):
        s_b = start + jnp.float32(b * n)
        if motion:
            rows.append(_fvc_gop_program_v2_src(
                s_b, qy, qc, src_fn, n, pad_h=pad_h, pad_w=pad_w,
                search_range=search_range, layout=layout,
                prefix_words=prefix_words, use_pallas=use_pallas,
                hier=hier, subpel=subpel, planar=planar,
                seg_words=seg_words, bframes=bframes, qy_b=qy_b,
                qc_b=qc_b))
        else:
            rows.append(_fvc_gop_program_v1_src(
                s_b, qy, qc, src_fn, n, pad_h=pad_h, pad_w=pad_w,
                subsample=subsample, layout=layout,
                prefix_words=prefix_words, use_pallas=use_pallas,
                seg_words=seg_words))
    return jnp.stack(rows)


class FvcEncoder:
    """Encode GOP chunks of RGB frames into FVC bitstream chunks.

    ``motion=True`` selects the v2 hybrid codec: full-search motion
    compensation on device, residual DCT coding, in-loop reconstruction —
    better compression on moving content at the cost of the search."""

    def __init__(self, quality: int = 85, subsample: bool = True,
                 motion: bool = False, search_range: int = 7,
                 engine: str = "auto", hier: bool = False,
                 subpel: bool = False, segmented: Optional[bool] = None,
                 bframes: int = 0, bquality: Optional[int] = None):
        from .jpeg import JpegEncoder
        self.quality = quality
        self.subsample = subsample
        self.motion = motion
        if bframes:
            if not motion:
                raise ValueError("bframes requires motion=True")
            if subpel:
                raise ValueError("bframes does not support subpel")
            if not 0 < bframes <= 7:
                raise ValueError("bframes must be in 0..7")
        self.bframes = int(bframes)
        # B frames are non-reference: coarser quantization there never
        # propagates, so they default a step below the anchor quality —
        # the rate-allocation lever that makes B frames pay for the wider
        # anchor spacing. Travels in the header (bit5 extension byte).
        self.bquality = None
        if bframes:
            self.bquality = int(bquality) if bquality is not None \
                else max(10, quality - 8)
            if not 1 <= self.bquality <= 100:
                raise ValueError("bquality must be in 1..100")
        # vectors travel as int8 in the bitstream; with subpel they are in
        # half-pixel units up to ±(2*search_range+1) — bound the range so
        # they can never wrap (ADVICE r1: silent int8 overflow)
        limit = 62 if subpel else 126
        if not 0 < search_range <= limit:
            raise ValueError(
                f"search_range must be in 1..{limit} "
                f"(subpel={subpel}; vectors are int8 in the bitstream)")
        self.search_range = search_range
        self.hier = hier  # coarse-to-fine motion search (~7x fewer passes)
        self.subpel = subpel  # half-pel refinement + bilinear compensation
        # in-loop recon formulation — travels in the header (flags bit 3)
        # so decoders on any backend track the encoder bit-exactly
        self.planar = platform.dct_planar()
        self.qy = scale_qtable(LUMA_QTABLE, quality)
        self.qc = scale_qtable(CHROMA_QTABLE, quality)
        self._qy_dev = jnp.asarray(self.qy)
        self._qc_dev = jnp.asarray(self.qc)
        self._qyb_dev = self._qcb_dev = None
        if self.bquality is not None:
            self._qyb_dev = jnp.asarray(scale_qtable(LUMA_QTABLE,
                                                     self.bquality))
            self._qcb_dev = jnp.asarray(scale_qtable(CHROMA_QTABLE,
                                                     self.bquality))
        self.engine = engine
        # shared scan coder: device entropy packing (only compressed bits
        # are fetched) with host C++ fallback
        self._scan_coder = JpegEncoder(quality, subsample=subsample,
                                       engine=engine, segmented=segmented)

    def _layout_cap(self, ph: int, pw: int):
        from .ops.entropy import mcu_layout
        if self.subsample:
            layout = mcu_layout(pw // 8, ph // 8, pw // 16, ph // 16, True)
        else:
            layout = mcu_layout(pw // 8, ph // 8, pw // 8, ph // 8, False)
        return layout, self._scan_coder._prefix_cap(layout)

    def _device_dispatch(self, frames, ph: int, pw: int):
        """Non-blocking half: launch the fused GOP program; returns the
        un-materialized combined array, the prefix window used, the
        segment capacity (None = block-concat layout) and the build
        closure for the rare overflow redispatch."""
        sc = self._scan_coder
        layout, cap = self._layout_cap(ph, pw)
        dev = jnp.asarray(frames)

        def build(prefix_w, sw_w):
            p = min(cap, prefix_w or cap)
            s = sw_w if sc.segmented else None
            if self.motion:
                return _fvc_gop_program_v2(
                    dev, self._qy_dev, self._qc_dev, pad_h=ph, pad_w=pw,
                    search_range=self.search_range, layout=layout,
                    prefix_words=p, use_pallas=sc.use_pallas,
                    hier=self.hier, subpel=self.subpel, planar=self.planar,
                    seg_words=s, bframes=self.bframes,
                    qy_b=self._qyb_dev, qc_b=self._qcb_dev), p, s
            return _fvc_gop_program_v1(
                dev, self._qy_dev, self._qc_dev, pad_h=ph, pad_w=pw,
                subsample=self.subsample, layout=layout,
                prefix_words=p, use_pallas=sc.use_pallas,
                seg_words=s), p, s

        build.prefix_cap = cap  # _device_finalize coverage check
        win, sw = sc._maybe_adopt_or_warm(build)
        combined, prefix, sw = build(win, sw)
        return combined, prefix, sw, build

    def encode_chunk_dispatch_src(self, src_fn, start, n: int, h: int,
                                  w: int):
        """encode_chunk_dispatch with the frame source fused into the GOP
        program: ``src_fn(ph, pw, n, start) -> (n, ph, pw, 3) uint8`` OR
        a channel-planar ``(r, g, b)`` tuple of (n, ph, pw) planes
        (preferred — see jpeg.encode_gop_planes_to_coefs).
        Frames never exist as a separate dispatch (or host array); the
        overflow fallback re-synthesizes them lazily."""
        mult = 16 if self.subsample else 8
        ph, pw = _pad_to(h, mult), _pad_to(w, mult)
        sc = self._scan_coder
        layout, cap = self._layout_cap(ph, pw)

        def build(prefix_w, sw_w):
            p = min(cap, prefix_w or cap)
            s = sw_w if sc.segmented else None
            if self.motion:
                return _fvc_gop_program_v2_src(
                    start, self._qy_dev, self._qc_dev, src_fn, n,
                    pad_h=ph, pad_w=pw, search_range=self.search_range,
                    layout=layout, prefix_words=p,
                    use_pallas=sc.use_pallas, hier=self.hier,
                    subpel=self.subpel, planar=self.planar,
                    seg_words=s, bframes=self.bframes,
                    qy_b=self._qyb_dev, qc_b=self._qcb_dev), p, s
            return _fvc_gop_program_v1_src(
                start, self._qy_dev, self._qc_dev, src_fn, n,
                pad_h=ph, pad_w=pw, subsample=self.subsample,
                layout=layout, prefix_words=p,
                use_pallas=sc.use_pallas, seg_words=s), p, s

        build.prefix_cap = cap  # _device_finalize coverage check
        win, sw = sc._maybe_adopt_or_warm(build)
        combined, prefix, sw = build(win, sw)

        # full padded geometry (not cropped to h, w): the fallback re-encode
        # then pads to the identical content and stays bit-exact (planar
        # sources stack back to the interleaved form — identical values)
        def lazy():
            out = src_fn(ph, pw, n, start)
            if isinstance(out, (tuple, list)):
                out = jnp.stack(out, axis=-1)
            return np.asarray(out)
        return ("dev", combined, prefix, sw, lazy, n, h, w, ph, pw, build)

    def encode_chunk_batch_dispatch_src(self, src_fn, start, n: int,
                                        h: int, w: int, batch: int = 2):
        """``batch`` chunks of ``n`` frames in ONE dispatch + ONE fetch
        (see _fvc_gop_program_batched_src). Bitstreams are byte-identical
        to ``batch`` separate encode_chunk_dispatch_src calls; use when
        throughput matters more than one-GOP latency. Finalize with
        encode_chunk_batch_finalize -> list of ``batch`` chunk bytes."""
        mult = 16 if self.subsample else 8
        ph, pw = _pad_to(h, mult), _pad_to(w, mult)
        sc = self._scan_coder
        layout, cap = self._layout_cap(ph, pw)

        def build(prefix_w, sw_w):
            p = min(cap, prefix_w or cap)
            s = sw_w if sc.segmented else None
            return _fvc_gop_program_batched_src(
                start, self._qy_dev, self._qc_dev, src_fn, n, batch,
                pad_h=ph, pad_w=pw, subsample=self.subsample,
                layout=layout, prefix_words=p, use_pallas=sc.use_pallas,
                motion=self.motion, search_range=self.search_range,
                hier=self.hier, subpel=self.subpel, planar=self.planar,
                seg_words=s, bframes=self.bframes, qy_b=self._qyb_dev,
                qc_b=self._qcb_dev), p, s

        build.prefix_cap = cap
        win, sw = sc._maybe_adopt_or_warm(build)
        combined, prefix, sw = build(win, sw)

        def lazy_b(b):
            def lazy():
                out = src_fn(ph, pw, n, start + b * n)
                if isinstance(out, (tuple, list)):
                    out = jnp.stack(out, axis=-1)
                return np.asarray(out)
            return lazy
        lazies = [lazy_b(b) for b in range(batch)]
        return ("devb", combined, prefix, sw, lazies, n, h, w, ph, pw,
                build)

    def encode_chunk_batch_finalize(self, handle):
        """Blocking half of the batched dispatch: ONE fetch for the
        whole batch, then the standard per-chunk finalize (overflow
        redispatch included — a grown redispatch rebuilds the batched
        program, so it too is one dispatch)."""
        tag, combined, prefix, sw, lazies, n, h, w, ph, pw, build = handle
        assert tag == "devb"
        arr = np.asarray(combined)          # the one transfer
        batch = arr.shape[0]

        def row_build(b):
            def rb(p, s):
                c, p2, s2 = build(p, s)
                return c[b], p2, s2
            rb.prefix_cap = getattr(build, "prefix_cap", None)
            return rb

        out = []
        for b in range(batch):
            payloads, mvs, itypes = self._device_finalize(
                arr[b], prefix, sw, lazies[b], ph, pw, build=row_build(b))
            if payloads is None:
                if self.engine == "device":
                    raise OverflowError("device entropy cap exceeded")
                payloads, mvs, itypes = self._encode_host(
                    lazies[b](), ph, pw)
            out.append(self._build_chunk(payloads, mvs, itypes, n, h, w))
        return out

    def _encode_device(self, frames: np.ndarray, ph: int, pw: int):
        """Fused single-dispatch + single-fetch GOP encode. Returns
        (payloads, mvs, itypes) or (None, None, None) when even the
        grown-size redispatch overflowed (dense content → caller falls
        back to the host coder)."""
        combined, prefix, sw, build = self._device_dispatch(frames, ph, pw)
        return self._device_finalize(combined, prefix, sw, frames, ph, pw,
                                     build=build)

    def _device_finalize(self, combined, prefix: int, sw, frames, ph: int,
                         pw: int, build=None):
        """Blocking half: ONE fetch, overflow handling, extraction.
        ``sw`` = the segment capacity the dispatch compiled with (None =
        block-concat layout). On overflow the device has reported the
        TRUE usage, so the SAME program family is redispatched once at
        sizes that cover it (``build``) — the grown program is exactly
        what subsequent chunks dispatch, so its compile was needed
        anyway."""
        from .ops.entropy import (compact_segments_finalize,
                                  stuff_and_finalize)
        sc = self._scan_coder
        arr = np.asarray(combined)
        layout, _ = self._layout_cap(ph, pw)
        n_segs = sc._n_segs(layout) if sw is not None else 0
        scan_end = 1 + n_segs + prefix
        segbits = None
        if sw is not None:
            used = arr[:, 0].astype(np.int64)
            segbits = arr[:, 1:1 + n_segs].astype(np.int64)
            overflow = (used > prefix).any() or (segbits > sw * 32).any()
        else:
            bits = arr[:, 0].astype(np.int64)
            used = (bits + 31) // 32
            overflow = (bits > prefix * 32).any()
        if overflow:
            if build is None:   # the grown redispatch itself overflowed
                sc._reset_prefix_spike()   # pathological: reset
                return None, None, None
            seg_need = None
            if segbits is not None and (segbits > sw * 32).any():
                seg_need = (int(segbits.max()) + 31) // 32
            w_need = int(used.max())
            new_prefix, new_sw = sc._overflow_sizes(w_need, seg_need)
            new_prefix = new_prefix or prefix
            # redispatch only at sizes that COVER the device-reported
            # need ("grew" is not enough — a need above the geometry cap
            # / capacity ladder bound would overflow again); eff_p
            # mirrors build's own cap clamp (see jpeg._refinalize_grown)
            cap = getattr(build, "prefix_cap", None)
            eff_p = min(cap, new_prefix) if cap else new_prefix
            if w_need > eff_p or (seg_need and seg_need > (new_sw or 0)):
                sc._reset_prefix_spike()
                return None, None, None
            combined2, p2, s2 = build(new_prefix, new_sw)
            if p2 < w_need or (seg_need and (s2 or 0) < seg_need):
                sc._reset_prefix_spike()   # normalization erased the
                return None, None, None    # growth: don't fetch a
                                           # guaranteed overflow
            return self._device_finalize(combined2, p2, s2, frames, ph, pw,
                                         build=None)
        if sw is not None:
            sc._note_prefix_usage(int(used.max()))
            sc._note_seg_usage(int(segbits.max()))
            payloads = [compact_segments_finalize(
                segbits[i], arr[i, 1 + n_segs:scan_end])
                for i in range(arr.shape[0])]
        else:
            sc._note_prefix_usage((bits.max() + 31) // 32)
            payloads = [stuff_and_finalize(arr[i, 1:1 + prefix],
                                           int(bits[i]))
                        for i in range(arr.shape[0])]
        mvs = itypes = None
        if self.motion:
            mbh, mbw = ph // 16, pw // 16
            mv_len = mbh * mbw * 2
            if self.bframes:
                # side columns: fwd | bwd | modes (int8, padded to words)
                mbn = mbh * mbw
                mvs = []
                for i in range(arr.shape[0]):
                    raw = np.frombuffer(arr[i, scan_end:-1].tobytes(),
                                        np.int8)
                    fwd = raw[:mv_len].reshape(mbh, mbw, 2)
                    bwd = raw[mv_len:2 * mv_len].reshape(mbh, mbw, 2)
                    modes = raw[2 * mv_len:2 * mv_len + mbn].reshape(
                        mbh, mbw)
                    mvs.append((fwd, bwd, modes))
            else:
                mvs = [np.frombuffer(arr[i, scan_end:-1].tobytes(),
                                     np.int8)[:mv_len].reshape(
                                         mbh, mbw, 2)
                       for i in range(arr.shape[0])]
            itypes = arr[:, -1].astype(np.int64)  # 1 = I frame, 2 = B
        return payloads, mvs, itypes

    def _encode_host(self, frames: np.ndarray, ph: int, pw: int):
        """Reference path: residual planes fetched, host C++ scan coder."""
        if self.motion and self.bframes:
            ry, rcb, rcr, fwd, bwd, modes, ftypes = fvc_mc_encode_chunk_b(
                jnp.asarray(frames), self._qy_dev, self._qc_dev,
                pad_h=ph, pad_w=pw, search_range=self.search_range,
                bframes=self.bframes, hier=self.hier, planar=self.planar,
                qy_b=self._qyb_dev, qc_b=self._qcb_dev)
            fwd, bwd = np.asarray(fwd), np.asarray(bwd)
            modes = np.asarray(modes)
            mvs = [(fwd[i], bwd[i], modes[i]) for i in range(fwd.shape[0])]
            itypes = np.asarray(ftypes).astype(np.int64)
        elif self.motion:
            ry, rcb, rcr, mvs, itypes = fvc_mc_encode_chunk(
                jnp.asarray(frames), self._qy_dev, self._qc_dev,
                pad_h=ph, pad_w=pw, search_range=self.search_range,
                hier=self.hier, subpel=self.subpel, planar=self.planar)
            mvs = list(np.asarray(mvs))
            itypes = np.asarray(itypes).astype(np.int64)
        else:
            coefs = encode_gop_to_coefs(jnp.asarray(frames), self._qy_dev,
                                        self._qc_dev, pad_h=ph, pad_w=pw,
                                        subsample=self.subsample)
            ry, rcb, rcr = fvc_residuals(*coefs)
            mvs = itypes = None
        return self._scan_coder._scans_host((ry, rcb, rcr)), mvs, itypes

    def encode_chunk(self, frames: np.ndarray) -> bytes:
        """(F, H, W, 3) uint8 → one FVC chunk (frame 0 is the I frame)."""
        return self.encode_chunk_finalize(self.encode_chunk_dispatch(frames))

    # -- async pipeline API (mirror of JpegEncoder dispatch/finalize):
    # dispatch launches the fused device program without blocking so a
    # caller can keep N chunks in flight and overlap host container
    # assembly with device compute --------------------------------------
    def encode_chunk_dispatch(self, frames):
        f, h, w, _ = frames.shape
        mult = 16 if self.subsample else 8
        ph, pw = _pad_to(h, mult), _pad_to(w, mult)
        if self.motion and not self.subsample:
            raise ValueError("motion mode requires 4:2:0")
        if self.engine in ("device", "auto"):
            combined, prefix, sw, build = self._device_dispatch(
                frames, ph, pw)
            return ("dev", combined, prefix, sw, frames, f, h, w, ph, pw,
                    build)
        return ("host", frames, f, h, w, ph, pw)

    def encode_chunk_finalize(self, handle) -> bytes:
        if handle[0] == "dev":
            _, combined, prefix, sw, frames, f, h, w, ph, pw, build = handle
            payloads, mvs, itypes = self._device_finalize(
                combined, prefix, sw, frames, ph, pw, build=build)
            if payloads is None:
                if self.engine == "device":
                    raise OverflowError("device entropy cap exceeded")
                if callable(frames):
                    frames = frames()
                payloads, mvs, itypes = self._encode_host(frames, ph, pw)
        else:
            _, frames, f, h, w, ph, pw = handle
            payloads, mvs, itypes = self._encode_host(frames, ph, pw)
        return self._build_chunk(payloads, mvs, itypes, f, h, w)

    def _build_chunk(self, payloads, mvs, itypes, f: int, h: int,
                     w: int) -> bytes:
        version = 2 if self.motion else VERSION
        flags = 1 if self.subsample else 0
        if self.motion:
            flags |= 2  # motion vectors are zlib-compressed
            if self.subpel:
                flags |= 4  # vectors are in half-pel units
            if self.planar:
                flags |= 8  # in-loop recon used the planar DCT formulation
            if self.bframes:
                flags |= 32  # chunk may contain B frames (ftype 2)
        out = [MAGIC, struct.pack(">BBHHBB", version, flags, w, h,
                                  self.quality, f)]
        if self.motion:
            # v2 extends the header with the search range so the decoder
            # sizes its compensation window without guessing
            out.append(struct.pack(">B", self.search_range))
            if self.bframes:
                # bit5 extension: the B-frame quantizer quality (follows
                # any bit4 coded-size extension, which this writer never
                # emits — tpuhype's striped path does)
                out.append(struct.pack(">B", self.bquality))
        for i in range(f):
            payload = payloads[i]
            if self.motion:
                # per-frame mode decision (device scan): mid-chunk scene
                # cuts become I frames instead of expensive P frames.
                # itype codes: 1 = I anchor, 0 = P anchor, 2 = B.
                it = int(itypes[i]) if itypes is not None else 0
                if it == 2:
                    ftype = 2
                else:
                    ftype = 0 if (i == 0 or it) else 1
            else:
                ftype = 0 if i == 0 else 1
            if self.motion:
                # raw vectors cost 2 B/macroblock (~16 KB/frame at 1080p);
                # they are mostly smooth/zero, so zlib cuts them ~100x
                import zlib
                if ftype == 2:
                    fwd, bwd, modes = mvs[i]
                    mv_bytes = zlib.compress(
                        fwd.astype(np.int8).tobytes()
                        + bwd.astype(np.int8).tobytes()
                        + modes.astype(np.int8).tobytes(), 6)
                elif ftype == 0:
                    mv_bytes = b""
                else:
                    mv = mvs[i][0] if isinstance(mvs[i], tuple) else mvs[i]
                    mv_bytes = zlib.compress(mv.astype(np.int8).tobytes(),
                                             6)
                out.append(struct.pack(">BHI", ftype, len(mv_bytes),
                                       len(payload)))
                out.append(mv_bytes)
            else:
                out.append(struct.pack(">BI", ftype, len(payload)))
            out.append(payload)
        return b"".join(out)


@functools.partial(jax.jit, static_argnames=("search_range", "subpel",
                                             "planar"))
def fvc_mc_decode_chunk(ry, rcb, rcr, mvs, itypes, qy, qc,
                        search_range: int = 7, subpel: bool = False,
                        planar: Optional[bool] = None):
    """Device mirror of fvc_mc_encode_chunk's in-loop reconstruction.

    ry/rcb/rcr: (F, BH, BW, 64) int16 zigzag residual coefficients;
    mvs: (F, mbh, mbw, 2) int8; itypes: (F,) int8 — 1 where the frame is
    intra-coded (flat-128 prediction). Returns (F, H, W) float planes."""
    from .ops.dct import plane_idct_planar, unblockize
    from .ops.motion import motion_compensate, motion_compensate_subpel
    from .ops.quant import dequantize_planar, zigzag_unflatten

    # MUST match the encoder's code_plane formulation (header flags
    # bit 3): P frames chain off reconstructed state, and the two DCT
    # orders round differently in f32
    use_planar = platform.dct_planar() if planar is None else bool(planar)

    def resid(q, qtab):
        if not use_planar:
            from .ops.dct import plane_idct
            from .ops.quant import dequantize
            return plane_idct(
                dequantize(zigzag_unflatten(q.astype(jnp.float32)), qtab))
        cp = unblockize(zigzag_unflatten(q.astype(jnp.int32)))
        return plane_idct_planar(dequantize_planar(cp, qtab))

    if subpel:
        mc_y = lambda p, m: motion_compensate_subpel(p, m)
        mc_c = lambda p, m: motion_compensate_subpel(p, m, mb=8)
    else:
        mc_y = lambda p, m: motion_compensate(p, m,
                                              search_range=search_range)
        mc_c = lambda p, m: motion_compensate(p, m,
                                              search_range=search_range,
                                              mb=8)

    def step(carry, xs):
        rec_y, rec_cb, rec_cr, idx = carry
        qy_c, qcb_c, qcr_c, mv, it = xs
        is_i = (idx == 0) | (it != 0)
        mv = mv.astype(jnp.int32)
        pred_y = jnp.where(is_i, 128.0, mc_y(rec_y, mv))
        pred_cb = jnp.where(is_i, 128.0, mc_c(rec_cb, mv))
        pred_cr = jnp.where(is_i, 128.0, mc_c(rec_cr, mv))
        rec_y = jnp.clip(pred_y + resid(qy_c, qy), 0.0, 255.0)
        rec_cb = jnp.clip(pred_cb + resid(qcb_c, qc), 0.0, 255.0)
        rec_cr = jnp.clip(pred_cr + resid(qcr_c, qc), 0.0, 255.0)
        return (rec_y, rec_cb, rec_cr, idx + 1), (rec_y, rec_cb, rec_cr)

    h, w = ry.shape[1] * 8, ry.shape[2] * 8
    ch, cw = rcb.shape[1] * 8, rcb.shape[2] * 8
    init = (jnp.zeros((h, w)), jnp.zeros((ch, cw)), jnp.zeros((ch, cw)),
            jnp.int32(0))
    _, (oy, ocb, ocr) = jax.lax.scan(step, init,
                                     (ry, rcb, rcr, mvs, itypes))
    return oy, ocb, ocr


@jax.jit
def _i420_frames_to_rgb(y, cb, cr):
    from .ops.colorspace import i420_to_rgb
    rgb = i420_to_rgb(y, cb, cr)
    return jnp.clip(rgb + 0.5, 0, 255).astype(jnp.uint8)


def _mc_np_subpel(prev: np.ndarray, mv_hp: np.ndarray, mb: int,
                  chroma: bool) -> np.ndarray:
    """numpy mirror of ops.motion.motion_compensate_subpel (half-pel
    bilinear between the four integer-shift rolls)."""
    out = np.empty_like(prev)
    mbh, mbw = mv_hp.shape[:2]
    for by in range(mbh):
        for bx in range(mbw):
            dy, dx = int(mv_hp[by, bx, 0]), int(mv_hp[by, bx, 1])
            if chroma:
                dy, dx = dy // 2, dx // 2
            iy, ix = dy // 2, dx // 2
            fy, fx = (dy - 2 * iy) * 0.5, (dx - 2 * ix) * 0.5
            sl = (slice(by * mb, (by + 1) * mb),
                  slice(bx * mb, (bx + 1) * mb))
            p00 = np.roll(prev, (iy, ix), (0, 1))[sl]
            p10 = np.roll(prev, (iy + 1, ix), (0, 1))[sl]
            p01 = np.roll(prev, (iy, ix + 1), (0, 1))[sl]
            p11 = np.roll(prev, (iy + 1, ix + 1), (0, 1))[sl]
            out[sl] = ((1 - fy) * (1 - fx) * p00 + fy * (1 - fx) * p10
                       + (1 - fy) * fx * p01 + fy * fx * p11)
    return out


def _mc_np(prev: np.ndarray, mv: np.ndarray, mb: int,
           chroma: bool) -> np.ndarray:
    """numpy mirror of ops.motion.motion_compensate (wrap-around rolls,
    floor-halved vectors on the chroma grid)."""
    out = np.empty_like(prev)
    mbh, mbw = mv.shape[:2]
    for by in range(mbh):
        for bx in range(mbw):
            dy, dx = int(mv[by, bx, 0]), int(mv[by, bx, 1])
            if chroma:
                dy, dx = dy // 2, dx // 2
            shifted = np.roll(prev, (dy, dx), axis=(0, 1))
            out[by * mb:(by + 1) * mb, bx * mb:(bx + 1) * mb] = \
                shifted[by * mb:(by + 1) * mb, bx * mb:(bx + 1) * mb]
    return out


@functools.partial(jax.jit, static_argnames=("planar",))
def _plane_from_coefs(q: jax.Array, qtab: jax.Array,
                      planar: Optional[bool] = None) -> jax.Array:
    from .ops.quant import zigzag_unflatten
    use_planar = platform.dct_planar() if planar is None else bool(planar)
    if not use_planar:
        from .ops.dct import plane_idct
        from .ops.quant import dequantize
        return plane_idct(
            dequantize(zigzag_unflatten(q.astype(jnp.float32)), qtab))
    from .ops.dct import plane_idct_planar, unblockize
    from .ops.quant import dequantize_planar
    cp = unblockize(zigzag_unflatten(q.astype(jnp.int32)))
    return plane_idct_planar(dequantize_planar(cp, qtab))


class FvcDecoder:
    """Decode FVC chunks back to RGB frames (host entropy decode + device
    reconstruction; v2 chunks add motion-compensated prediction)."""

    def decode_chunk(self, data: bytes) -> Tuple[np.ndarray, dict]:
        if data[:4] != MAGIC:
            raise ValueError("not an FVC chunk")
        if len(data) < 12:
            raise ValueError("truncated FVC chunk header")
        version, flags, w, h, quality, f = struct.unpack(">BBHHBB", data[4:12])
        subsample = bool(flags & 1)
        mult = 16 if subsample else 8
        ph, pw = _pad_to(h, mult), _pad_to(w, mult)
        if ph == 0 or pw == 0:
            raise ValueError("zero-sized FVC chunk")
        ybw, ybh = pw // 8, ph // 8
        cbw, cbh = (pw // 16, ph // 16) if subsample else (ybw, ybh)
        off = 12
        search_range = 7
        if version >= 2:
            if len(data) < 13:
                raise ValueError("truncated FVC v2 header")
            search_range = data[12]
            off = 13
        if flags & 16:
            # explicit coded size (flags bit 4): the coded geometry
            # exceeds the minimum macroblock padding — e.g. spatially
            # striped encodes pad H to 16*stripes (tpuhype spatial>1)
            if len(data) < off + 4:
                raise ValueError("truncated coded-size extension")
            pw, ph = struct.unpack(">HH", data[off:off + 4])
            off += 4
            if ph < h or pw < w or ph % mult or pw % mult:
                raise ValueError("invalid coded-size extension")
            ybw, ybh = pw // 8, ph // 8
            cbw, cbh = (pw // 16, ph // 16) if subsample else (ybw, ybh)
        bquality = quality
        if flags & 32:
            # bit5 extension: B-frame quantizer quality
            if len(data) < off + 1:
                raise ValueError("truncated bquality extension")
            bquality = data[off]
            off += 1
            if not 1 <= bquality <= 100:
                raise ValueError("invalid bquality extension")
        planes = []
        types = []
        mvs = []
        for i in range(f):
            if version >= 2:
                if len(data) - off < 7:
                    raise ValueError(f"truncated frame header (frame {i})")
                ftype, mv_len, plen = struct.unpack(">BHI", data[off:off + 7])
                off += 7
                mv = None
                if mv_len:
                    if len(data) - off < mv_len:
                        raise ValueError(f"bad motion block (frame {i})")
                    raw = data[off:off + mv_len]
                    if flags & 2:
                        import zlib
                        try:
                            raw = zlib.decompress(raw)
                        except zlib.error as e:
                            raise ValueError(
                                f"corrupt motion block (frame {i}): {e}")
                    mbn = (ph // 16) * (pw // 16)
                    if ftype == 2:
                        # B frame: fwd vectors | bwd vectors | mode plane
                        if len(raw) != mbn * 5:
                            raise ValueError(f"bad motion block (frame {i})")
                        b8 = np.frombuffer(raw, np.int8)
                        mv = (b8[:mbn * 2].reshape(ph // 16, pw // 16, 2),
                              b8[mbn * 2:mbn * 4].reshape(
                                  ph // 16, pw // 16, 2),
                              b8[mbn * 4:].reshape(ph // 16, pw // 16))
                    else:
                        if len(raw) != mbn * 2:
                            raise ValueError(f"bad motion block (frame {i})")
                        mv = np.frombuffer(raw, np.int8).reshape(
                            ph // 16, pw // 16, 2)
                    off += mv_len
                elif ftype == 2:
                    raise ValueError(f"B frame without motion block "
                                     f"(frame {i})")
                mvs.append(mv)
            else:
                if len(data) - off < 5:
                    raise ValueError(f"truncated frame header (frame {i})")
                ftype, plen = struct.unpack(">BI", data[off:off + 5])
                off += 5
                mvs.append(None)
            if len(data) - off < plen:
                raise ValueError(f"truncated payload (frame {i})")
            payload = data[off:off + plen]
            off += plen
            coefs = decode_scan_to_coefs(payload, ybw, ybh, cbw, cbh,
                                         subsample)
            if coefs is None:
                raise ValueError(f"corrupt FVC payload (frame {i})")
            planes.append(coefs)
            types.append(ftype)

        qy = jnp.asarray(scale_qtable(LUMA_QTABLE, quality))
        qc = jnp.asarray(scale_qtable(CHROMA_QTABLE, quality))
        if version >= 2 and 2 in types:
            if flags & 4:
                raise ValueError("B frames with subpel vectors are not a "
                                 "valid stream")
            qy_b = jnp.asarray(scale_qtable(LUMA_QTABLE, bquality))
            qc_b = jnp.asarray(scale_qtable(CHROMA_QTABLE, bquality))
            frames = self._reconstruct_mc_b(planes, mvs, types, qy, qc,
                                            h, w, search_range,
                                            planar=bool(flags & 8),
                                            qy_b=qy_b, qc_b=qc_b)
        elif version >= 2:
            frames = self._reconstruct_mc(planes, mvs, qy, qc, h, w,
                                          search_range,
                                          subpel=bool(flags & 4),
                                          planar=bool(flags & 8))
        else:
            ry = jnp.asarray(np.stack([p[0] for p in planes]))
            rcb = jnp.asarray(np.stack([p[1] for p in planes]))
            rcr = jnp.asarray(np.stack([p[2] for p in planes]))
            yq, cbq, crq = fvc_accumulate(ry, rcb, rcr)
            frames = [np.asarray(coefs_to_rgb(yq[i], cbq[i], crq[i], qy, qc,
                                              h=h, w=w, subsample=subsample))
                      for i in range(f)]
        return np.stack(frames), {"quality": quality, "types": types,
                                  "width": w, "height": h}

    def _reconstruct_mc(self, planes, mvs, qy, qc, h: int, w: int,
                        search_range: int = 7, subpel: bool = False,
                        planar: bool = False):
        """Whole-chunk device reconstruction (one jitted scan)."""
        f = len(planes)
        ry = jnp.asarray(np.stack([p[0] for p in planes]))
        rcb = jnp.asarray(np.stack([p[1] for p in planes]))
        rcr = jnp.asarray(np.stack([p[2] for p in planes]))
        mbh, mbw = ry.shape[1] // 2, ry.shape[2] // 2
        mv_arr = np.zeros((f, mbh, mbw, 2), np.int8)
        itypes = np.zeros(f, np.int8)
        for i, mv in enumerate(mvs):
            if mv is not None:
                mv_arr[i] = mv
            else:
                itypes[i] = 1  # no vectors → intra frame (flat-128 pred)
        oy, ocb, ocr = fvc_mc_decode_chunk(
            ry, rcb, rcr, jnp.asarray(mv_arr), jnp.asarray(itypes), qy, qc,
            search_range=int(search_range), subpel=subpel, planar=planar)
        rgb = np.asarray(_i420_frames_to_rgb(oy, ocb, ocr))
        return [rgb[i, :h, :w] for i in range(f)]

    def _reconstruct_mc_b(self, planes, mvs, types, qy, qc, h: int, w: int,
                          search_range: int = 7, planar: bool = False,
                          qy_b=None, qc_b=None):
        """B-frame chunk reconstruction: anchors through the v2 scan,
        then all B frames in one parallel device pass
        (fvc_mc_decode_chunk_b)."""
        f = len(planes)
        a_idx = [i for i, t in enumerate(types) if t != 2]
        b_idx = [i for i, t in enumerate(types) if t == 2]
        if not a_idx or b_idx[0] < a_idx[0] or b_idx[-1] > a_idx[-1]:
            raise ValueError("B frame without surrounding anchor frames")
        prev_map, next_map = [], []
        for j in b_idx:
            k = max(p for p, a in enumerate(a_idx) if a < j)
            prev_map.append(k)
            next_map.append(k + 1)

        def stk(sel, c):
            return jnp.asarray(np.stack([planes[i][c] for i in sel]))

        mbh = planes[0][0].shape[0] // 2
        mbw = planes[0][0].shape[1] // 2
        a_mv = np.zeros((len(a_idx), mbh, mbw, 2), np.int8)
        a_it = np.zeros(len(a_idx), np.int8)
        for k, i in enumerate(a_idx):
            if mvs[i] is not None:
                a_mv[k] = mvs[i]
            else:
                a_it[k] = 1  # no vectors → intra anchor
        b_fwd = np.stack([mvs[i][0] for i in b_idx])
        b_bwd = np.stack([mvs[i][1] for i in b_idx])
        b_modes = np.stack([mvs[i][2] for i in b_idx])
        (ay, acb, acr), (by, bcb, bcr) = fvc_mc_decode_chunk_b(
            stk(a_idx, 0), stk(a_idx, 1), stk(a_idx, 2),
            jnp.asarray(a_mv), jnp.asarray(a_it),
            stk(b_idx, 0), stk(b_idx, 1), stk(b_idx, 2),
            jnp.asarray(b_fwd), jnp.asarray(b_bwd), jnp.asarray(b_modes),
            jnp.asarray(prev_map), jnp.asarray(next_map), qy, qc,
            search_range=int(search_range), planar=planar,
            qy_b=qy_b, qc_b=qc_b)
        perm = np.argsort(np.asarray(a_idx + b_idx))
        oy = jnp.concatenate([ay, by], axis=0)[perm]
        ocb = jnp.concatenate([acb, bcb], axis=0)[perm]
        ocr = jnp.concatenate([acr, bcr], axis=0)[perm]
        rgb = np.asarray(_i420_frames_to_rgb(oy, ocb, ocr))
        return [rgb[i, :h, :w] for i in range(f)]

    def _reconstruct_mc_b_np(self, planes, mvs, types, qy, qc, h: int,
                             w: int, search_range: int = 7,
                             planar: bool = False, qy_b=None, qc_b=None):
        """Test-only numpy reference for B-frame reconstruction (two
        passes: anchors chained, then each B frame from its anchor
        pair). ``planar`` must match header flags bit 3."""
        from .ops.colorspace import i420_to_rgb
        if qy_b is None:
            qy_b = qy
        if qc_b is None:
            qc_b = qc
        f = len(planes)
        a_idx = [i for i, t in enumerate(types) if t != 2]
        rec = {}
        prev = None
        for i in a_idx:
            yq, cbq, crq = planes[i]
            ry = np.asarray(_plane_from_coefs(jnp.asarray(yq), qy,
                                              planar=planar))
            rcb = np.asarray(_plane_from_coefs(jnp.asarray(cbq), qc,
                                               planar=planar))
            rcr = np.asarray(_plane_from_coefs(jnp.asarray(crq), qc,
                                               planar=planar))
            if prev is None or mvs[i] is None:
                py = pcb = pcr = 128.0
            else:
                py = _mc_np(prev[0], mvs[i], 16, chroma=False)
                pcb = _mc_np(prev[1], mvs[i], 8, chroma=True)
                pcr = _mc_np(prev[2], mvs[i], 8, chroma=True)
            prev = (np.clip(py + ry, 0.0, 255.0),
                    np.clip(pcb + rcb, 0.0, 255.0),
                    np.clip(pcr + rcr, 0.0, 255.0))
            rec[i] = prev
        out = []
        for i in range(f):
            if types[i] != 2:
                ry_, rcb_, rcr_ = rec[i]
            else:
                pa = max(a for a in a_idx if a < i)
                na = min(a for a in a_idx if a > i)
                fwd, bwd, modes = mvs[i]
                yq, cbq, crq = planes[i]
                ry = np.asarray(_plane_from_coefs(jnp.asarray(yq), qy_b,
                                                  planar=planar))
                rcb = np.asarray(_plane_from_coefs(jnp.asarray(cbq), qc_b,
                                                   planar=planar))
                rcr = np.asarray(_plane_from_coefs(jnp.asarray(crq), qc_b,
                                                   planar=planar))
                pf = _mc_np(rec[pa][0], fwd, 16, chroma=False)
                pb = _mc_np(rec[na][0], bwd, 16, chroma=False)
                mpx = np.repeat(np.repeat(modes, 16, 0), 16, 1)
                py = np.where(mpx == 0, (pf + pb) * np.float32(0.5),
                              np.where(mpx == 1, pf,
                                       np.where(mpx == 2, pb,
                                                np.float32(128.0))))
                mpc = np.repeat(np.repeat(modes, 8, 0), 8, 1)

                def sel_c(plane_idx):
                    fc = _mc_np(rec[pa][plane_idx], fwd, 8, chroma=True)
                    bc = _mc_np(rec[na][plane_idx], bwd, 8, chroma=True)
                    return np.where(
                        mpc == 0, (fc + bc) * np.float32(0.5),
                        np.where(mpc == 1, fc,
                                 np.where(mpc == 2, bc, np.float32(128.0))))

                ry_ = np.clip(py + ry, 0.0, 255.0)
                rcb_ = np.clip(sel_c(1) + rcb, 0.0, 255.0)
                rcr_ = np.clip(sel_c(2) + rcr, 0.0, 255.0)
            rgb = np.asarray(i420_to_rgb(jnp.asarray(ry_),
                                         jnp.asarray(rcb_),
                                         jnp.asarray(rcr_)))
            out.append(np.clip(rgb + 0.5, 0, 255).astype(np.uint8)[:h, :w])
        return out

    def _reconstruct_mc_np(self, planes, mvs, qy, qc, h: int, w: int,
                           subpel: bool = False, planar: bool = False):
        """Test-only reference reconstruction. ``planar`` must match the
        stream's header flags bit 3 (the in-loop DCT formulation) or the
        P-chain drifts from the encoder's in-loop state — the same
        contract FvcDecoder honors via ``decode_chunk``."""
        from .ops.colorspace import i420_to_rgb
        rec_y = rec_cb = rec_cr = None
        out = []
        for i, (yq, cbq, crq) in enumerate(planes):
            ry = np.asarray(_plane_from_coefs(jnp.asarray(yq), qy, planar))
            rcb = np.asarray(_plane_from_coefs(jnp.asarray(cbq), qc, planar))
            rcr = np.asarray(_plane_from_coefs(jnp.asarray(crq), qc, planar))
            if i == 0 or mvs[i] is None:
                py = pcb = pcr = 128.0
            else:
                mc = _mc_np_subpel if subpel else _mc_np
                py = mc(rec_y, mvs[i], 16, chroma=False)
                pcb = mc(rec_cb, mvs[i], 8, chroma=True)
                pcr = mc(rec_cr, mvs[i], 8, chroma=True)
            rec_y = np.clip(py + ry, 0.0, 255.0)
            rec_cb = np.clip(pcb + rcb, 0.0, 255.0)
            rec_cr = np.clip(pcr + rcr, 0.0, 255.0)
            rgb = np.asarray(i420_to_rgb(jnp.asarray(rec_y),
                                         jnp.asarray(rec_cb),
                                         jnp.asarray(rec_cr)))
            out.append(np.clip(rgb + 0.5, 0, 255).astype(np.uint8)[:h, :w])
        return out

    def split_stream(self, data: bytes) -> List[bytes]:
        """Walk a concatenated stream into per-chunk byte slices (cheap
        header walk; raises ValueError on corrupt boundaries)."""
        chunks = []
        off = 0
        while off < len(data):
            if len(data) - off < 12 or data[off:off + 4] != MAGIC:
                raise ValueError(f"bad or truncated chunk boundary at {off}")
            ver, cflags, w, h, _, f = struct.unpack(">BBHHBB",
                                                    data[off + 4:off + 12])
            end = off + (13 if ver >= 2 else 12)
            if cflags & 16:
                end += 4  # explicit coded-size extension
            if cflags & 32:
                end += 1  # B-frame bquality extension
            hdr = 7 if ver >= 2 else 5
            for _ in range(f):
                if len(data) - end < hdr:
                    raise ValueError(f"truncated frame header at {end}")
                if ver >= 2:
                    _, mv_len, plen = struct.unpack(">BHI", data[end:end + 7])
                    end += 7 + mv_len + plen
                else:
                    _, plen = struct.unpack(">BI", data[end:end + 5])
                    end += 5 + plen
            if end > len(data):
                raise ValueError("truncated chunk payload")
            chunks.append(data[off:end])
            off = end
        return chunks

    def decode_stream(self, data: bytes, parallel: bool = True) -> np.ndarray:
        """Concatenated chunks → all frames in order (the stitch reader).

        Chunks are independently decodable by construction (forced I frame
        at every chunk start), so they decode concurrently — the decode-side
        mirror of hype's parallelism; the host C++ scan decoder releases
        the GIL. Strict chunk order is preserved in the output."""
        chunks = self.split_stream(data)
        if parallel and len(chunks) > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=min(8, len(chunks))) as pool:
                out = list(pool.map(lambda c: self.decode_chunk(c)[0],
                                    chunks))
        else:
            out = [self.decode_chunk(c)[0] for c in chunks]
        return np.concatenate(out, axis=0)


@register
class FvcEnc(VideoEncoder):
    """fvcenc — GOP codec element. Batches each hype chunk into one device
    dispatch; ForceKeyUnit (chunk start) begins a new chunk with an I
    frame."""

    FACTORY = "fvcenc"
    SINK_CAPS = "video/x-raw, format=RGB"
    SRC_CAPS = "video/x-fvc"
    PROPERTIES = [
        PropertySpec("quality", 85),
        PropertySpec("gop-size", 8, "frames per chunk when not driven by "
                                    "hype scene events"),
        PropertySpec("motion", False, "v2 hybrid codec: motion-compensated "
                                      "prediction with in-loop recon"),
        PropertySpec("search-range", 7, "motion full-search window (±px)"),
        PropertySpec("engine", "auto", "auto | device | host entropy coding"),
        PropertySpec("search", "full", "full | hier motion estimation "
                                       "(hier = coarse-to-fine, ~7x fewer "
                                       "whole-frame passes)"),
        PropertySpec("subpel", False, "half-pel motion refinement + bilinear "
                                     "compensation"),
        PropertySpec("bframes", 0, "B frames between anchors (motion mode "
                                   "only): bidirectional per-macroblock "
                                   "prediction from the surrounding "
                                   "reconstructed anchors — non-reference "
                                   "frames encoded in one parallel device "
                                   "pass"),
        PropertySpec("bitrate", 0, "target bits/sec; 0 = constant quality. "
                                   "Per-chunk log-proportional quality "
                                   "controller (the rate-control role the "
                                   "reference delegates to x264)"),
        PropertySpec("segmented", "auto", "segment bitstream layout for the "
                     "entropy stage (byte-identical output). auto = the "
                     "platform default (flutpu.platform); true/false force "
                     "either layout"),
    ]

    _RC_MIN_Q, _RC_MAX_Q = 10, 97

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._encoders: dict = {}
        self._pending: List[Buffer] = []
        self._chunk_gop: Optional[int] = None
        self._rc_quality: Optional[float] = None

    def _enc(self, quality: Optional[int] = None) -> FvcEncoder:
        q = int(self.get_property("quality")) if quality is None else quality
        enc = self._encoders.get(q)
        if enc is None:
            enc = self._encoders[q] = FvcEncoder(
                q,
                motion=bool(self.get_property("motion")),
                search_range=int(self.get_property("search-range")),
                engine=str(self.get_property("engine")),
                hier=str(self.get_property("search")) == "hier",
                subpel=bool(self.get_property("subpel")),
                segmented=segmented_property(
                    self.get_property("segmented")),
                bframes=int(self.get_property("bframes")))
        return enc

    def set_format(self, caps: Caps):
        fields = {k: v for k, v in caps.fields.items()
                  if k in ("width", "height", "framerate")}
        return Caps.new("video/x-fvc", **fields)

    def prewarm(self, caps=None) -> bool:
        """Compile the chunk program for ``caps``' geometry ahead of an
        injectbin swap-in (see Element.prewarm)."""
        if caps is None:
            return False
        w, h = caps.get("width"), caps.get("height")
        if not w or not h:
            return False
        gop = self._chunk_gop or int(self.get_property("gop-size"))
        frames = np.zeros((gop, int(h), int(w), 3), np.uint8)
        self._enc().encode_chunk(frames)
        return True

    def encode_frame(self, buf: Buffer, keyframe: bool) -> Optional[Buffer]:
        if keyframe and self._pending:
            self._flush_chunk()  # new sync point closes the open chunk
        self._pending.append(buf)
        target = self._chunk_gop or int(self.get_property("gop-size"))
        if len(self._pending) >= target:
            self._flush_chunk()
        return None

    def on_custom_event(self, event) -> None:
        from ..hype.events import SceneNewEvent
        scene = SceneNewEvent.parse(event)
        if scene is not None:
            self._chunk_gop = scene.gop_size

    def drain(self) -> None:
        self._flush_chunk()

    def reset(self) -> None:
        self._pending = []

    def finish(self):
        self._flush_chunk()
        return []

    def _chunk_target_bytes(self, batch: List[Buffer]) -> Optional[int]:
        bitrate = int(self.get_property("bitrate"))
        if bitrate <= 0:
            return None
        dur_ns = sum((b.duration or 0) for b in batch)
        if dur_ns <= 0 and self.input_caps is not None:
            fr = self.input_caps.get("framerate")
            if fr:
                dur_ns = int(len(batch) * 1e9 * fr.denominator / fr.numerator)
        if dur_ns <= 0:
            dur_ns = int(len(batch) * 1e9 / 30)
        return max(1, int(bitrate / 8 * dur_ns / 1e9))

    def _flush_chunk(self) -> None:
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        frames = np.stack([np.asarray(b.data) for b in batch])
        target = self._chunk_target_bytes(batch)
        if target is None:
            chunk = self._enc().encode_chunk(frames)
        else:
            # rate control: log-proportional per-chunk quality adaptation,
            # one in-chunk retry when far over budget
            if self._rc_quality is None:
                self._rc_quality = float(self.get_property("quality"))
            q = int(round(self._rc_quality))
            chunk = self._enc(q).encode_chunk(frames)
            if len(chunk) > target * 1.3:
                q2 = max(self._RC_MIN_Q,
                         q - int(round(12 * np.log2(len(chunk) / target))))
                if q2 < q:
                    chunk = self._enc(q2).encode_chunk(frames)
                    q = q2
            ratio = len(chunk) / target
            self._rc_quality = float(np.clip(
                q - 12 * np.log2(max(ratio, 1e-6)),
                self._RC_MIN_Q, self._RC_MAX_Q))
        first = batch[0]
        last = batch[-1]
        duration = None
        if first.pts is not None and last.pts is not None:
            duration = last.pts - first.pts + (last.duration or 0)
        out = Buffer(chunk, pts=first.pts, dts=first.dts, duration=duration,
                     offset=first.offset)
        out.meta["n_frames"] = len(batch)
        out.meta["frame_pts"] = [b.pts for b in batch]
        self.srcpad.push(out)
