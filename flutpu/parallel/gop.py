"""Sharded GOP encode — the multi-chip encode step.

``encode_chunks_sharded`` is the framework's SPMD program: a batch of C GOP
chunks (one per chip along the ``chunk`` mesh axis, optionally row-striped
along ``spatial``) goes through convert → 4:2:0 → DCT → quantize → zigzag as
one jitted shard_map. No collectives are needed for the encode itself —
chunk independence is the design (forced keyframes at chunk starts, see
flutpu.hype) — so the program scales linearly across devices and wall-clock
equals the slowest chunk, matching the reference's structural property across
devices instead of threads (reference hype/src/outputselector round-robin
scatter).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..codec.ops.colorspace import rgb_to_i420


def _encode_block(frames: jax.Array, qy: jax.Array, qc: jax.Array):
    """Local (per-shard) encode: (..., H, W, 3) uint8 → zigzagged int16
    coefficient planes. H, W must be multiples of 16. The DCT formulation
    is the platform's (jpeg._plane_to_zz)."""
    from ..codec.jpeg import _plane_to_zz
    x = frames.astype(jnp.float32)
    y, cb, cr = rgb_to_i420(x)
    return _plane_to_zz(y, qy), _plane_to_zz(cb, qc), _plane_to_zz(cr, qc)


def _encode_block_planes(r: jax.Array, g: jax.Array, b: jax.Array,
                         qy: jax.Array, qc: jax.Array):
    """Channel-planar _encode_block: (..., F, H, W) uint8 per channel,
    through the planar front end (jpeg._planes_front_end)."""
    from ..codec.jpeg import _planes_front_end
    h, w = r.shape[-2], r.shape[-1]

    def one(rr, gg, bb):
        return _planes_front_end(rr, gg, bb, qy, qc, pad_h=h, pad_w=w,
                                 subsample=True)

    if r.ndim == 4:   # (C_local, F, H, W): per-chunk within the shard
        return jax.vmap(one)(r, g, b)
    return one(r, g, b)


@functools.partial(jax.jit, static_argnames=("mesh", "spatial"))
def encode_chunks_sharded(frames, qy: jax.Array, qc: jax.Array,
                          mesh: Mesh, spatial: bool = False):
    """(C, F, H, W, 3) uint8 — or a channel-planar (r, g, b) tuple of
    (C, F, H, W) planes — → (y, cb, cr) int16 (C, F, BH, BW, 64).

    C is sharded over the ``chunk`` mesh axis; with ``spatial`` True, H is
    additionally striped over the ``spatial`` axis (stripe height must stay a
    multiple of 16 so 4:2:0 macroblocks remain shard-local → zero halo).
    Planar input is preferred: the interleaved layout never exists on the
    device.
    """
    planar = isinstance(frames, (tuple, list))
    if spatial:
        plane_spec = P("chunk", None, "spatial", None)
        in_spec = P("chunk", None, "spatial", None, None)
        out_spec = (P("chunk", None, "spatial"),) * 3
    else:
        plane_spec = P("chunk", None, None, None)
        in_spec = P("chunk", None, None, None, None)
        out_spec = (P("chunk", None, None),) * 3

    if planar:
        fn = shard_map(
            _encode_block_planes, mesh=mesh,
            in_specs=(plane_spec,) * 3 + (P(), P()),
            out_specs=out_spec)
        r, g, b = frames
        return fn(r, g, b, qy, qc)
    fn = shard_map(
        _encode_block, mesh=mesh,
        in_specs=(in_spec, P(), P()),
        out_specs=out_spec)
    return fn(frames, qy, qc)


def encode_chunks_single(frames: jax.Array, qy: jax.Array, qc: jax.Array):
    """Unsharded variant (single chip / tests)."""
    return jax.jit(_encode_block)(frames, qy, qc)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "motion", "search_range",
                                    "hier", "subpel", "spatial", "bframes"))
def fvc_chunks_sharded(frames, qy: jax.Array, qc: jax.Array,
                       mesh: Mesh, motion: bool = False,
                       search_range: int = 7, hier: bool = False,
                       subpel: bool = False, spatial: bool = False,
                       bframes: int = 0, qy_b=None, qc_b=None):
    """FVC GOP coding as an SPMD program: (C, F, H, W, 3) uint8 — or a
    channel-planar (r, g, b) tuple of (C, F, H, W) planes (preferred) —
    C sharded over the ``chunk`` mesh axis, each shard running an
    independent codec instance (frame 0 of every chunk is an I frame —
    the forced-keyframe contract that makes chunks independent, reference
    hype/src/outputselector/imp.rs:39-43). Zero collectives in the chunk
    direction.

    ``spatial`` (motion mode): additionally row-stripe each
    frame over the ``spatial`` mesh axis — the sequence-parallel path for
    a SINGLE high-resolution stream whose latency budget cannot wait for
    a whole chunk per device. Motion search/compensation exchange ±r edge
    rows with ring-neighbor ppermutes (NCCL on the card) and the frame-type
    decision reduces via psum (ops/motion.py striped formulations,
    bit-identical per pixel to the unsharded codec). Stripe height must
    be a multiple of 16.

    Returns (ry, rcb, rcr) int16 residual planes, plus mvs int8 and
    itypes int8 when ``motion`` (the v2 hybrid loop per chunk). The
    in-loop DCT formulation is the platform's (flutpu.platform.dct_planar),
    which the caller writes into the header (flags bit 3). With
    ``bframes`` > 0 (motion mode) each chunk runs the bidirectional
    structure instead and the return is
    (ry, rcb, rcr, fwd, bwd, modes, ftypes) — zero collectives in the
    chunk direction (B-frame anchors are chunk-local); composed with
    ``spatial``, both the anchor scan and the B pass stripe with halo
    ppermutes like the P path. H/W must be multiples of 16 (pad
    upstream).
    """
    from ..codec.fvc import (fvc_mc_encode_chunk, fvc_mc_encode_chunk_b,
                             fvc_residuals)

    if bframes and (not motion or subpel):
        raise ValueError("bframes needs motion=True and does not "
                         "support subpel")

    planar = isinstance(frames, (tuple, list))
    shp = frames[0].shape if planar else frames.shape
    h, w = shp[2], shp[3]

    n_sp = dict(zip(mesh.axis_names, mesh.devices.shape)).get("spatial", 1)
    sp_axis = "spatial" if spatial else None
    h_local = h // n_sp if spatial else h

    # per-shard locals: each takes the shard's frames — one interleaved
    # array, or three channel planes (*fr) — as leading operands
    if planar:
        def local_v1(r, g, b, qy, qc):
            coefs = _encode_block_planes(r, g, b, qy, qc)
            return jax.vmap(fvc_residuals)(*coefs)
    else:
        def local_v1(fr, qy, qc):
            coefs = _encode_block(fr, qy, qc)
            return jax.vmap(fvc_residuals)(*coefs)

    def local_mc(*args):
        fr = args[:3] if planar else args[0]
        qy, qc = args[-2:]

        def one(*chunk):
            return fvc_mc_encode_chunk(
                chunk if planar else chunk[0], qy, qc, pad_h=h_local,
                pad_w=w, search_range=search_range, hier=hier,
                subpel=subpel, spatial_axis=sp_axis, n_spatial=n_sp)
        return jax.vmap(one)(*(fr if planar else (fr,)))

    def local_mc_b(*args):
        # qy_b/qc_b enter as explicit operands (shard_map cannot close
        # over traced arrays)
        fr = args[:3] if planar else args[0]
        qy, qc, qyb, qcb = args[-4:]

        def one(*chunk):
            return fvc_mc_encode_chunk_b(
                chunk if planar else chunk[0], qy, qc, pad_h=h_local,
                pad_w=w, search_range=search_range, bframes=bframes,
                hier=hier, qy_b=qyb, qc_b=qcb, spatial_axis=sp_axis,
                n_spatial=n_sp)
        return jax.vmap(one)(*(fr if planar else (fr,)))

    # Per-chunk codecs touch no cross-shard state the specs don't name.
    if spatial:
        in_spec = P("chunk", None, "spatial", None, None)
        plane_spec = P("chunk", None, "spatial", None)
        if motion:
            # itypes are psum-identical across stripes → replicated over
            # 'spatial'; planes/mvs are row-striped
            out_specs = (P("chunk", None, "spatial"),) * 3 \
                + (P("chunk", None, "spatial"), P("chunk"))
        else:
            # v1 (temporal coefficient deltas) is blockwise-local: stripes
            # need no halos at all
            out_specs = (P("chunk", None, "spatial"),) * 3
    else:
        in_spec = P("chunk", None, None, None, None)
        plane_spec = P("chunk", None, None, None)
        out_specs = (P("chunk"),) * (5 if motion else 3)
    frame_specs = (plane_spec,) * 3 if planar else (in_spec,)
    frame_args = tuple(frames) if planar else (frames,)
    if bframes:
        if spatial:
            # residuals stripe on the block-row axis, vector/mode fields
            # on the macroblock-row axis; ftypes are psum-identical
            # across stripes → replicated over 'spatial'
            out_specs_b = (P("chunk", None, "spatial"),) * 6 + (P("chunk"),)
        else:
            out_specs_b = (P("chunk"),) * 7
        fn = shard_map(
            local_mc_b, mesh=mesh,
            in_specs=frame_specs + (P(), P(), P(), P()),
            out_specs=out_specs_b)
        return fn(*frame_args, qy, qc,
                  qy if qy_b is None else qy_b,
                  qc if qc_b is None else qc_b)
    fn = shard_map(
        local_mc if motion else local_v1, mesh=mesh,
        in_specs=frame_specs + (P(), P()),
        out_specs=out_specs)
    return fn(*frame_args, qy, qc)
