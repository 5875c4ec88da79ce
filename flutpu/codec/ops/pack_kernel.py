"""Pallas kernel for the Huffman bit packer, compiled through Triton.

The plain packer (``entropy._pack_segments_scan``) is a ``lax.scan`` over
the 65 merged slots of a block that carries a (B, words) uint32 buffer
through device memory on every step: for one 16-frame 1080p dispatch
(B = 783,360 blocks) that is about 200 MB per step and 26 GB per
dispatch. This kernel reads the coefficients once and writes only the
finished words.

Design (one lane per segment, no state across programs):

- a program owns ``TILE`` consecutive segments; a segment is ``seg_g``
  consecutive MCU-ordered blocks packed into one contiguous bit string
  (the per-block layout is ``seg_g = 1``);
- each lane keeps its bit offset and its pending partial word in
  registers and walks its blocks slot by slot. A slot is at most 59 bits,
  so an append completes at most two words, which the lane stores at
  once; the pending word is stored after the last block;
- each program computes its own loop bound per block position (the last
  nonzero AC coefficient over its lanes), so smooth content skips the
  zero tail of the zigzag order;
- the Huffman tables are small inputs read by gathers.

The output buffer is a zeroed array aliased to the output, so words a lane
never writes stay zero (the concat stage reads one word past a block's
last bit). Words past ``n_words`` are dropped; the bit count still counts
them, which is how callers detect a capacity overflow.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ... import platform

TILE = 128        # lanes (segments) per program
NUM_WARPS = 4     # one lane per thread


@functools.lru_cache()
def _tables():
    """(dc (32,), ac (512,)) int32 entries ``len << 16 | code``, luma
    first then chroma; DC indexed by size (0..11), AC by run << 4 | size."""
    from .entropy import _device_tables
    dc_code, dc_len, ac_code, ac_len = _device_tables()
    dc = np.zeros((2, 16), np.int32)
    dc[:, :12] = (dc_len[:, :12] << 16) | dc_code[:, :12]
    ac = (ac_len << 16) | ac_code
    return dc.reshape(-1), ac.astype(np.int32).reshape(-1)


def _kernel(zz_ref, comp_ref, dc_ref, ac_ref, zeros_ref, buf_ref, nbits_ref,
            *, seg_g: int, n_words: int):
    del zeros_ref   # aliased with buf_ref: unwritten words stay zero
    from .entropy import _magnitude, _place96
    tile = nbits_ref.shape[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (tile,), 0)
    rows = jax.lax.broadcasted_iota(jnp.int32, (64, tile), 0)
    zero_i = jnp.zeros((tile,), jnp.int32)
    zero_u = jnp.zeros((tile,), jnp.uint32)

    def store(widx, val, ok):
        ok = ok & (widx < n_words)
        plgpu.store(buf_ref.at[lane, jnp.minimum(widx, n_words - 1)], val,
                    mask=ok)

    def emit(off, cur, slen, hi, lo):
        """Append the low ``slen`` bits of hi:lo at bit ``off``."""
        c0, c1, c2 = _place96(hi, lo, slen, off & 31)
        active = slen > 0
        c0 = jnp.where(active, c0, zero_u) | cur
        c1 = jnp.where(active, c1, zero_u)
        c2 = jnp.where(active, c2, zero_u)
        w0 = off >> 5
        new = off + slen
        nfull = (new >> 5) - w0
        store(w0, c0, nfull >= 1)
        store(w0 + 1, c1, nfull >= 2)
        cur = jnp.where(nfull == 0, c0, jnp.where(nfull == 1, c1, c2))
        return new, cur

    def block(g, carry):
        off, cur = carry
        comp = comp_ref[g, :]
        live = comp >= 0
        chroma = jnp.where(comp == 1, 1, 0)
        blk = zz_ref[pl.ds(g * 64, 64), :]
        last = jnp.max(jnp.max(jnp.where(blk != 0, rows, 0), axis=0))

        # DC slot
        diff = zz_ref[g * 64, :]
        dsize = _magnitude(diff, 12)
        entry = dc_ref[chroma * 16 + dsize]
        extra = jnp.where(diff < 0, diff + (1 << dsize) - 1, diff)
        slen = jnp.where(live, (entry >> 16) + dsize, 0)
        lo = (((entry & 0xFFFF) << dsize) | (extra & ((1 << dsize) - 1))) \
            .astype(jnp.uint32)
        off, cur = emit(off, cur, slen, zero_u, lo)

        zrl = ac_ref[chroma * 256 + 0xF0]
        zrl_len = zrl >> 16
        zrl_code = zrl & 0xFFFF

        # AC slots: up to two ZRLs | a third ZRL | code + extra bits,
        # merged into one 64-bit slot per position (entropy._slot_pieces)
        def ac(s, c):
            off, cur, prev = c
            v = zz_ref[g * 64 + s, :]
            nz = (v != 0) & live
            run = s - prev - 1
            asize = _magnitude(v, 11)
            e = ac_ref[chroma * 256 + ((run & 15) << 4) + asize]
            aextra = jnp.where(v < 0, v + (1 << asize) - 1, v)
            zcount = jnp.where(nz, run >> 4, 0)
            c2 = jnp.minimum(zcount, 2)
            la = c2 * zrl_len
            va = jnp.where(c2 == 2, (zrl_code << zrl_len) | zrl_code,
                           jnp.where(c2 == 1, zrl_code, 0)).astype(jnp.uint32)
            lb = jnp.where(zcount >= 3, zrl_len, 0)
            vb = jnp.where(lb > 0, zrl_code, 0).astype(jnp.uint32)
            lc = jnp.where(nz, (e >> 16) + asize, 0)
            vc = jnp.where(nz, ((e & 0xFFFF) << asize)
                           | (aextra & ((1 << asize) - 1)), 0) \
                .astype(jnp.uint32)
            sh = lb.astype(jnp.uint32)
            hi = jnp.where(sh > 0, va >> ((32 - sh) & 31), zero_u)
            lo = (va << sh) | vb
            sh = lc.astype(jnp.uint32)
            hi = (hi << sh) | jnp.where(sh > 0, lo >> ((32 - sh) & 31),
                                        zero_u)
            lo = (lo << sh) | vc
            off, cur = emit(off, cur, la + lb + lc, hi, lo)
            return off, cur, jnp.where(nz, s, prev)

        off, cur, prev = jax.lax.fori_loop(1, last + 1, ac,
                                           (off, cur, zero_i))

        # EOB unless coefficient 63 was the last one coded
        eob = ac_ref[chroma * 256]
        need = live & (prev < 63)
        slen = jnp.where(need, eob >> 16, 0)
        lo = jnp.where(need, eob & 0xFFFF, 0).astype(jnp.uint32)
        return emit(off, cur, slen, zero_u, lo)

    off, cur = jax.lax.fori_loop(0, seg_g, block, (zero_i, zero_u))
    store(off >> 5, cur, (off & 31) != 0)
    nbits_ref[...] = off


@functools.partial(jax.jit, static_argnames=("seg_g", "n_words"))
def pack_segments(zz: jax.Array, comp: jax.Array, seg_g: int = 1,
                  n_words: int = 64):
    """Pack Huffman-coded blocks into segments.

    zz: (B, 64) int32 DC-differenced, MCU-ordered zigzag coefficients;
    comp: (B,) int32 component class (0 luma, 1 chroma, -1 a padding block
    that emits no bits). B must be a multiple of ``seg_g``. Returns
    (buf (S, n_words) uint32 MSB-first, nbits (S,) int32) with
    S = B / seg_g: blocks [s*seg_g, (s+1)*seg_g) concatenate into segment
    s. Bit-identical to ``entropy._pack_segments_scan``."""
    b = zz.shape[0]
    assert b % seg_g == 0, (b, seg_g)
    s_count = b // seg_g
    s_pad = -(-s_count // TILE) * TILE
    zz_t = zz.reshape(s_count, seg_g * 64).T
    comp_t = comp.reshape(s_count, seg_g).T
    if s_pad != s_count:
        zz_t = jnp.pad(zz_t, ((0, 0), (0, s_pad - s_count)))
        comp_t = jnp.pad(comp_t, ((0, 0), (0, s_pad - s_count)),
                         constant_values=-1)
    dc, ac = _tables()
    kernel = functools.partial(_kernel, seg_g=seg_g, n_words=n_words)
    buf, nbits = pl.pallas_call(kernel, backend="triton",
        grid=(s_pad // TILE,),
        in_specs=[
            pl.BlockSpec((seg_g * 64, TILE), lambda i: (0, i)),
            pl.BlockSpec((seg_g, TILE), lambda i: (0, i)),
            pl.BlockSpec((dc.size,), lambda i: (0,)),
            pl.BlockSpec((ac.size,), lambda i: (0,)),
            pl.BlockSpec((TILE, n_words), lambda i: (i, 0)),
        ],
        out_specs=[
            pl.BlockSpec((TILE, n_words), lambda i: (i, 0)),
            pl.BlockSpec((TILE,), lambda i: (i,)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((s_pad, n_words), jnp.uint32),
            jax.ShapeDtypeStruct((s_pad,), jnp.int32),
        ],
        input_output_aliases={4: 0},
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=platform.interpret_kernels(),
        name="flutpu_pack_segments",
    )(zz_t, comp_t, jnp.asarray(dc), jnp.asarray(ac),
      jnp.zeros((s_pad, n_words), jnp.uint32))
    return buf[:s_count], nbits[:s_count]
