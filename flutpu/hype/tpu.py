"""tpuhype — the device-mesh GOP-parallel encoder.

Where the ``hype`` bin reproduces the reference's thread-per-branch scatter/
gather (one GStreamer streaming thread per encoder), ``tpuhype`` is the
device-mesh expression of the same contract: C GOP chunks are batched into
one (C, F, H, W, 3) array, encoded by a single SPMD dispatch one chunk per
device over the ``chunk`` mesh axis (flutpu.parallel.gop), and emitted in
strict chunk order (the ordered-gather role of the reference's
scenecollector, reference hype/src/scenecollector/imp.rs:71-99).

Latency note: batching C chunks trades latency for throughput exactly like
the reference's round-robin over C branches — output stalls at most
C*gop_size frames behind input, the same bound as the reference's
SCENE_BUFFER_SIZE queueing.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import platform
from ..codec.base import VideoEncoder
from ..codec.jpeg import (JpegEncoder, encode_scan, jpeg_headers)
from ..core import (Buffer, Caps, PropertySpec, register)
from ..parallel.gop import encode_chunks_sharded
from ..parallel.mesh import make_chunk_mesh


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@register
class TpuHype(VideoEncoder):
    """GOP-parallel MJPEG encoder as one SPMD dispatch, one chunk per device
    over a device mesh."""

    FACTORY = "tpuhype"
    SINK_CAPS = "video/x-raw, format=RGB"
    SRC_CAPS = "image/jpeg"
    PROPERTIES = [
        PropertySpec("gop-size", 8),
        PropertySpec("quality", 85),
        PropertySpec("chunks", 0, "parallel chunks (0 = all local devices)"),
        PropertySpec("spatial", 1, "row-stripe each frame across this many "
                                   "devices (chunk x spatial mesh — for "
                                   "frame sizes too heavy for one device, "
                                   "e.g. 4K). Works for codec=fvc/fvc-motion "
                                   "too: motion exchanges halo rows with "
                                   "ring ppermutes and psum-reduces the "
                                   "frame-type decision (integer-pel full "
                                   "search); streams carry the coded size "
                                   "explicitly (header flags bit 4)"),
        PropertySpec("codec", "jpeg", "jpeg | fvc | fvc-motion: MJPEG "
                                      "per-frame buffers, or FVC GOP chunks "
                                      "(one container buffer per chunk; "
                                      "fvc-motion = v2 hybrid loop — pick "
                                      "by content per docs/GUIDE.md "
                                      "'Choosing a codec' / PERF.md RD "
                                      "table: fvc for static/noisy/"
                                      "subpixel, fvc-motion + bframes for "
                                      "coherent pans)"),
        PropertySpec("search-range", 7, "fvc-motion full-search window"),
        PropertySpec("search", "full", "full | hier fvc-motion estimation"),
        PropertySpec("subpel", False, "half-pel fvc-motion refinement "
                                      "(opt-in quality knob: smaller "
                                      "streams, slower search)"),
        PropertySpec("bframes", 0, "fvc-motion B frames between anchors "
                                   "(chunk-local bidirectional prediction; "
                                   "composes with spatial striping, not "
                                   "with subpel)"),
    ]

    def __init__(self, name: Optional[str] = None, **props):
        super().__init__(name, **props)
        self._frames: List[Buffer] = []
        self._jenc: Optional[JpegEncoder] = None
        self._mesh = None
        self._pool = ThreadPoolExecutor(max_workers=8)
        if str(self.get_property("codec")).startswith("fvc"):
            self.srcpad.template_caps = Caps.from_string("video/x-fvc")

    def _setup(self):
        if self._jenc is None:
            self._jenc = JpegEncoder(quality=int(self.get_property("quality")))
        if self._mesh is None:
            spatial = max(1, int(self.get_property("spatial")))
            if spatial > 1:
                from ..parallel.mesh import make_chunk_spatial_mesh
                n = int(self.get_property("chunks")) or \
                    (len(jax.devices()) // spatial)
                self._mesh = make_chunk_spatial_mesh(n, spatial)
            else:
                n = int(self.get_property("chunks")) or len(jax.devices())
                self._mesh = make_chunk_mesh(n)
        return self._jenc, self._mesh

    def set_format(self, caps: Caps):
        fields = {k: v for k, v in caps.fields.items()
                  if k in ("width", "height", "framerate")}
        codec = str(self.get_property("codec"))
        if codec.startswith("fvc"):
            return Caps.new("video/x-fvc", **fields)
        return Caps.new("image/jpeg", parsed=True, **fields)

    @property
    def _batch_target(self) -> int:
        spatial = max(1, int(self.get_property("spatial")))
        n = int(self.get_property("chunks")) or \
            max(1, len(jax.devices()) // spatial)
        return n * int(self.get_property("gop-size"))

    def encode_frame(self, buf: Buffer, keyframe: bool) -> Optional[Buffer]:
        self._frames.append(buf)
        if len(self._frames) >= self._batch_target:
            self._flush()
        return None

    def drain(self) -> None:
        self._flush()

    def reset(self) -> None:
        self._frames = []

    def finish(self):
        self._flush()
        return []

    def _flush(self) -> None:
        if not self._frames:
            return
        batch, self._frames = self._frames, []
        jenc, mesh = self._setup()
        gop = int(self.get_property("gop-size"))
        spatial = max(1, int(self.get_property("spatial")))
        n_chunks = mesh.devices.size // spatial
        frames = np.stack([np.asarray(b.data) for b in batch])
        n, h, w, _ = frames.shape
        total = n_chunks * gop
        if n < total:  # pad the tail batch (outputs dropped below)
            frames = np.concatenate(
                [frames, np.repeat(frames[-1:], total - n, axis=0)], axis=0)
        # spatial striping needs stripe heights that are macroblock
        # multiples: pad H to 16*spatial
        ph, pw = _pad_to(h, 16 * spatial), _pad_to(w, 16)
        if (ph, pw) != (h, w):
            frames = np.pad(frames, ((0, 0), (0, ph - h), (0, pw - w), (0, 0)),
                            mode="edge")
        chunks = frames.reshape(n_chunks, gop, ph, pw, 3)
        codec = str(self.get_property("codec"))
        if codec.startswith("fvc"):
            self._flush_fvc(batch, chunks, n, h, w, jenc, mesh, spatial,
                            gop, motion=codec == "fvc-motion")
            return
        # channel-planar upload: same bytes, and the interleaved layout
        # never exists on the device (parallel.gop._encode_block_planes)
        yq, cbq, crq = encode_chunks_sharded(
            tuple(jnp.asarray(np.ascontiguousarray(chunks[..., c]))
                  for c in range(3)),
            jnp.asarray(jenc.qy), jnp.asarray(jenc.qc),
            mesh=mesh, spatial=spatial > 1)
        mh = _pad_to(h, 16)
        if ph != mh:
            # spatial striping padded H to 16*spatial — beyond the
            # standard MCU padding a JPEG's SOF height implies. FVC
            # signals the coded size explicitly (flags bit 4); JPEG has
            # no such channel, so crop the coefficient planes back to
            # the standard MCU rows: the scan then carries exactly the
            # blocks an unstriped encode would (byte-identical output,
            # decodable by any baseline decoder). The slice is an eager
            # op on the sharded arrays (the pad rows live in the LAST
            # stripe, so an in-shard_map crop would need uneven shard
            # shapes — not expressible in SPMD); it shares the eager
            # boundary the reshape before _entropy already pays, and
            # only over-padded heights (h % (16*spatial) != 0) take it
            yq = yq[:, :, :mh // 8]
            cbq = cbq[:, :, :mh // 16]
            crq = crq[:, :, :mh // 16]
        hdr = jpeg_headers(h, w, jenc.qy, jenc.qc, True)
        payloads = self._entropy(jenc, yq, cbq, crq, hdr)
        for src, data in zip(batch, payloads):
            self.srcpad.push(Buffer(data, pts=src.pts, dts=src.dts,
                                    duration=src.duration, offset=src.offset))

    def _flush_fvc(self, batch, chunks, n, h, w, jenc, mesh, spatial,
                   gop, motion):
        """FVC over the chunk mesh: one independent GOP codec per shard
        (flutpu.parallel.gop.fvc_chunks_sharded), device entropy over the
        whole batch, one container buffer per chunk — the hype contract
        (forced keyframe at every chunk start) expressed as SPMD."""
        import struct
        from ..codec.fvc import MAGIC
        from ..codec.ops.entropy import (encode_gop_scans_combined,
                                         mcu_layout, stuff_and_finalize)
        from ..parallel.gop import fvc_chunks_sharded
        sr = int(self.get_property("search-range"))
        subpel = bool(self.get_property("subpel"))
        bframes = int(self.get_property("bframes")) if motion else 0
        if spatial > 1 and (subpel or
                            str(self.get_property("search")) == "hier"):
            raise ValueError("codec=fvc spatial striping supports "
                             "full-search integer-pel motion (and v1)")
        if bframes and subpel:
            raise ValueError("bframes does not support subpel")
        bquality = max(10, jenc.quality - 8) if bframes else None
        qyb = qcb = None
        if bframes:
            from ..codec.ops.quant import (CHROMA_QTABLE, LUMA_QTABLE,
                                           scale_qtable)
            qyb = jnp.asarray(scale_qtable(LUMA_QTABLE, bquality))
            qcb = jnp.asarray(scale_qtable(CHROMA_QTABLE, bquality))
        out = fvc_chunks_sharded(
            tuple(jnp.asarray(np.ascontiguousarray(chunks[..., ci]))
                  for ci in range(3)),
            jnp.asarray(jenc.qy), jnp.asarray(jenc.qc),
            mesh=mesh, motion=motion, search_range=sr,
            hier=str(self.get_property("search")) == "hier", subpel=subpel,
            spatial=spatial > 1, bframes=bframes, qy_b=qyb, qc_b=qcb)
        ry, rcb, rcr = out[:3]
        if bframes:
            fwd = np.asarray(out[3])
            bwd = np.asarray(out[4])
            modes = np.asarray(out[5])
            itypes = np.asarray(out[6])
            mvs = None
        else:
            fwd = bwd = modes = None
            mvs = np.asarray(out[3]) if motion else None
            itypes = np.asarray(out[4]) if motion else None
        c, f = ry.shape[0], ry.shape[1]
        layout = mcu_layout(ry.shape[3], ry.shape[2],
                            rcb.shape[3], rcb.shape[2], True)
        prefix = min(jenc.PREFIX_WORDS,
                     _pad_to(layout.n_blocks * jenc.CAP_LADDER[-1] // 32,
                             jenc._WORD_BUCKET))
        combined = encode_gop_scans_combined(
            ry.reshape(c * f, *ry.shape[2:]),
            rcb.reshape(c * f, *rcb.shape[2:]),
            rcr.reshape(c * f, *rcr.shape[2:]),
            layout=layout, prefix_words=prefix, use_pallas=jenc.use_pallas)
        arr = np.asarray(combined)
        bits = arr[:, 0].astype(np.int64)
        if (bits > prefix * 32).any():
            raise OverflowError("fvc device entropy cap exceeded")
        payloads = [stuff_and_finalize(arr[i, 1:], int(bits[i]))
                    for i in range(c * f)]
        version = 2 if motion else 1
        cflags = 1 | (2 if motion else 0)  # 4:2:0 | compressed mvs
        if motion and subpel:
            cflags |= 4  # half-pel vectors
        if motion and platform.dct_planar():
            cflags |= 8  # planar in-loop recon: the platform's formulation,
            #              which fvc_chunks_sharded's encode used
        ph, pw = chunks.shape[2], chunks.shape[3]
        # spatial striping pads H to 16*stripes — beyond the minimum
        # macroblock padding the decoder derives from (h, w), so the
        # coded size travels explicitly (flags bit 4)
        coded_ext = (ph, pw) != (_pad_to(h, 16), _pad_to(w, 16))
        if coded_ext:
            cflags |= 16
        if bframes:
            cflags |= 32
        for ci in range(c):
            first = ci * gop
            if first >= n:
                break  # wholly padding
            real = min(gop, n - first)
            if bframes and real < gop:
                # a truncated chunk may end on a B frame whose NEXT anchor
                # was cut (the batched encode used the full-gop structure)
                # — re-encode the tail with the structure of the real
                # count, which always ends on an anchor
                from ..codec.fvc import FvcEncoder
                tail_enc = FvcEncoder(
                    jenc.quality, motion=True, search_range=sr,
                    hier=str(self.get_property("search")) == "hier",
                    bframes=bframes, bquality=bquality)
                tail_frames = np.stack(
                    [np.asarray(b.data) for b in batch[first:first + real]])
                data = tail_enc.encode_chunk(tail_frames)
                src = batch[first]
                last = batch[first + real - 1]
                dur = None
                if src.pts is not None and last.pts is not None:
                    dur = last.pts - src.pts + (last.duration or 0)
                self.srcpad.push(Buffer(data, pts=src.pts, dts=src.dts,
                                        duration=dur, offset=src.offset))
                continue
            parts = [MAGIC, struct.pack(">BBHHBB", version, cflags, w, h,
                                        jenc.quality, real)]
            if motion:
                parts.append(struct.pack(">B", sr))
            if coded_ext:
                parts.append(struct.pack(">HH", pw, ph))
            if bframes:
                parts.append(struct.pack(">B", bquality))
            for fi in range(real):
                payload = payloads[ci * gop + fi]
                it = int(itypes[ci, fi]) if motion else 0
                if motion and it == 2:
                    ftype = 2
                elif motion:
                    ftype = 0 if (fi == 0 or it) else 1
                else:
                    ftype = 0 if fi == 0 else 1
                if motion:
                    import zlib
                    if ftype == 2:
                        mv = zlib.compress(
                            fwd[ci, fi].astype(np.int8).tobytes()
                            + bwd[ci, fi].astype(np.int8).tobytes()
                            + modes[ci, fi].astype(np.int8).tobytes(), 6)
                    elif ftype == 0:
                        mv = b""
                    else:
                        raw = (fwd if bframes else mvs)[ci, fi]
                        mv = zlib.compress(raw.astype(np.int8).tobytes(), 6)
                    parts.append(struct.pack(">BHI", ftype, len(mv),
                                             len(payload)))
                    parts.append(mv)
                else:
                    parts.append(struct.pack(">BI", ftype, len(payload)))
                parts.append(payload)
            src = batch[first]
            last = batch[min(first + real, len(batch)) - 1]
            dur = None
            if src.pts is not None and last.pts is not None:
                dur = last.pts - src.pts + (last.duration or 0)
            self.srcpad.push(Buffer(b"".join(parts), pts=src.pts,
                                    dts=src.dts, duration=dur,
                                    offset=src.offset))

    def _entropy(self, jenc, yq, cbq, crq, hdr):
        """Entropy-code all chunk frames. On the card the bits pack on the
        device (only compressed data is fetched); the host coder serves
        the CPU. ``jenc.segmented`` selects the segment layout (device
        word-aligned segments + host compaction)."""
        c, f = yq.shape[0], yq.shape[1]
        if platform.device_entropy():
            from ..codec.jpeg import _pad_to
            from ..codec.ops.entropy import (compact_segments_finalize,
                                             encode_gop_scans_combined,
                                             encode_gop_scans_segmented,
                                             mcu_layout, stuff_and_finalize)
            layout = mcu_layout(yq.shape[3], yq.shape[2],
                                cbq.shape[3], cbq.shape[2], True)
            prefix = min(jenc.PREFIX_WORDS,
                         _pad_to(layout.n_blocks * jenc.CAP_LADDER[-1] // 32,
                                 jenc._WORD_BUCKET))
            if jenc.segmented:
                n_segs = jenc._n_segs(layout)

                def build(prefix_w, sw_w):
                    p = min(prefix, prefix_w or prefix)
                    return encode_gop_scans_segmented(
                        yq.reshape(c * f, *yq.shape[2:]),
                        cbq.reshape(c * f, *cbq.shape[2:]),
                        crq.reshape(c * f, *crq.shape[2:]),
                        layout=layout, prefix_words=p,
                        seg_words=sw_w, use_pallas=jenc.use_pallas), p, sw_w

                # capacity growth compiles off the streaming thread and is
                # adopted once ready (JpegEncoder._maybe_adopt_or_warm)
                _, sw = jenc._maybe_adopt_or_warm(build)
                combined, _, _ = build(prefix, sw)
                arr = np.asarray(combined)
                used = arr[:, 0].astype(np.int64)
                segbits = arr[:, 1:1 + n_segs].astype(np.int64)
                if (used <= prefix).all() \
                        and (segbits <= sw * 32).all():
                    jenc._note_seg_usage(int(segbits.max()))
                    return [hdr + compact_segments_finalize(
                        segbits[i], arr[i, 1 + n_segs:])
                        + b"\xff\xd9" for i in range(c * f)]
                jenc._seg_used_words = max(
                    getattr(jenc, "_seg_used_words", 0),
                    (int(segbits.max()) + 31) // 32)
                jenc._seg_words = max(jenc._seg_words, jenc._seg_target())
                # overflow → block-concat path below for THIS batch,
                # capacity grown for the next
            combined = encode_gop_scans_combined(
                yq.reshape(c * f, *yq.shape[2:]),
                cbq.reshape(c * f, *cbq.shape[2:]),
                crq.reshape(c * f, *crq.shape[2:]),
                layout=layout, prefix_words=prefix,
                use_pallas=jenc.use_pallas)
            arr = np.asarray(combined)
            bits = arr[:, 0].astype(np.int64)
            if (bits <= prefix * 32).all():
                return [hdr + stuff_and_finalize(arr[i, 1:], int(bits[i]))
                        + b"\xff\xd9" for i in range(c * f)]
            # dense-content overflow → host coder below
        yq = np.asarray(yq)
        cbq = np.asarray(cbq)
        crq = np.asarray(crq)

        def scan(idx):
            ci, fi = divmod(idx, f)
            return hdr + encode_scan(yq[ci, fi], cbq[ci, fi], crq[ci, fi],
                                     True) + b"\xff\xd9"

        # pool preserves submission order → strict in-order gather
        return list(self._pool.map(scan, range(c * f)))
