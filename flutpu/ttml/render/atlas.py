"""Glyph/run atlas — device-resident texture cache for the TTML renderer.

The device-first answer to the reference's glyph-by-glyph cairo drawing
(plugins/ttml/gstttmlrender.c:941-1176 show_layout): the host shapes and
rasterizes each unique styled text run ONCE (PIL/FreeType alpha map), the
alpha map is split into fixed-size tiles and uploaded into a device atlas
array, and every subsequent interval that reuses the run costs zero host
rasterization and zero upload — the device compositor
(flutpu.ttml.render.device) just references tile indices.

Outline variants (dilate-stroke + gaussian blur, the reference's
render_outline :1180-1232 + gstttmlblur.c) are computed ON DEVICE from the
base tile and cached as additional atlas tiles, so the pixel-heavy stroke
work never touches numpy.

Fixed tile geometry keeps every device shape static: runs larger than one
tile are split into a grid of tile-sized instances. The atlas array grows
in power-of-two tile counts so XLA recompiles O(log n) times.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

TILE_H = 128
TILE_W = 512


class _Entry:
    __slots__ = ("tiles", "width", "height", "ascent")

    def __init__(self, tiles, width, height, ascent):
        # tiles: list of (tile_idx, dx, dy, w, h) covering the alpha map
        self.tiles = tiles
        self.width = width
        self.height = height
        self.ascent = ascent


@functools.partial(__import__("jax").jit,
                   static_argnames=("radius", "blur_px"))
def _stroke_tiles(tiles, radius: int, blur_px: int):
    """Batched device stroke: dilate by ``radius`` (max-pool) + optional
    separable gaussian blur. tiles: (N, TILE_H, TILE_W) uint8."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    x = tiles.astype(jnp.float32)
    if radius > 0:
        x = lax.reduce_window(
            x, -jnp.inf, lax.max,
            window_dimensions=(1, 2 * radius + 1, 2 * radius + 1),
            window_strides=(1, 1, 1), padding="SAME")
        x = jnp.maximum(x, 0.0)
    if blur_px > 0:
        sigma = max(blur_px / 2.0, 0.5)
        r = max(1, int(sigma * 3))
        k1 = jnp.exp(-(jnp.arange(-r, r + 1, dtype=jnp.float32) ** 2)
                     / (2 * sigma * sigma))
        k1 = k1 / k1.sum()
        # separable blur as two 1-D convs over the tile batch
        xpad = jnp.pad(x, ((0, 0), (r, r), (0, 0)))
        x = lax.conv_general_dilated(
            xpad[:, None], k1.reshape(1, 1, -1, 1),
            window_strides=(1, 1), padding="VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"))[:, 0]
        xpad = jnp.pad(x, ((0, 0), (0, 0), (r, r)))
        x = lax.conv_general_dilated(
            xpad[:, None], k1.reshape(1, 1, 1, -1),
            window_strides=(1, 1), padding="VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"))[:, 0]
    return jnp.clip(x, 0, 255).astype(jnp.uint8)


class GlyphAtlas:
    """Host-managed, device-resident run/tile cache.

    Tile 0 is reserved as a solid all-255 tile used for rectangles
    (backgrounds, decorations). The device array is materialized lazily and
    re-uploaded only when new tiles were added since the last sync.
    """

    def __init__(self):
        self._tiles: List[np.ndarray] = [
            np.full((TILE_H, TILE_W), 255, np.uint8)]
        self._runs: Dict[tuple, _Entry] = {}
        self._stroked: Dict[tuple, _Entry] = {}
        self._device = None
        self._device_n = 0
        self._synced_upto = 0
        # RGBA image tiles (SMPTE background images): a parallel atlas with
        # per-pixel color; instances reference them with NEGATIVE tile
        # indices (-idx-1) so the one instance stream stays homogeneous
        self._img_tiles: List[np.ndarray] = [
            np.zeros((TILE_H, TILE_W, 4), np.uint8)]
        self._images: Dict[str, _Entry] = {}
        self._img_device = None
        self._img_device_n = 0
        self._img_synced_upto = 0

    # -- host-side cache ----------------------------------------------------
    def _add_alpha_map(self, alpha: np.ndarray, ascent: int) -> _Entry:
        h, w = alpha.shape
        tiles = []
        for ty in range(0, max(1, h), TILE_H):
            for tx in range(0, max(1, w), TILE_W):
                sub = alpha[ty:ty + TILE_H, tx:tx + TILE_W]
                tile = np.zeros((TILE_H, TILE_W), np.uint8)
                tile[:sub.shape[0], :sub.shape[1]] = sub
                tiles.append((len(self._tiles), tx, ty,
                              sub.shape[1], sub.shape[0]))
                self._tiles.append(tile)
        return _Entry(tiles, w, h, ascent)

    def run_entry(self, text: str, family: str, size_px: int, bold: bool,
                  italic: bool, par_scale: float = 1.0, rot: int = 0,
                  shear: float = 0.0) -> _Entry:
        """Tiles for a rasterized text run. ``par_scale`` horizontally
        scales the glyph bitmap — the anamorphic PAR glyph scaling of the
        reference (gstttmlrender.c:745-857 shape attrs with manually
        scaled extents). ``rot`` (np.rot90 k: -1 cw for tbrl, +1 ccw for
        tblr) pre-rotates the run's alpha map so vertical writing modes
        stay on the device path with plain axis-aligned tiles. ``shear``
        is the reverseOblique glyph shear (fonts.rasterize_run)."""
        key = (text, family, size_px, bold, italic, round(par_scale, 4),
               rot, round(shear, 3))
        e = self._runs.get(key)
        if e is None:
            from .fonts import rasterize_run
            alpha, m = rasterize_run(text, family, size_px, bold, italic,
                                     shear=shear)
            if par_scale != 1.0 and alpha.shape[1] > 0:
                new_w = max(1, int(round(alpha.shape[1] * par_scale)))
                alpha = _resize_width(alpha, new_w)
            if rot:
                alpha = np.ascontiguousarray(np.rot90(alpha, rot))
            e = self._add_alpha_map(alpha, m.ascent)
            self._runs[key] = e
        return e

    def stroked_entry(self, text: str, family: str, size_px: int, bold: bool,
                      italic: bool, radius: int, blur_px: int,
                      par_scale: float = 1.0, rot: int = 0,
                      shear: float = 0.0) -> _Entry:
        """Outline variant of a run: computed on device from the base
        tiles (dilate + blur), cached as new atlas tiles."""
        key = (text, family, size_px, bold, italic, radius, blur_px,
               round(par_scale, 4), rot, round(shear, 3))
        e = self._stroked.get(key)
        if e is None:
            base = self.run_entry(text, family, size_px, bold, italic,
                                  par_scale, rot, shear)
            idxs = [t[0] for t in base.tiles]
            batch = np.stack([self._tiles[i] for i in idxs])
            import jax.numpy as jnp
            stroked = np.asarray(_stroke_tiles(jnp.asarray(batch),
                                               radius=int(radius),
                                               blur_px=int(blur_px)))
            tiles = []
            for ((_, dx, dy, w, h), arr) in zip(base.tiles, stroked):
                tiles.append((len(self._tiles), dx, dy, w, h))
                self._tiles.append(arr)
            e = _Entry(tiles, base.width, base.height, base.ascent)
            self._stroked[key] = e
        return e

    def image_entry(self, rgba: np.ndarray, rot: int = 0) -> _Entry:
        """Tiles for a decoded RGBA image (SMPTE backgroundImage,
        reference gstttmlrender.c:344-419): tiled into the RGBA atlas,
        instances carry -idx-1 tile ids. Cached by CONTENT hash — two
        documents may bind the same #id to different images, so a
        reference-string key would alias them."""
        import hashlib
        if rot:
            rgba = np.ascontiguousarray(np.rot90(rgba, rot))
        key = (rgba.shape, hashlib.sha1(
            np.ascontiguousarray(rgba).tobytes()).hexdigest())
        e = self._images.get(key)
        if e is None:
            h, w = rgba.shape[:2]
            if rgba.ndim == 2:
                rgba = np.stack([rgba] * 3 + [np.full_like(rgba, 255)],
                                axis=-1)
            if rgba.shape[-1] == 3:
                rgba = np.concatenate(
                    [rgba, np.full(rgba.shape[:2] + (1,), 255, np.uint8)],
                    axis=-1)
            tiles = []
            for ty in range(0, max(1, h), TILE_H):
                for tx in range(0, max(1, w), TILE_W):
                    sub = rgba[ty:ty + TILE_H, tx:tx + TILE_W]
                    tile = np.zeros((TILE_H, TILE_W, 4), np.uint8)
                    tile[:sub.shape[0], :sub.shape[1]] = sub
                    tiles.append((-len(self._img_tiles) - 1, tx, ty,
                                  sub.shape[1], sub.shape[0]))
                    self._img_tiles.append(tile)
            e = _Entry(tiles, w, h, 0)
            self._images[key] = e
        return e

    # -- device sync ---------------------------------------------------------
    def image_device_array(self):
        """The RGBA image atlas as an (M, TILE_H, TILE_W, 4) uint8 device
        array (M >= 1; index 0 is a transparent dummy)."""
        import jax.numpy as jnp
        n = len(self._img_tiles)
        cap = 1
        while cap < n:
            cap *= 2
        if self._img_device is None or self._img_device_n != cap:
            arr = np.zeros((cap, TILE_H, TILE_W, 4), np.uint8)
            arr[:n] = np.stack(self._img_tiles)
            self._img_device = jnp.asarray(arr)
            self._img_device_n = cap
            self._img_synced_upto = n
        elif self._img_synced_upto < n:
            new = np.stack(self._img_tiles[self._img_synced_upto:n])
            self._img_device = self._img_device.at[
                self._img_synced_upto:n].set(jnp.asarray(new))
            self._img_synced_upto = n
        return self._img_device

    def device_array(self):
        """The atlas as a (N, TILE_H, TILE_W) uint8 device array; N grows
        in powers of two to bound recompiles."""
        import jax.numpy as jnp
        n = len(self._tiles)
        cap = 1
        while cap < n:
            cap *= 2
        cap = max(cap, 16)
        if self._device is None or self._device_n != cap:
            arr = np.zeros((cap, TILE_H, TILE_W), np.uint8)
            arr[:n] = np.stack(self._tiles)
            self._device = jnp.asarray(arr)
            self._device_n = cap
            self._synced_upto = n
        elif self._synced_upto < n:
            # incremental upload of only the new tiles
            new = np.stack(self._tiles[self._synced_upto:n])
            self._device = self._device.at[self._synced_upto:n].set(
                jnp.asarray(new))
            self._synced_upto = n
        return self._device

    def clear(self):
        self.__init__()


def _resize_width(alpha: np.ndarray, new_w: int) -> np.ndarray:
    """Horizontal resample of an alpha map (PAR anamorphic scaling)."""
    try:
        from PIL import Image
        img = Image.fromarray(alpha, "L").resize(
            (new_w, alpha.shape[0]), Image.BILINEAR)
        return np.asarray(img, np.uint8)
    except ImportError:
        idx = np.clip((np.arange(new_w) * alpha.shape[1] // max(1, new_w)),
                      0, alpha.shape[1] - 1)
        return alpha[:, idx]


_global_atlas: Optional[GlyphAtlas] = None


def get_atlas() -> GlyphAtlas:
    global _global_atlas
    if _global_atlas is None:
        _global_atlas = GlyphAtlas()
    return _global_atlas
