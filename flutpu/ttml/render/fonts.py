"""Host-side text shaping: fonts and text-run rasterization.

The host/device split of the reference's pango/cairo stack
(gstttmlrender.c:591-1176): line breaking, font selection and glyph
rasterization are deeply host-bound (FreeType via PIL here, pango there);
everything per-pixel after the alpha maps — coloring, decorations,
outlines, blur, region backgrounds, alpha-over compositing — runs as device
kernels (flutpu.ttml.render.composite).

Rasterized run alpha maps are cached by (text, font, size) since subtitle
intervals repeat runs heavily.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..enums import FontStyle, FontWeight


def _font_dir() -> Optional[str]:
    try:
        import matplotlib
        d = os.path.join(os.path.dirname(matplotlib.__file__),
                         "mpl-data", "fonts", "ttf")
        if os.path.isdir(d):
            return d
    except ImportError:
        pass
    return None


_FAMILY_FILES = {
    # TTML generic families → DejaVu files: (regular, bold, italic, bolditalic)
    "default": ("DejaVuSans.ttf", "DejaVuSans-Bold.ttf",
                "DejaVuSans-Oblique.ttf", "DejaVuSans-BoldOblique.ttf"),
    "sansSerif": ("DejaVuSans.ttf", "DejaVuSans-Bold.ttf",
                  "DejaVuSans-Oblique.ttf", "DejaVuSans-BoldOblique.ttf"),
    "serif": ("DejaVuSerif.ttf", "DejaVuSerif-Bold.ttf",
              "DejaVuSerif-Italic.ttf", "DejaVuSerif-BoldItalic.ttf"),
    "monospace": ("DejaVuSansMono.ttf", "DejaVuSansMono-Bold.ttf",
                  "DejaVuSansMono-Oblique.ttf",
                  "DejaVuSansMono-BoldOblique.ttf"),
    "monospaceSansSerif": ("DejaVuSansMono.ttf", "DejaVuSansMono-Bold.ttf",
                           "DejaVuSansMono-Oblique.ttf",
                           "DejaVuSansMono-BoldOblique.ttf"),
    "monospaceSerif": ("DejaVuSansMono.ttf", "DejaVuSansMono-Bold.ttf",
                       "DejaVuSansMono-Oblique.ttf",
                       "DejaVuSansMono-BoldOblique.ttf"),
    "proportionalSansSerif": ("DejaVuSans.ttf", "DejaVuSans-Bold.ttf",
                              "DejaVuSans-Oblique.ttf",
                              "DejaVuSans-BoldOblique.ttf"),
    "proportionalSerif": ("DejaVuSerif.ttf", "DejaVuSerif-Bold.ttf",
                          "DejaVuSerif-Italic.ttf",
                          "DejaVuSerif-BoldItalic.ttf"),
}


@functools.lru_cache(maxsize=256)
def load_font(family: str, size_px: int, bold: bool = False,
              italic: bool = False):
    """PIL font for (family, pixel size, weight, style); None when no
    TrueType backend is available (callers fall back to the bitmap font)."""
    try:
        from PIL import ImageFont
    except ImportError:
        return None
    d = _font_dir()
    files = _FAMILY_FILES.get(family) or _FAMILY_FILES.get(
        family.split(",")[0].strip()) or _FAMILY_FILES["default"]
    fname = files[(1 if bold else 0) + (2 if italic else 0)]
    if d is not None:
        path = os.path.join(d, fname)
        if os.path.exists(path):
            try:
                return ImageFont.truetype(path, size_px)
            except OSError:
                pass
    try:
        return ImageFont.load_default()
    except OSError:
        return None


@dataclass
class RunMetrics:
    width: int
    ascent: int
    descent: int

    @property
    def height(self) -> int:
        return self.ascent + self.descent


def measure_run(text: str, family: str, size_px: int, bold: bool = False,
                italic: bool = False) -> RunMetrics:
    font = load_font(family, max(1, int(size_px)), bold, italic)
    if font is None:
        return RunMetrics(8 * len(text), int(size_px * 0.8), int(size_px * 0.2))
    ascent, descent = font.getmetrics()
    width = int(font.getlength(text)) if hasattr(font, "getlength") else \
        font.getbbox(text)[2]
    return RunMetrics(width, ascent, descent)


@functools.lru_cache(maxsize=4096)
def rasterize_run(text: str, family: str, size_px: int, bold: bool = False,
                  italic: bool = False,
                  shear: float = 0.0) -> Tuple[np.ndarray, RunMetrics]:
    """Render a text run to an alpha map (H, W) uint8 + metrics.

    The map's height is ascent+descent; the baseline sits at ``ascent``.
    ``shear`` applies a horizontal glyph shear WITHOUT changing advances —
    the reference's reverseOblique rendering (a custom pango attribute +
    matrix shear, gstttmlrender.c:858-898): negative shear leans glyph
    tops LEFT (reverse oblique); positive leans right (synthetic oblique
    for faces with no italic file). The map widens by |shear|*height so
    nothing clips.
    """
    from PIL import Image, ImageDraw
    m = measure_run(text, family, size_px, bold, italic)
    font = load_font(family, max(1, int(size_px)), bold, italic)
    w = max(1, m.width)
    h = max(1, m.height)
    img = Image.new("L", (w, h), 0)
    if font is not None and text:
        ImageDraw.Draw(img).text((0, 0), text, font=font, fill=255)
    if shear and text:
        extra = int(np.ceil(abs(shear) * h))
        if shear < 0:
            # output(x, y) samples input(x + shear*y): bottoms shift right,
            # tops lean left — reverse oblique
            img = img.transform((w + extra, h), Image.AFFINE,
                                (1, shear, 0, 0, 1, 0), fillcolor=0)
        else:
            # lean right: offset so the sheared top stays in-canvas
            img = img.transform((w + extra, h), Image.AFFINE,
                                (1, shear, -extra, 0, 1, 0), fillcolor=0)
    return np.asarray(img, dtype=np.uint8), m
