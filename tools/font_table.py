#!/usr/bin/env python3
"""Build the glyph table of odgi_tpu_torch/algorithms/font.py from PIL.

`odgi_tpu`'s viz labels draw path names with Pillow's default font
(`ImageFont.load_default()`: FreeType, Aileron Regular at size 10, basic
layout, whole-pixel advances).  The port draws them without PIL from a
table of that font: for each character the font holds, its raster as
drawn alone at x = 4 on a 24 x 16 canvas (so that a negative left bearing
is kept) and its advance; plus the missing-glyph box that PIL draws for a
character the font lacks.  A string's raster is then the OR of its
glyphs, each shifted to the sum of the advances before it, less 4.

    python tools/font_table.py            # print the table's source
    python tools/font_table.py --scan     # also list the characters the
                                          # font holds (the whole of
                                          # Unicode; about 30 s)

Needs Pillow.  The printed source is the block between the markers in
odgi_tpu_torch/algorithms/font.py; tests/test_torch_render.py rebuilds the
table with `build_table` and holds it equal to the vendored one.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

CANVAS = (24, 16)       # width, height of one glyph's raster
ORIGIN_X = 4            # where a glyph is drawn on it
MISSING = "\uffff"      # a noncharacter: the font's missing-glyph box
# the characters the font holds beyond printable ASCII (from --scan)
EXTRA = (0xA9, 0xAB, 0xB0, 0xB1, 0xB4, 0xB7, 0xBB, 0x2018, 0x2019, 0x201C,
         0x201D, 0x2026, 0x2039, 0x203A, 0x2044, 0x2122, 0xFB01, 0xFB02)
CODEPOINTS = tuple(range(32, 127)) + EXTRA


def _font():
    from PIL import ImageFont

    return ImageFont.load_default()


def glyph(font, ch: str):
    """(bool[16, 24] raster, whole-pixel advance) of one character."""
    from PIL import Image, ImageDraw

    im = Image.new("L", CANVAS, 0)
    ImageDraw.Draw(im).text((ORIGIN_X, 0), ch, fill=255, font=font)
    adv = font.getlength(ch)
    if adv != int(adv):
        raise ValueError(f"advance of {ch!r} is not whole: {adv}")
    return np.asarray(im) > 0, int(adv)


def build_table(codepoints=CODEPOINTS):
    """{codepoint: (raster, advance)} and the missing glyph's pair."""
    font = _font()
    return {cp: glyph(font, chr(cp)) for cp in codepoints}, glyph(font, MISSING)


def scan() -> list:
    """Every codepoint outside printable ASCII whose glyph is not the
    missing box."""
    font = _font()
    miss = glyph(font, MISSING)
    out = []
    for cp in range(127, 0x110000):
        if 0xD800 <= cp < 0xE000:
            continue
        r, a = glyph(font, chr(cp))
        if a != miss[1] or not np.array_equal(r, miss[0]):
            out.append(cp)
    return out


def encode(raster: np.ndarray) -> str:
    """16 rows of 24 bits, 6 hex digits a row, the leftmost pixel highest."""
    w = 1 << np.arange(CANVAS[0] - 1, -1, -1, dtype=np.int64)
    return "".join(f"{int(v):06x}" for v in (raster.astype(np.int64) * w).sum(1))


def source(table, missing) -> str:
    lines = ["# --- glyph table: generated by tools/font_table.py ---",
             f"MISSING = ({missing[1]}, \"{encode(missing[0])}\")",
             "GLYPHS = {"]
    for cp, (r, a) in sorted(table.items()):
        lines.append(f"    0x{cp:04x}: ({a}, \"{encode(r)}\"),")
    lines += ["}", "# --- end of the glyph table ---"]
    return "\n".join(lines) + "\n"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scan", action="store_true")
    args = ap.parse_args()
    if args.scan:
        extra = scan()
        print("EXTRA =", tuple(hex(c) for c in extra), file=sys.stderr)
    sys.stdout.write(source(*build_table()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
