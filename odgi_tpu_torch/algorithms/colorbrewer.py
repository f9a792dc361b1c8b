"""ColorBrewer palettes for viz ``-B SCHEME:N``: a copy of
``odgi_tpu/algorithms/colorbrewer.py``.

Palette values are the public ColorBrewer 2.0 data (colorbrewer2.org,
Cynthia Brewer, Apache-2.0-style license).  `palette(scheme, n)` returns a
list of RGB tuples.
"""

from __future__ import annotations

from typing import List, Tuple

RGB = Tuple[int, int, int]


def _hx(*codes: str) -> List[RGB]:
    return [
        (int(c[0:2], 16), int(c[2:4], 16), int(c[4:6], 16)) for c in codes
    ]


_PALETTES = {
    # qualitative
    "Set1": _hx("e41a1c", "377eb8", "4daf4a", "984ea3", "ff7f00",
                "ffff33", "a65628", "f781bf", "999999"),
    "Set2": _hx("66c2a5", "fc8d62", "8da0cb", "e78ac3", "a6d854",
                "ffd92f", "e5c494", "b3b3b3"),
    "Set3": _hx("8dd3c7", "ffffb3", "bebada", "fb8072", "80b1d3",
                "fdb462", "b3de69", "fccde5", "d9d9d9", "bc80bd",
                "ccebc5", "ffed6f"),
    "Dark2": _hx("1b9e77", "d95f02", "7570b3", "e7298a", "66a61e",
                 "e6ab02", "a6761d", "666666"),
    "Paired": _hx("a6cee3", "1f78b4", "b2df8a", "33a02c", "fb9a99",
                  "e31a1c", "fdbf6f", "ff7f00", "cab2d6", "6a3d9a",
                  "ffff99", "b15928"),
    "Accent": _hx("7fc97f", "beaed4", "fdc086", "ffff99", "386cb0",
                  "f0027f", "bf5b17", "666666"),
    "Pastel1": _hx("fbb4ae", "b3cde3", "ccebc5", "decbe4", "fed9a6",
                   "ffffcc", "e5d8bd", "fddaec", "f2f2f2"),
    # sequential
    "Blues": _hx("f7fbff", "deebf7", "c6dbef", "9ecae1", "6baed6",
                 "4292c6", "2171b5", "08519c", "08306b"),
    "Greens": _hx("f7fcf5", "e5f5e0", "c7e9c0", "a1d99b", "74c476",
                  "41ab5d", "238b45", "006d2c", "00441b"),
    "Reds": _hx("fff5f0", "fee0d2", "fcbba1", "fc9272", "fb6a4a",
                "ef3b2c", "cb181d", "a50f15", "67000d"),
    "Oranges": _hx("fff5eb", "fee6ce", "fdd0a2", "fdae6b", "fd8d3c",
                   "f16913", "d94801", "a63603", "7f2704"),
    "Purples": _hx("fcfbfd", "efedf5", "dadaeb", "bcbddc", "9e9ac8",
                   "807dba", "6a51a3", "54278f", "3f007d"),
    "YlGnBu": _hx("ffffd9", "edf8b1", "c7e9b4", "7fcdbb", "41b6c4",
                  "1d91c0", "225ea8", "253494", "081d58"),
    "YlOrRd": _hx("ffffcc", "ffeda0", "fed976", "feb24c", "fd8d3c",
                  "fc4e2a", "e31a1c", "bd0026", "800026"),
    # diverging
    "Spectral": _hx("9e0142", "d53e4f", "f46d43", "fdae61", "fee08b",
                    "ffffbf", "e6f598", "abdda4", "66c2a5", "3288bd",
                    "5e4fa2"),
    "RdYlBu": _hx("a50026", "d73027", "f46d43", "fdae61", "fee090",
                  "ffffbf", "e0f3f8", "abd9e9", "74add1", "4575b4",
                  "313695"),
    "RdBu": _hx("67001f", "b2182b", "d6604d", "f4a582", "fddbc7",
                "f7f7f7", "d1e5f0", "92c5de", "4393c3", "2166ac",
                "053061"),
    "PiYG": _hx("8e0152", "c51b7d", "de77ae", "f1b6da", "fde0ef",
                "f7f7f7", "e6f5d0", "b8e186", "7fbc41", "4d9221",
                "276419"),
}


def schemes() -> List[str]:
    return sorted(_PALETTES)


def palette(scheme: str, n: int) -> List[RGB]:
    """n colors from the named scheme; sequential/diverging schemes are
    resampled evenly, qualitative schemes cycle."""
    if scheme not in _PALETTES:
        raise KeyError(
            f"unknown colorbrewer scheme {scheme!r}; known: {schemes()}"
        )
    base = _PALETTES[scheme]
    if n <= 0:
        return []
    if n <= len(base):
        if scheme in ("Set1", "Set2", "Set3", "Dark2", "Paired", "Accent",
                      "Pastel1"):
            return base[:n]
        # resample evenly across the ramp
        idx = [round(i * (len(base) - 1) / max(n - 1, 1)) for i in range(n)]
        return [base[i] for i in idx]
    return [base[i % len(base)] for i in range(n)]


def parse_scheme_spec(spec: str) -> List[RGB]:
    """SCHEME:N -> colors (the -B/--colorbrewer-palette argument form)."""
    scheme, _, n = spec.partition(":")
    return palette(scheme, int(n) if n else 7)
