"""PNG files of RGB images, written as Pillow 12.1 writes them, without PIL.

``odgi_tpu`` saves its pictures with ``PIL.Image.save``; the port depends
on no imaging library, so it writes the same bytes itself (given the same
zlib):

- the signature, IHDR (8-bit RGB, no interlace), the IDAT chunks, IEND;
- each row filtered by the filter whose bytes, read as signed, have the
  least sum of absolute values, tried in Pillow's order (none, up, sub,
  Paeth; Pillow never picks average) and kept only when strictly smaller;
- the filtered rows deflated with level 6, a 15-bit window, memLevel 9
  and ``Z_FILTERED``, as Pillow's zip encoder does;
- the deflate stream cut into IDAT chunks of max(65536, 4 * width) bytes,
  the size of the buffer Pillow's encoder fills for each chunk.

``decode`` and ``read`` decode what ``write`` writes (8-bit RGB, any
filter), so that a picture can be checked against the array it came from.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
MAXBLOCK = 65536
BPP = 3  # bytes a pixel: 8-bit RGB
# Pillow's order of trial; a later filter is kept only when strictly better
FILTER_ORDER = (0, 2, 1, 4)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(data, zlib.crc32(tag)) & 0xFFFFFFFF))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(img: np.ndarray) -> bytes:
    """The filtered image data: each row's filter byte, then its filtered
    bytes, every row at once."""
    h, w, _ = img.shape
    x = img.reshape(h, w * BPP).astype(np.int16)
    b = np.zeros_like(x)
    b[1:] = x[:-1]                       # the row above
    a = np.zeros_like(x)
    a[:, BPP:] = x[:, :-BPP]             # the pixel to the left
    c = np.zeros_like(x)
    c[1:, BPP:] = x[:-1, :-BPP]          # above and to the left
    # indexed by the filter's number; average (3) is never tried
    cand = np.stack([x, x - a, x - b, x, x - _paeth(a, b, c)]) & 0xFF
    score = np.minimum(cand, 256 - cand).sum(axis=2)          # [5, h]
    best = np.full(h, FILTER_ORDER[0])
    best_score = score[FILTER_ORDER[0]]
    for f in FILTER_ORDER[1:]:
        better = score[f] < best_score
        best = np.where(better, f, best)
        best_score = np.where(better, score[f], best_score)
    rows = cand[best, np.arange(h)].astype(np.uint8)
    return np.concatenate([best.astype(np.uint8)[:, None], rows], axis=1).tobytes()


def encode(img: np.ndarray) -> bytes:
    """The PNG file of an RGB uint8[H, W, 3] image."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an RGB image of shape [H, W, 3], got {img.shape}")
    h, w, _ = img.shape
    comp = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    stream = comp.compress(filter_rows(img)) + comp.flush()
    block = max(MAXBLOCK, 4 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + b"".join(_chunk(b"IDAT", stream[i:i + block])
                       for i in range(0, len(stream), block))
            + _chunk(b"IEND", b""))


def write(img: np.ndarray, path: str) -> None:
    """Write an RGB uint8[H, W, 3] image to `path` as PNG."""
    data = encode(img)
    with open(path, "wb") as f:
        f.write(data)


def read(path: str) -> np.ndarray:
    """The RGB uint8[H, W, 3] image of the PNG file at `path`."""
    with open(path, "rb") as f:
        return decode(f.read())


def decode(data: bytes) -> np.ndarray:
    """The RGB uint8[H, W, 3] image of an 8-bit RGB, non-interlaced PNG."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    w, h, depth, color, _, _, interlace = hdr
    if (depth, color, interlace) != (8, 2, 0):
        raise ValueError("only 8-bit RGB PNGs without interlace are read")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    raw = raw.reshape(h, 1 + w * BPP)
    out = np.zeros((h, w * BPP), dtype=np.uint8)
    prev = np.zeros(w * BPP, dtype=np.uint8)
    for y in range(h):
        f, x = raw[y, 0], raw[y, 1:]
        if f == 0:
            row = x
        elif f == 1:    # sub: a running sum of each channel
            row = np.cumsum(x.reshape(w, BPP), axis=0, dtype=np.uint8).reshape(-1)
        elif f == 2:
            row = x + prev
        else:           # average and Paeth: left to right, byte by byte
            xs, up, row = x.tolist(), prev.tolist(), [0] * (w * BPP)
            for i in range(w * BPP):
                a = row[i - BPP] if i >= BPP else 0
                if f == 3:
                    pred = (a + up[i]) >> 1
                else:
                    c = up[i - BPP] if i >= BPP else 0
                    p = a + up[i] - c
                    pa, pb, pc = abs(p - a), abs(p - up[i]), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (up[i] if pb <= pc else c)
                row[i] = (xs[i] + pred) & 0xFF
            row = np.asarray(row, dtype=np.uint8)
        out[y] = row
        prev = out[y]
    return out.reshape(h, w, BPP)
