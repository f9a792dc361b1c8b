"""Layout container IO: the reference ``.lay`` format plus a native one.

A copy of ``odgi_tpu/io/lay.py``.  The ``.lay`` file is ``min_value`` (f64)
followed by an sdsl ``enc_vector<>`` of min-shifted doubles bit-cast to
uint64:

  [f64 min_value] [u64 m_size]
  m_z:      [u64 bit_count] [u8 width=1] [ceil(bits/64) x u64 LE words]
  samples:  [u64 bit_count] [u8 width] [words]

``samples`` holds (value, bit-pointer) pairs for every 128th element plus a
(0, z_bits+1) sentinel, packed LSB-first at the stored width.  Between
samples, consecutive differences (uint64 wraparound) are elias-delta coded
LSB-first: ``ll`` zeros and a terminating 1, the ``ll`` low bits of the
value's bit length, then the ``len-1`` low bits of the value.  A zero
difference encodes as 1 (sdsl's ``bits::hi(0) == 0`` quirk), so equal
consecutive coordinates come back 1 ulp apart: the codec is lossy by
design.

The value stream interleaves X[i], Y[i] for endpoint index i in [0, 2N).
The native container (.layt, magic OTLY0001) stores the raw (2N, 2) f64
array; ``load_layout`` sniffs both.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device

MAGIC = b"OTLY0001"

_M64 = (1 << 64) - 1
_DENS = 128  # enc_vector sample density (sdsl default)


class _BitWriter:
    def __init__(self):
        self.words = []
        self.buf = 0
        self.nbits = 0

    def put(self, value: int, width: int) -> None:
        if width == 0:
            return
        self.buf |= (value & ((1 << width) - 1)) << self.nbits
        self.nbits += width
        while self.nbits >= 64:
            self.words.append(self.buf & _M64)
            self.buf >>= 64
            self.nbits -= 64

    @property
    def bitpos(self) -> int:
        return len(self.words) * 64 + self.nbits

    def finish(self) -> Tuple[np.ndarray, int]:
        bits = self.bitpos
        if self.nbits:
            self.words.append(self.buf & _M64)
        return np.array(self.words, dtype=np.uint64), bits


def _put_elias_delta(bw: _BitWriter, w: int) -> None:
    if w == 0:
        w = 1  # sdsl quirk: delta 0 is unencodable, collapses to 1
    ln = w.bit_length()
    ll = ln.bit_length() - 1
    bw.put(1 << ll, ll + 1)
    bw.put(ln & ((1 << ll) - 1), ll)
    bw.put(w & ((1 << (ln - 1)) - 1), ln - 1)


def _get_int(arr: np.ndarray, bitpos: int, width: int) -> int:
    if width == 0:
        return 0
    w = bitpos >> 6
    b = bitpos & 63
    v = int(arr[w]) >> b
    got = 64 - b
    while got < width:
        w += 1
        v |= int(arr[w]) << got
        got += 64
    return v & ((1 << width) - 1)


def _decode_elias_delta(arr: np.ndarray, pos: int) -> Tuple[int, int]:
    ll = 0
    while _get_int(arr, pos + ll, 1) == 0:
        ll += 1
    pos += ll + 1
    ln = (1 << ll) | _get_int(arr, pos, ll)
    pos += ll
    if ln == 1:
        return 1, pos
    w = (1 << (ln - 1)) | _get_int(arr, pos, ln - 1)
    return w, pos + ln - 1


def _host_f64(coords) -> np.ndarray:
    if isinstance(coords, torch.Tensor):
        coords = coords.detach().cpu().numpy()
    return np.asarray(coords, dtype=np.float64)


def save_lay(coords, out: Union[str, BinaryIO]) -> None:
    """Write a (2N, 2) endpoint array as a reference-loadable .lay."""
    coords = _host_f64(coords)
    close = False
    if isinstance(out, str):
        out = open(out, "wb")
        close = True
    try:
        min_value = float(coords.min()) if coords.size else 0.0
        vals = (coords - min_value).reshape(-1).view(np.uint64)
        m_size = len(vals)
        bw = _BitWriter()
        samples = []
        prev = 0
        for i, v in enumerate(vals.tolist()):
            if i % _DENS == 0:
                samples.append((v, bw.bitpos))
            else:
                _put_elias_delta(bw, (v - prev) & _M64)
            prev = v
        zwords, zbits = bw.finish()
        samples.append((0, zbits + 1))  # sdsl sentinel pair
        width = max(max(x.bit_length() for pair in samples for x in pair), 1)
        sw = _BitWriter()
        for v, ptr in samples:
            sw.put(v, width)
            sw.put(ptr, width)
        swords, sbits = sw.finish()
        out.write(struct.pack("<dQ", min_value, m_size))
        out.write(struct.pack("<QB", zbits, 1))
        out.write(zwords.astype("<u8").tobytes())
        out.write(struct.pack("<QB", sbits, width))
        out.write(swords.astype("<u8").tobytes())
    finally:
        if close:
            out.close()


def load_lay(src: Union[str, bytes, BinaryIO]) -> np.ndarray:
    """Load a reference .lay into a (2N, 2) float64 endpoint array."""
    if isinstance(src, str):
        with open(src, "rb") as f:
            data = f.read()
    elif isinstance(src, bytes):
        data = src
    else:
        data = src.read()
    min_value, m_size = struct.unpack_from("<dQ", data, 0)
    zbits, zwidth = struct.unpack_from("<QB", data, 16)
    if zwidth != 1:
        raise ValueError(f".lay: expected bit-stream width 1, got {zwidth}")
    zwords = (zbits + 63) // 64
    z = np.frombuffer(data, dtype="<u8", count=zwords, offset=25)
    p = 25 + 8 * zwords
    sbits, swidth = struct.unpack_from("<QB", data, p)
    swords = (sbits + 63) // 64
    s = np.frombuffer(data, dtype="<u8", count=swords, offset=p + 9)
    npairs = sbits // swidth // 2
    out = np.zeros(m_size, dtype=np.uint64)
    for j in range((m_size + _DENS - 1) // _DENS):
        if j >= npairs:
            raise ValueError(".lay: sample table too short")
        v = _get_int(s, (2 * j) * swidth, swidth)
        pos = _get_int(s, (2 * j + 1) * swidth, swidth)
        base = j * _DENS
        out[base] = v
        for k in range(base + 1, min(base + _DENS, m_size)):
            w, pos = _decode_elias_delta(z, pos)
            v = (v + w) & _M64
            out[k] = v
    return (out.view(np.float64) + min_value).reshape(-1, 2)


def save_layout(coords, out: Union[str, BinaryIO], device=None) -> None:
    """Write a layout: the reference .lay format for ``*.lay`` paths,
    native .layt otherwise.  ``coords`` is a (2N, 2) numpy array or
    tensor; the encoding is host work, and ``device`` is checked like
    every entry point's."""
    resolve_device(device)
    if isinstance(out, str) and out.endswith(".lay"):
        save_lay(coords, out)
        return
    coords = _host_f64(coords)
    close = False
    if isinstance(out, str):
        out = open(out, "wb")
        close = True
    try:
        out.write(MAGIC)
        out.write(struct.pack("<q", coords.shape[0]))
        out.write(coords.tobytes())
    finally:
        if close:
            out.close()


def load_layout(src: Union[str, BinaryIO]) -> np.ndarray:
    """Load a layout, sniffing native .layt vs reference .lay."""
    close = False
    if isinstance(src, str):
        src = open(src, "rb")
        close = True
    try:
        data = src.read()
    finally:
        if close:
            src.close()
    if data[:8] == MAGIC:
        (n,) = struct.unpack_from("<q", data, 8)
        arr = np.frombuffer(data, dtype=np.float64, count=n * 2, offset=16)
        return arr.reshape(n, 2).copy()
    return load_lay(data)
