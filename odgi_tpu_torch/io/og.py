"""The native binary graph container (.otg): GraphTensors serialization.

A copy of ``odgi_tpu/io/og.py``, byte for byte the same format: the magic
``OTGR0001``, a JSON header with the path names and each array's dtype and
shape, then the flat arrays themselves.  Loading is one read and a handful
of frombuffer views.  The reference's own ``.og`` is ``io/og_compat.py``.
"""

from __future__ import annotations

import json
import struct
from typing import BinaryIO, Union

import numpy as np

from ..core.graph import GraphTensors

MAGIC = b"OTGR0001"

_ARRAYS = [
    "node_len",
    "seq_offset",
    "seq",
    "node_id",
    "edge_from",
    "edge_to",
    "path_circular",
    "path_offset",
    "step_handle",
    "step_pos",
]


def save_graph(g: GraphTensors, out: Union[str, BinaryIO]) -> None:
    close = False
    if isinstance(out, str):
        out = open(out, "wb")
        close = True
    try:
        out.write(MAGIC)
        meta = {
            "path_names": list(g.path_names),
            "arrays": [
                [name, str(getattr(g, name).dtype), list(getattr(g, name).shape)]
                for name in _ARRAYS
            ],
        }
        mb = json.dumps(meta).encode()
        out.write(struct.pack("<q", len(mb)))
        out.write(mb)
        for name in _ARRAYS:
            arr = np.ascontiguousarray(getattr(g, name))
            out.write(arr.tobytes())
    finally:
        if close:
            out.close()


def load_graph(src: Union[str, BinaryIO]) -> GraphTensors:
    close = False
    if isinstance(src, str):
        src = open(src, "rb")
        close = True
    try:
        magic = src.read(8)
        if magic != MAGIC:
            raise ValueError(f"not an odgi_tpu graph file (magic {magic!r})")
        (mlen,) = struct.unpack("<q", src.read(8))
        meta = json.loads(src.read(mlen))
        kwargs = {}
        for name, dtype, shape in meta["arrays"]:
            count = int(np.prod(shape)) if shape else 1
            nbytes = count * np.dtype(dtype).itemsize
            arr = np.frombuffer(src.read(nbytes), dtype=dtype).reshape(shape)
            kwargs[name] = arr.copy()
        return GraphTensors(path_names=tuple(meta["path_names"]), **kwargs)
    finally:
        if close:
            src.close()
