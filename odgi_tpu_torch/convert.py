"""Build the port's graph from plain arrays.

``graph_from_arrays`` takes the fields of a graph as numpy arrays (for
example those of ``odgi_tpu``'s ``GraphTensors``) and returns the port's
``GraphTensors``.  It is how a graph crosses from one package to the other
without either importing the other; coordinates cross as plain numpy
``(2N, 2)`` or ``(N,)`` arrays.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from .core.graph import GraphTensors

FIELDS = (
    "node_len", "seq_offset", "seq", "node_id", "edge_from", "edge_to",
    "path_names", "path_circular", "path_offset", "step_handle", "step_pos",
)

_DTYPES = {
    "node_len": np.int64, "seq_offset": np.int64, "seq": np.uint8,
    "node_id": np.int64, "edge_from": np.int64, "edge_to": np.int64,
    "path_circular": bool, "path_offset": np.int64,
    "step_handle": np.int64, "step_pos": np.int64,
}


def graph_from_arrays(fields: Mapping) -> GraphTensors:
    """GraphTensors from a mapping with every name in ``FIELDS``."""
    missing = [k for k in FIELDS if k not in fields]
    if missing:
        raise KeyError(f"graph_from_arrays: missing fields {missing}")
    kw = {k: np.array(fields[k], dtype=t) for k, t in _DTYPES.items()}
    kw["path_names"] = tuple(str(n) for n in fields["path_names"])
    return GraphTensors(**kw)


def graph_to_arrays(g) -> dict:
    """The ``FIELDS`` of any graph object that has them, as numpy arrays."""
    out = {k: np.asarray(getattr(g, k)) for k in FIELDS if k != "path_names"}
    out["path_names"] = tuple(g.path_names)
    return out
