"""The benchmark's graph sources, and the one check of a graph's fields.

A configuration that names ``"graph": "<name>"`` takes its graph from
``graphs/<name>.py`` (``harness.graph_fields``); one that names none from
``graphgen.py``.  A source defines ``graph_arrays(config, seed)``, which
returns the fields ``graphgen.graph_arrays`` returns (``FIELDS``, numpy
arrays and a tuple of path names), and ``TINY``, a configuration at which
the CPU tests check it.  A source imports nothing of the program and
nothing of JAX (``harness.FORBIDDEN``).

``check_fields`` is for the tests: a timed run does not call it, so no
cell's set-up pays a pass over its steps.
"""

from __future__ import annotations

import numpy as np

FIELDS = ("node_len", "seq_offset", "seq", "node_id", "edge_from", "edge_to",
          "path_names", "path_circular", "path_offset", "step_handle", "step_pos")
DTYPES = dict(node_len=np.int64, seq_offset=np.int64, seq=np.uint8, node_id=np.int64,
              edge_from=np.int64, edge_to=np.int64, path_circular=np.bool_,
              path_offset=np.int64, step_handle=np.int64, step_pos=np.int64)


def check_fields(f: dict) -> None:
    """Raise ValueError unless `f` is a sound graph: every field there with
    its dtype; sequence offsets the running sum of the node lengths; path
    offsets from 0 up to the step count; step handles and both ends of
    every edge handles in [0, 2N); each step's position the running sum of
    the node lengths before it along its path; edges distinct.  The edges'
    order is not checked: a source built through ``GraphTensors`` need not
    share ``graphgen``'s."""
    missing = [k for k in FIELDS if k not in f]
    if missing:
        raise ValueError(f"missing fields {missing}")
    for k, t in DTYPES.items():
        a = f[k]
        if not isinstance(a, np.ndarray) or a.dtype != t or a.ndim != 1:
            raise ValueError(f"{k}: want a 1-D {np.dtype(t)} array, got "
                             f"{getattr(a, 'dtype', type(a))} {getattr(a, 'shape', '')}")
    n = len(f["node_len"])
    if len(f["node_id"]) != n or len(f["seq_offset"]) != n + 1:
        raise ValueError("node_id / seq_offset: not one a node (seq_offset one more)")
    if f["seq_offset"][0] != 0 or not np.array_equal(np.diff(f["seq_offset"]), f["node_len"]) \
            or len(f["seq"]) != f["seq_offset"][-1]:
        raise ValueError("seq_offset: not the running sum of node_len, or seq of another length")
    off, h, pos = f["path_offset"], f["step_handle"], f["step_pos"]
    paths = len(f["path_names"])
    if not all(isinstance(name, str) for name in f["path_names"]):
        raise ValueError("path_names: not all strings")
    if len(f["path_circular"]) != paths or len(off) != paths + 1:
        raise ValueError("path_circular / path_offset: not one a path (path_offset one more)")
    if off[0] != 0 or off[-1] != len(h) or (np.diff(off) < 0).any() or len(pos) != len(h):
        raise ValueError("path_offset: not a rise from 0 to the step count")
    for k in ("step_handle", "edge_from", "edge_to"):
        a = f[k]
        if len(a) and (a.min() < 0 or a.max() >= 2 * n):
            raise ValueError(f"{k}: a handle outside [0, {2 * n})")
    if len(f["edge_from"]) != len(f["edge_to"]):
        raise ValueError("edge_from / edge_to: of other lengths")
    lens = f["node_len"][h >> 1]
    before = np.cumsum(lens) - lens
    if not np.array_equal(pos, before - before[np.repeat(off[:-1], np.diff(off))]):
        raise ValueError("step_pos: not the running sum of node_len along each path")
    key = f["edge_from"] * (2 * n) + f["edge_to"]
    if len(np.unique(key)) != len(key):
        raise ValueError("edges: not distinct")
