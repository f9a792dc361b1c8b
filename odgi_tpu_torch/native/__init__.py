"""The native GFA parser (``src/gfa_parse.cpp``), chunk schedule
(``src/strata_schedule.cpp``), step-table indexes
(``src/strata_steps.cpp``) and graph passes (``src/graph_passes.cpp``),
each built at first use.

The parser is a copy of ``odgi_tpu/native``'s C++ parser: one mmap pass
over the file into flat arrays.  ``g++ -O3 -std=c++17`` builds it into
``odgi_tpu_torch/_build/`` (keyed by a hash of the source and the flags,
like the CUDA kernels) the first time a GFA path is parsed, and ``ctypes``
binds its plain C interface.  Importing this module builds nothing.
Without a working ``g++`` the parser is unavailable (``get_lib()`` returns
None and ``build_error()`` says why) and ``io/gfa.py`` parses in Python.
The schedule library (``schedule_lib()``) is built the same way, the first
time a strata run plans its chunks; without it ``ops/strata_levels.py``
builds the same schedule in numpy.  So is the step-table library
(``steps_lib()``), the first time a strata run indexes its steps (the
first-visit order, the merge CSR, the block schedule); without it
``ops/strata_xxl.py`` and ``ops/strata_sgd.py`` build the same arrays in
numpy.  ``steps_pass()`` counts which of the two each pass took.  The
graph-pass library (``gs_lib()``) holds the groom walk and the topological
order of a sort's ``g`` and ``s`` steps, built the first time either runs;
without it ``algorithms/groom.py`` and ``algorithms/topological.py`` run
the same passes in Python.  ``gs_pass()`` counts which of the two each call
took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..core.graph import GraphTensors
from ..utils.metrics import TOTALS, count, timed

SRC = Path(__file__).resolve().parent / "src" / "gfa_parse.cpp"
SCHEDULE_SRC = SRC.with_name("strata_schedule.cpp")
STEPS_SRC = SRC.with_name("strata_steps.cpp")
GS_SRC = SRC.with_name("graph_passes.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_state: dict = {"lib": None, "tried": False, "error": None}
_schedule: dict = {"lib": None, "tried": False, "error": None}
_steps: dict = {"lib": None, "tried": False, "error": None}
_gs: dict = {"lib": None, "tried": False, "error": None}
# TOTALS names of the step-table passes, by the path each took
STEPS_NATIVE, STEPS_NUMPY = "strata.steps_native", "strata.steps_numpy"
# TOTALS names of the groom and topological-order calls, by the path each took
GS_NATIVE, GS_PYTHON = "gs.native", "gs.python"


class _GfaResult(ctypes.Structure):
    _fields_ = [
        ("num_nodes", ctypes.c_int64),
        ("num_edges", ctypes.c_int64),
        ("num_paths", ctypes.c_int64),
        ("num_steps", ctypes.c_int64),
        ("seq_total", ctypes.c_int64),
        ("names_total", ctypes.c_int64),
        ("node_id", ctypes.POINTER(ctypes.c_int64)),
        ("node_len", ctypes.POINTER(ctypes.c_int64)),
        ("seq_offset", ctypes.POINTER(ctypes.c_int64)),
        ("seq", ctypes.POINTER(ctypes.c_uint8)),
        ("edge_from", ctypes.POINTER(ctypes.c_int64)),
        ("edge_to", ctypes.POINTER(ctypes.c_int64)),
        ("path_offset", ctypes.POINTER(ctypes.c_int64)),
        ("step_handle", ctypes.POINTER(ctypes.c_int64)),
        ("step_pos", ctypes.POINTER(ctypes.c_int64)),
        ("path_names", ctypes.POINTER(ctypes.c_uint8)),
        ("path_name_offset", ctypes.POINTER(ctypes.c_int64)),
        ("error", ctypes.c_char_p),
    ]


def library_path(src: Path = SRC) -> Path:
    """The shared library of the source `src` and these flags."""
    key = hashlib.sha256(" ".join(CXX_FLAGS).encode() + src.read_bytes())
    return BUILD_DIR / f"{src.stem}_{key.hexdigest()[:16]}.so"


@timed("native.build")
def build(src: Path = SRC) -> Path:
    """Compile `src` (by default the parser) unless this key is built
    already; raises RuntimeError when g++ is missing or fails.  Timed as
    ``native.build`` (``utils.metrics.TOTALS``, the g++ runs as its
    compiles), as are the first loads of `get_lib`, `schedule_lib`,
    `steps_lib` and `gs_lib`."""
    so = library_path(src)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    TOTALS["native.build"]["compiles"] += 1
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f"g++ did not run: {exc!r}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def _load(state: dict, src: Path, bind) -> Optional[ctypes.CDLL]:
    """The library of `src` (built and bound by `bind` on the first call,
    timed as ``native.build``), or None when it cannot be built or loaded
    (``state["error"]`` says why)."""
    with _lock:
        if not state["tried"]:
            state["tried"] = True
            with timed("native.build"):
                try:
                    lib = ctypes.CDLL(str(build(src)))
                except (RuntimeError, OSError) as exc:
                    state["error"] = str(exc)
                else:
                    bind(lib)
                    state["lib"] = lib
        return state["lib"]


def _bind_parser(lib: ctypes.CDLL) -> None:
    lib.odgi_gfa_parse.restype = ctypes.POINTER(_GfaResult)
    lib.odgi_gfa_parse.argtypes = [ctypes.c_char_p]
    lib.odgi_gfa_free.restype = None
    lib.odgi_gfa_free.argtypes = [ctypes.POINTER(_GfaResult)]


def _bind_schedule(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int64
    lib.odgi_strata_schedule.restype = i
    lib.odgi_strata_schedule.argtypes = [i, i, p, p, p, p, p, i]


def _bind_steps(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int64
    for fn, args in ((lib.odgi_first_visit, [i, p, i, p]),
                     (lib.odgi_merge_csr, [i, p, i, i, i, p, p, p]),
                     (lib.odgi_block_schedule, [i, p, i, i, i, i, p, p, i])):
        fn.restype = i
        fn.argtypes = args


def _bind_gs(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int64
    for fn, args in ((lib.odgi_groom, [i, p, i, p, i, p, p, p, p]),
                     (lib.odgi_topological_order, [i, p, i, p, i, p, p, p])):
        fn.restype = i
        fn.argtypes = args


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded parser (built on the first call), or None when it cannot
    be built or loaded."""
    return _load(_state, SRC, _bind_parser)


def build_error() -> Optional[str]:
    """Why the parser is unavailable (None when it loaded or was not tried)."""
    return _state["error"]


def schedule_lib() -> Optional[ctypes.CDLL]:
    """The loaded chunk schedule library (built on the first call), or None
    when it cannot be built or loaded (``_schedule["error"]`` says why)."""
    return _load(_schedule, SCHEDULE_SRC, _bind_schedule)


def steps_lib() -> Optional[ctypes.CDLL]:
    """The loaded step-table library (built on the first call), or None
    when it cannot be built or loaded (``_steps["error"]`` says why)."""
    return _load(_steps, STEPS_SRC, _bind_steps)


def steps_pass() -> Optional[ctypes.CDLL]:
    """`steps_lib()` for one pass over a step table, counted as a run of
    ``TOTALS[STEPS_NATIVE]``, or of ``TOTALS[STEPS_NUMPY]`` when the pass
    falls back to numpy."""
    lib = steps_lib()
    count(STEPS_NATIVE if lib is not None else STEPS_NUMPY)
    return lib


def gs_lib() -> Optional[ctypes.CDLL]:
    """The loaded graph-pass library (built on the first call), or None
    when it cannot be built or loaded (``_gs["error"]`` says why)."""
    return _load(_gs, GS_SRC, _bind_gs)


def gs_pass() -> Optional[ctypes.CDLL]:
    """`gs_lib()` for one groom or topological-order call, counted as a run
    of ``TOTALS[GS_NATIVE]``, or of ``TOTALS[GS_PYTHON]`` when the call
    falls back to Python."""
    lib = gs_lib()
    count(GS_NATIVE if lib is not None else GS_PYTHON)
    return lib


def csr_arrays(adj, num_nodes: int) -> tuple:
    """(offsets, targets) of the SideAdjacency `adj` of a graph of
    `num_nodes` nodes, contiguous int64, for the graph passes; ValueError
    unless there are 2N + 1 offsets."""
    off = np.ascontiguousarray(adj.offsets, dtype=np.int64)
    if off.shape != (2 * num_nodes + 1,):
        raise ValueError(f"{len(off)} adjacency offsets for {num_nodes} nodes")
    return off, np.ascontiguousarray(adj.targets, dtype=np.int64)


def parse_gfa_native(path: str) -> Optional[GraphTensors]:
    """Parse the GFA file `path` with the C++ parser; None when the parser
    is unavailable.  A file the parser refuses raises ValueError."""
    lib = get_lib()
    if lib is None:
        return None
    res = lib.odgi_gfa_parse(path.encode())
    try:
        r = res.contents
        if r.error:
            raise ValueError(r.error.decode())

        def arr(ptr, n, dtype=np.int64):
            if n == 0:
                return np.empty(0, dtype=dtype)
            return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)

        N, E, P, S = r.num_nodes, r.num_edges, r.num_paths, r.num_steps
        names_blob = bytes(
            np.ctypeslib.as_array(r.path_names, shape=(r.names_total,))
        ) if r.names_total else b""
        name_off = arr(r.path_name_offset, P + 1)
        path_names = tuple(
            names_blob[name_off[j]:name_off[j + 1]].decode() for j in range(P)
        )
        return GraphTensors(
            node_len=arr(r.node_len, N),
            seq_offset=arr(r.seq_offset, N + 1),
            seq=arr(r.seq, r.seq_total, np.uint8),
            node_id=arr(r.node_id, N),
            edge_from=arr(r.edge_from, E),
            edge_to=arr(r.edge_to, E),
            path_names=path_names,
            path_circular=np.zeros(P, dtype=bool),
            path_offset=arr(r.path_offset, P + 1),
            step_handle=arr(r.step_handle, S),
            step_pos=arr(r.step_pos, S),
        )
    finally:
        lib.odgi_gfa_free(res)
