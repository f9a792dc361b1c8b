"""The strata PG-SGD CUDA kernels: build, ctypes binding and wrappers.

Every ``csrc/*.cu`` is compiled with nvcc at first use into
``odgi_tpu_torch/_build/`` (one shared library a source, all built at once,
keyed by a hash of every source, header and flag) and loaded with
``ctypes``.  Each wrapper takes its kernel's plain PyTorch version from
``ops/strata_sgd.py`` when the tensors lie on the CPU; for CUDA tensors it
launches the kernel on the current stream or raises.  A wrapper adds one to
``LAUNCHES[name]`` for every kernel launch, and only there.

Kernel (source)                     TPU kernel it replaces (odgi_tpu/ops/)
strata_chunks_2d_levels             the 2D chunk phase of every 2D kernel:
  (strata_levels.cu)                  pallas_sgd.py _make_kernel_2d,
                                      pallas_sgd_xl.py _make_kernel_xl,
                                      pallas_sgd_xxl.py _make_kernel_xxl
strata_chunks_1d_levels             the 1D chunk phase of _make_kernel_1d,
  (strata_levels.cu)                  _make_kernel_xl_1d, _make_kernel_xxl_1d
strata_chunks_2d_levels_track       pallas_sgd.py _make_kernel_2d with track
  (strata_levels.cu, TRACK)           (the dmax output, delta early stop)
strata_chunks_1d_levels_track       pallas_sgd.py _make_kernel_1d with track
strata_chunks_2d (strata_sgd.cu)    the reference of strata_chunks_2d_levels
strata_chunks_1d                    the reference of strata_chunks_1d_levels
strata_merge_sum                    pallas_sgd.py _merge_tiles_2d/_1d, sums
strata_merge_bcast                  pallas_sgd.py _merge_tiles_2d/_1d, broadcast;
                                      pallas_sgd_xxl.py broadcast + zeroing passes
strata_merge_sum_blocked            pallas_sgd_xxl.py scatter pass
  (strata_blocked.cu)
The XL route's merge is strata_merge_sum / strata_merge_bcast, which have
no node-width cap (the counterpart of XL's streamed full-width merge); the
XXL route's is strata_merge_sum_blocked / strata_merge_bcast: one pass over
the slots serves every route.
The chunk phase of every route (resident, XL, XXL) is
strata_chunks_2d_levels / strata_chunks_1d_levels: a thread-block cluster
a chunk, chunks handed out by a ticket in level order, each waiting only
for its predecessors (``ops/strata_levels.py``).  The chain kernels
strata_chunks_2d / _1d walk a group's chunks in order on one block and
compute the same drift bit for bit: they are the leveled kernels'
reference, off the main path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..utils.metrics import TOTALS, timed
from . import strata_sgd, strata_xxl

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_CHUNK_ARGS = [P, P, P, LL, P, P, I, I, I, P]
_LEVELS_ARGS = [P, P, P, LL, P, P, I, P, P, I, P, P, P, ctypes.c_uint, P, P]
# name -> ctypes argument types of its C entry (all return int)
SIGNATURES = {
    "strata_chunks_2d": _CHUNK_ARGS,
    "strata_chunks_1d": _CHUNK_ARGS,
    "strata_merge_sum": [P, LL, P, P, P, P, P, I, I, I, I, P],
    "strata_merge_bcast": [P, P, LL, P, P, I, I, P],
    "strata_merge_sum_blocked": [P, LL, P, P, P, P, P, I, I, I, I, I, P],
    "strata_chunks_2d_levels": _LEVELS_ARGS,
    "strata_chunks_1d_levels": _LEVELS_ARGS,
}
# The other C entries: name -> (argument types, result type).
QUERIES = {"strata_chunks_levels_clusters": ([I], I),
           "strata_chunks_levels_cluster_blocks": ([I], I)}
# The tracking instances of the leveled kernels (a group's Delta_max for
# delta early stop): launched by the same wrappers when given `dmax`, and
# counted apart.
TRACKED = {"strata_chunks_2d_levels": "strata_chunks_2d_levels_track",
           "strata_chunks_1d_levels": "strata_chunks_1d_levels_track"}
NAMES = tuple(SIGNATURES) + tuple(TRACKED.values())

LAUNCHES = {name: 0 for name in NAMES}

_fns: dict = {}


def reset_launch_counts() -> None:
    for name in NAMES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("odgi_tpu_torch: nvcc not found; the CUDA kernels "
                       "cannot be built")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_paths() -> list:
    """The shared library of every source, keyed by all sources, headers
    and flags."""
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        key.update(f.name.encode() + f.read_bytes())
    tag = key.hexdigest()[:16]
    return [BUILD_DIR / f"{src.stem}_{tag}.so" for src in sources()]


@timed("kernels.build")
def build() -> list:
    """Compile every source that has no build of this key yet, one nvcc
    each, all started at once; returns the shared libraries.  nvcc's
    -Xptxas -v report is kept beside each.  Timed as ``kernels.build``
    (``utils.metrics.TOTALS``, the nvcc runs as its compiles)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src, so in zip(sources(), library_paths()):
        if so.exists():
            continue
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((src, so, tmp, proc))
    TOTALS["kernels.build"]["compiles"] += len(jobs)
    failed = []
    for src, so, tmp, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{err}")
            continue
        so.with_suffix(".ptxas.txt").write_text(out + err)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("odgi_tpu_torch: nvcc failed: " + "\n".join(failed))
    return library_paths()


def ptxas_report() -> str:
    """nvcc -Xptxas -v output of the current build, every source."""
    return "\n".join(so.with_suffix(".ptxas.txt").read_text() for so in library_paths())


def _fn(name: str):
    """The C entry `name`, from whichever library defines it."""
    if not _fns:
        _load()
    return _fns[name]


@timed("kernels.build")
def _load() -> None:
    """Build the libraries and bind every C entry they define."""
    for so in build():
        lib = ctypes.CDLL(str(so))
        for n, argtypes in SIGNATURES.items():
            if hasattr(lib, n):
                fn = getattr(lib, n)
                fn.argtypes = argtypes
                fn.restype = I
                _fns[n] = fn
        for n, (argtypes, restype) in QUERIES.items():
            if hasattr(lib, n):
                fn = getattr(lib, n)
                fn.argtypes = argtypes
                fn.restype = restype
                _fns[n] = fn


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"odgi_tpu_torch kernel arguments: {what}")


def _check(tensors: dict, device) -> None:
    dtypes = {
        "drift": torch.float32, "base": torch.float32, "planes": torch.int32,
        "od": torch.int32, "eta": torch.float32, "ep": torch.int32,
        "csr_off": torch.int32, "csr_slot": torch.int32,
        "recip": torch.float64, "coords": torch.float64, "upd": torch.float64,
        "tile": torch.int32, "block": torch.int32,
        "blk_off": torch.int32, "perm": torch.int32, "lvl_off": torch.int32,
        "pred_off": torch.int32, "pred": torch.int32, "dmax": torch.float32,
    }
    for name, t in tensors.items():
        _require(t.device == device, f"{name} is on {t.device}, not {device}")
        _require(t.dtype == dtypes[name], f"{name} must be {dtypes[name]}")
        _require(t.is_contiguous(), f"{name} must be contiguous")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _launched(name: str, err: int) -> None:
    LAUNCHES[name] += 1
    if err != 0:
        raise RuntimeError(f"odgi_tpu_torch: {name} launch failed: CUDA error {err}")


def _chunks(name: str, nplanes: int, drift, base, planes, od, eta, cpi, g0, cgs):
    _check(dict(drift=drift, base=base, planes=planes, od=od, eta=eta), drift.device)
    L = drift.shape[1]
    _require(drift.shape == base.shape and drift.shape[0] == (4 if nplanes == 4 else 1),
             "drift/base shape")
    _require(planes.shape == (nplanes, L), "planes shape")
    _require(od.dim() == 2 and od.shape[1] == 2 and 0 <= g0 and g0 + cgs <= od.shape[0],
             "od covers the group")
    _require(cgs > 0 and cpi > 0 and (g0 + cgs - 1) // cpi < eta.shape[0],
             "eta covers the group")
    err = _fn(name)(_ptr(drift), _ptr(base), _ptr(planes), L, _ptr(od), _ptr(eta),
                    int(cpi), int(g0), int(cgs), _stream(drift.device))
    _launched(name, err)


def strata_chunks_2d(drift, base, planes, od, eta, cpi: int, g0: int, cgs: int):
    """Chunk phase of one 2D merge group as a chain, in place on `drift`."""
    if drift.device.type == "cpu":
        return strata_sgd.chunks_2d_plain(drift, base, planes, od, eta, cpi, g0, cgs)
    _chunks("strata_chunks_2d", 4, drift, base, planes, od, eta, cpi, g0, cgs)


def strata_chunks_1d(drift, base, planes, od, eta, cpi: int, g0: int, cgs: int):
    """Chunk phase of one 1D merge group as a chain, in place on `drift`."""
    if drift.device.type == "cpu":
        return strata_sgd.chunks_1d_plain(drift, base, planes, od, eta, cpi, g0, cgs)
    _chunks("strata_chunks_1d", 3, drift, base, planes, od, eta, cpi, g0, cgs)


def strata_merge_sum(drift, mi, coords, upd):
    """Consensus sums into `upd` and the node coordinates `coords`."""
    if drift.device.type == "cpu":
        return strata_sgd.merge_sum_plain(drift, mi, coords, upd)
    _check(dict(drift=drift, csr_off=mi.csr_off, csr_slot=mi.csr_slot,
                recip=mi.recip, coords=coords, upd=upd), drift.device)
    nc, E = coords.shape
    L = drift.shape[1]
    _require(drift.shape[0] == (4 if nc == 2 else 1), "drift planes")
    _require(upd.shape == (nc, mi.ecap) and mi.csr_off.shape == (E + 1,)
             and mi.recip.shape == (E,), "merge index shapes")
    b = int(mi.block_eps)
    _require(1 <= b <= strata_sgd.SUM_THREADS and b & (b - 1) == 0 and (nc == 1 or b >= 2),
             "block_eps a power of two in [1, 256], even in 2D")
    err = _fn("strata_merge_sum")(
        _ptr(drift), L, _ptr(mi.csr_off), _ptr(mi.csr_slot), _ptr(mi.recip),
        _ptr(coords), _ptr(upd), int(E), int(mi.ecap), int(nc), b,
        _stream(drift.device))
    _launched("strata_merge_sum", err)


def strata_merge_bcast(drift, base, mi, upd):
    """Broadcast the last merge's update into `base`; reset `drift`.  Every
    route's broadcast: one pass over the slots, four a thread with 16-byte
    accesses (so L % 4 == 0, the tensors 16-byte aligned and, in 2D, ecap
    even: an endpoint's forward and reverse update are one 16-byte pair)."""
    if drift.device.type == "cpu":
        return strata_sgd.merge_bcast_plain(drift, base, mi, upd)
    tensors = dict(drift=drift, base=base, ep=mi.ep, upd=upd)
    _check(tensors, drift.device)
    nc = upd.shape[0]
    L = drift.shape[1]
    _require(base.shape == drift.shape and drift.shape[0] == (4 if nc == 2 else 1)
             and mi.ep.shape == (L,) and upd.shape == (nc, mi.ecap), "broadcast shapes")
    _require(L % 4 == 0 and (nc == 1 or mi.ecap % 2 == 0),
             "L a multiple of 4; 2D: ecap even")
    _require(all(t.data_ptr() % 16 == 0 for t in tensors.values()),
             "drift, base, ep and upd 16-byte aligned")
    err = _fn("strata_merge_bcast")(
        _ptr(drift), _ptr(base), L, _ptr(mi.ep), _ptr(upd), int(mi.ecap),
        int(nc), _stream(drift.device))
    _launched("strata_merge_bcast", err)


# The leveled kernels' scratch a device: [ticket, done word a chunk], zero
# at first, grown to the largest run seen; and the launch count, each
# launch's epoch (its done words' value; never 0).  The ticket ends every
# completed launch at 0 and a done word holds an earlier launch's epoch, so
# launches on one stream share them.
_FLOW: dict = {}
_EPOCH: dict = {}


def _flow(device, chunks: int) -> tuple:
    """The scratch of the leveled kernels on `device`, at least chunks + 1
    words, and the next launch's epoch."""
    flow = _FLOW.get(device)
    if flow is None or flow.shape[0] < chunks + 1:
        flow = _FLOW[device] = torch.zeros(chunks + 1, dtype=torch.int32, device=device)
    epoch = _EPOCH.get(device, 0) % 0xFFFFFFFF + 1
    _EPOCH[device] = epoch
    return flow, epoch


def _levels(name: str, nplanes: int, drift, base, planes, od, eta, cpi, perm, lvl_off,
            pred_off, pred, dmax=None) -> None:
    tensors = dict(drift=drift, base=base, planes=planes, od=od, eta=eta, perm=perm,
                   lvl_off=lvl_off, pred_off=pred_off, pred=pred)
    if dmax is not None:
        tensors["dmax"] = dmax
        _require(dmax.numel() == 1, "dmax is the group's one word")
    _check(tensors, drift.device)
    L = drift.shape[1]
    _require(drift.shape == base.shape and drift.shape[0] == (4 if nplanes == 4 else 1),
             "drift/base shape")
    _require(planes.shape == (nplanes, L), "planes shape")
    _require(od.dim() == 2 and od.shape[1] == 2, "od shape")
    _require(perm.shape == (od.shape[0],), "perm has one entry a chunk")
    _require(lvl_off.dim() == 1 and 2 <= lvl_off.shape[0] <= od.shape[0] + 1,
             "lvl_off holds 1 to chunks levels")
    _require(cpi > 0 and (od.shape[0] - 1) // cpi < eta.shape[0], "eta covers the chunks")
    _require(pred_off.shape == (od.shape[0] + 1,) and pred.dim() == 1,
             "pred_off has chunks + 1 offsets into pred")
    flow, epoch = _flow(drift.device, od.shape[0])
    err = _fn(name)(
        _ptr(drift), _ptr(base), _ptr(planes), L, _ptr(od), _ptr(eta), int(cpi),
        _ptr(perm), _ptr(lvl_off), int(lvl_off.shape[0] - 1), _ptr(pred_off), _ptr(pred),
        _ptr(flow), epoch, ctypes.c_void_p(None if dmax is None else dmax.data_ptr()),
        _stream(drift.device))
    _launched(name if dmax is None else TRACKED[name], err)


def strata_chunks_2d_levels(drift, base, planes, od, eta, cpi: int, perm, lvl_off, pred_off,
                            pred, dmax=None):
    """Chunk phase of one 2D merge group, in place on `drift`: the chunks
    perm[lvl_off[0]:lvl_off[-1]] (``ops/strata_levels.py``: one group's
    chunks by (level, index)), handed out in that order, each run by a
    thread-block cluster once its predecessors pred[pred_off[j]:pred_off[j
    + 1]] are done.  perm (chunks,) i32 and pred_off (chunks + 1,) i32 /
    pred i32 hold every chunk of the run; lvl_off (levels + 1,) i32 is the
    group's row of level offsets into perm.  Same result as
    `strata_chunks_2d`.  With `dmax` (a one-word f32 tensor, zero or a max
    so far) the tracking instance also raises it to the group's max |delta|
    over valid pairs."""
    if drift.device.type == "cpu":
        return strata_sgd.chunks_2d_levels_plain(drift, base, planes, od, eta, cpi, perm,
                                                 lvl_off, dmax)
    _levels("strata_chunks_2d_levels", 4, drift, base, planes, od, eta, cpi, perm, lvl_off,
            pred_off, pred, dmax)


def strata_chunks_1d_levels(drift, base, planes, od, eta, cpi: int, perm, lvl_off, pred_off,
                            pred, dmax=None):
    """Chunk phase of one 1D merge group, in place on `drift`, as
    `strata_chunks_2d_levels` (`dmax` too).  Same result as
    `strata_chunks_1d`."""
    if drift.device.type == "cpu":
        return strata_sgd.chunks_1d_levels_plain(drift, base, planes, od, eta, cpi, perm,
                                                 lvl_off, dmax)
    _levels("strata_chunks_1d_levels", 3, drift, base, planes, od, eta, cpi, perm, lvl_off,
            pred_off, pred, dmax)


def levels_clusters(one_d: bool = False) -> tuple:
    """(clusters, blocks a cluster) of the 2D (or 1D) leveled kernel's grid
    on the current card: the clusters that fit at once."""
    return (int(_fn("strata_chunks_levels_clusters")(int(bool(one_d)))),
            int(_fn("strata_chunks_levels_cluster_blocks")(int(bool(one_d)))))


def _check_schedule(drift, mi, bsch, E: int) -> None:
    _check(dict(tile=bsch.tile, block=bsch.block, blk_off=bsch.blk_off), drift.device)
    K = bsch.num_entries
    _require(K > 0 and bsch.block.shape == (K,), "schedule entries")
    _require(bsch.bs > 0 and bsch.bs % 2 == 0, "block size is even")
    _require(bsch.num_blocks * bsch.bs >= E, "the blocks cover every endpoint")
    _require(0 < bsch.num_steps <= drift.shape[1] and mi.ep.shape == (drift.shape[1],),
             "step count within the planes")
    _require(drift.shape[1] % strata_xxl.TILE == 0, "planes are whole tiles")


def strata_merge_sum_blocked(drift, mi, bsch, coords, upd):
    """Consensus sums of the XXL route: the result of `strata_merge_sum`,
    node block by node block of the schedule `bsch`, each gathering its
    slots' drift over its span of the CSR (the schedule's tiles are not
    read: a fold in CSR order reads each slot directly)."""
    if drift.device.type == "cpu":
        return strata_sgd.merge_sum_blocked_plain(drift, mi, bsch, coords, upd)
    _check(dict(drift=drift, csr_off=mi.csr_off, csr_slot=mi.csr_slot,
                recip=mi.recip, coords=coords, upd=upd), drift.device)
    nc, E = coords.shape
    L = drift.shape[1]
    _require(drift.shape[0] == (4 if nc == 2 else 1), "drift planes")
    _require(upd.shape == (nc, mi.ecap) and mi.csr_off.shape == (E + 1,)
             and mi.recip.shape == (E,), "merge index shapes")
    _check_schedule(drift, mi, bsch, E)
    err = _fn("strata_merge_sum_blocked")(
        _ptr(drift), L, _ptr(mi.csr_off), _ptr(mi.csr_slot), _ptr(mi.recip),
        _ptr(coords), _ptr(upd), int(E), int(mi.ecap), int(nc), int(bsch.num_blocks),
        int(bsch.bs), _stream(drift.device))
    _launched("strata_merge_sum_blocked", err)
