"""The strata PG-SGD CUDA kernels: build, ctypes binding and wrappers.

``csrc/strata_sgd.cu`` is compiled with nvcc at first use into
``odgi_tpu_torch/_build/`` (keyed by a hash of the source and the flags)
and loaded with ``ctypes``.  Each wrapper takes its kernel's plain PyTorch
version from ``ops/strata_sgd.py`` when the tensors lie on the CPU; for
CUDA tensors it launches the kernel on the current stream or raises.  A
wrapper adds one to ``LAUNCHES[name]`` for every kernel launch, and only
there.

Kernel                TPU kernel it replaces (odgi_tpu/ops/pallas_sgd.py)
strata_chunks_2d      _make_kernel_2d, chunk phase (_chunk_2d)
strata_chunks_1d      _make_kernel_1d, chunk phase (_chunk_1d)
strata_merge_sum      _merge_tiles_2d / _merge_tiles_1d, the sums
strata_merge_bcast    _merge_tiles_2d / _merge_tiles_1d, the broadcast
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from . import strata_sgd

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "strata_sgd.cu"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)
NAMES = ("strata_chunks_2d", "strata_chunks_1d", "strata_merge_sum",
         "strata_merge_bcast")

LAUNCHES = {name: 0 for name in NAMES}

_lib = None


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


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"strata_sgd_{key.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a build of this source exists; returns
    the shared library.  nvcc's -Xptxas -v report is kept beside it."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"odgi_tpu_torch: nvcc failed ({res.returncode}):\n{res.stderr}"
        )
    so.with_suffix(".ptxas.txt").write_text(res.stdout + res.stderr)
    os.replace(tmp, so)
    return so


def ptxas_report() -> str:
    """nvcc -Xptxas -v output of the current build."""
    return library_path().with_suffix(".ptxas.txt").read_text()


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name in ("strata_chunks_2d", "strata_chunks_1d"):
            fn = getattr(lib, name)
            fn.argtypes = [P, P, P, LL, P, P, I, I, I, P]
            fn.restype = I
        lib.strata_merge_sum.argtypes = [P, LL, P, P, P, P, P, I, I, I, P]
        lib.strata_merge_sum.restype = I
        lib.strata_merge_bcast.argtypes = [P, P, LL, P, P, I, I, P]
        lib.strata_merge_bcast.restype = I
        _lib = lib
    return _lib


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"odgi_tpu_torch kernel arguments: {what}")


def _check(tensors: dict, device) -> None:
    dtypes = {
        "drift": torch.float32, "base": torch.float32, "planes": torch.int32,
        "od": torch.int32, "eta": torch.float32, "ep": torch.int32,
        "csr_off": torch.int32, "csr_slot": torch.int32,
        "recip": torch.float64, "coords": torch.float64, "upd": torch.float64,
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
    fn = getattr(_load(), name)
    err = fn(_ptr(drift), _ptr(base), _ptr(planes), L, _ptr(od), _ptr(eta),
             int(cpi), int(g0), int(cgs), _stream(drift.device))
    _launched(name, err)


def strata_chunks_2d(drift, base, planes, od, eta, cpi: int, g0: int, cgs: int):
    """Chunk phase of one 2D merge group, in place on `drift`."""
    if drift.device.type == "cpu":
        return strata_sgd.chunks_2d_plain(drift, base, planes, od, eta, cpi, g0, cgs)
    _chunks("strata_chunks_2d", 4, drift, base, planes, od, eta, cpi, g0, cgs)


def strata_chunks_1d(drift, base, planes, od, eta, cpi: int, g0: int, cgs: int):
    """Chunk phase of one 1D merge group, in place on `drift`."""
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
    err = _load().strata_merge_sum(
        _ptr(drift), L, _ptr(mi.csr_off), _ptr(mi.csr_slot), _ptr(mi.recip),
        _ptr(coords), _ptr(upd), int(E), int(mi.ecap), int(nc),
        _stream(drift.device))
    _launched("strata_merge_sum", err)


def strata_merge_bcast(drift, base, mi, upd):
    """Broadcast the last merge's update into `base`; reset `drift`."""
    if drift.device.type == "cpu":
        return strata_sgd.merge_bcast_plain(drift, base, mi, upd)
    _check(dict(drift=drift, base=base, ep=mi.ep, upd=upd), drift.device)
    nc = upd.shape[0]
    L = drift.shape[1]
    _require(base.shape == drift.shape and mi.ep.shape == (L,)
             and upd.shape == (nc, mi.ecap), "broadcast shapes")
    err = _load().strata_merge_bcast(
        _ptr(drift), _ptr(base), L, _ptr(mi.ep), _ptr(upd), int(mi.ecap),
        int(nc), _stream(drift.device))
    _launched("strata_merge_bcast", err)
