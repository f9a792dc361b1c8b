#!/usr/bin/env python3
"""The consensus broadcast's designs, timed on the 1M-node graph's merges.

    python3 tools/bcast_variants.py [--parent DIR] [--reps 6]

On chip_smoke.py's 1M-node graph (10 paths x 1,000,000 steps, the "xxl"
route, relabeled by first visit), 1D and 2D, with a random update table
(numpy seed 3; zero past the real endpoints, as the sums leave it), this
times on the same inputs, in turns and each behind chip_smoke.py's spin
kernel:
  - ``port``: strata_merge_bcast as the package builds it (csrc/strata_sgd.cu);
  - variants of its design, compiled here from VARIANTS: with and without
    the streaming cache hints (``__ldcs`` / ``__stcs`` on the endpoints,
    base and drift), with an L2 access-policy window that keeps the update
    table resident, at several grid sizes (grid-stride, a multiple of the
    SM count) or one thread a 4-slot group (one-shot), and, in 2D, with the
    update table packed as f32 (one 16-byte float4 {x_e, x_e^1, y_e,
    y_e^1} an endpoint pair, built here and not timed; the sums would have
    to write it);
  - ``evict_last_table``: the streaming hints, and the table gathers
    marked L2 evict-last through a ``createpolicy`` cache hint (its own
    source, VARIANTS_EVICT_LAST; skipped if nvcc refuses it);
  - ``diag_stream_only``: the same accesses without the table gathers (a
    zero update), the streaming part alone; not the broadcast's function,
    so not checked;
  - with ``--parent DIR`` (a checkout of an earlier commit of this repo),
    that checkout's strata_merge_bcast and, where it has one,
    strata_merge_bcast_blocked, built from DIR/odgi_tpu_torch/csrc.
The designs run in two sets a dimension, each in alternating rounds: first
every design without an L2 window, then the window designs with ``port``
beside them (the window's set-aside of persisting L2 is device-wide; it is
put back to 0 after each window launch).  nvidia-smi's SM and memory clocks
and power draw are sampled around each set.  Every design but the
diagnostic one must give merge_bcast_plain's base bit for bit and a zero
drift.  Prints one JSON line per dimension (each design's mean,
min and every time in ms, the bound of chip_smoke.merge_bcast_bound, the
clocks), then the card's name and power limit; exits non-zero on a
mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from odgi_tpu_torch.ops import kernels, strata_sgd  # noqa: E402
from odgi_tpu_torch.ops.sgd import derive_config_1d, derive_config_2d  # noqa: E402

VARIANTS = r"""
#include <cuda_runtime.h>

template <bool HINTS, class T>
__device__ __forceinline__ T load(const T* p) { if constexpr (HINTS) return __ldcs(p); else return *p; }
template <bool HINTS, class T>
__device__ __forceinline__ void store(T* p, T v) { if constexpr (HINTS) __stcs(p, v); else *p = v; }

template <int NC, bool HINTS, bool GATHER>
__global__ void __launch_bounds__(256)
bcast_var(float* __restrict__ drift, float* __restrict__ base, long long L,
          const int* __restrict__ ep, const double* __restrict__ upd, int ecap) {
  const long long n4 = L >> 2;
  const int4* ep4 = reinterpret_cast<const int4*>(ep);
  float4* b4 = reinterpret_cast<float4*>(base);
  float4* d4 = reinterpret_cast<float4*>(drift);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long q = (long long)blockIdx.x * 256 + threadIdx.x; q < n4;
       q += (long long)gridDim.x * 256) {
    const int4 e4 = load<HINTS>(ep4 + q);
    const int e[4] = {e4.x, e4.y, e4.z, e4.w};
    if constexpr (NC == 1) {
      float u[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) u[i] = GATHER ? (float)__ldg(upd + e[i]) : 0.0f;
      float4 b = load<HINTS>(b4 + q);
      b = make_float4(b.x + u[0], b.y + u[1], b.z + u[2], b.w + u[3]);
      store<HINTS>(b4 + q, b);
      store<HINTS>(d4 + q, zero);
    } else {
      const double2* u0 = reinterpret_cast<const double2*>(upd);
      const double2* u1 = reinterpret_cast<const double2*>(upd + ecap);
      float u[4][4];  // [plane][slot]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const double2 z = make_double2(0.0, 0.0);
        const double2 x = GATHER ? __ldg(u0 + (e[i] >> 1)) : z;
        const double2 y = GATHER ? __ldg(u1 + (e[i] >> 1)) : z;
        const bool odd = e[i] & 1;
        u[0][i] = (float)(odd ? x.y : x.x);
        u[1][i] = (float)(odd ? x.x : x.y);
        u[2][i] = (float)(odd ? y.y : y.x);
        u[3][i] = (float)(odd ? y.x : y.y);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float4 b = load<HINTS>(b4 + p * n4 + q);
        b = make_float4(b.x + u[p][0], b.y + u[p][1], b.z + u[p][2], b.w + u[p][3]);
        store<HINTS>(b4 + p * n4 + q, b);
        store<HINTS>(d4 + p * n4 + q, zero);
      }
    }
  }
}

// 2D with the update table packed as f32: upd32[k] = {x_2k, x_2k+1, y_2k, y_2k+1}.
template <bool HINTS>
__global__ void __launch_bounds__(256)
bcast_packed(float* __restrict__ drift, float* __restrict__ base, long long L,
             const int* __restrict__ ep, const float4* __restrict__ upd32) {
  const long long n4 = L >> 2;
  const int4* ep4 = reinterpret_cast<const int4*>(ep);
  float4* b4 = reinterpret_cast<float4*>(base);
  float4* d4 = reinterpret_cast<float4*>(drift);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long q = (long long)blockIdx.x * 256 + threadIdx.x; q < n4;
       q += (long long)gridDim.x * 256) {
    const int4 e4 = load<HINTS>(ep4 + q);
    const int e[4] = {e4.x, e4.y, e4.z, e4.w};
    float u[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = __ldg(upd32 + (e[i] >> 1));
      const bool odd = e[i] & 1;
      u[0][i] = odd ? v.y : v.x;
      u[1][i] = odd ? v.x : v.y;
      u[2][i] = odd ? v.w : v.z;
      u[3][i] = odd ? v.z : v.w;
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float4 b = load<HINTS>(b4 + p * n4 + q);
      b = make_float4(b.x + u[p][0], b.y + u[p][1], b.z + u[p][2], b.w + u[p][3]);
      store<HINTS>(b4 + p * n4 + q, b);
      store<HINTS>(d4 + p * n4 + q, zero);
    }
  }
}

extern "C" {

// blocks 0: one thread a 4-slot group.  gather 0: no table reads (a zero
// update; the streaming part alone).  window_bytes > 0: an L2
// access-policy window (persisting) over the first window_bytes of upd.
int bcast_variant(void* drift, void* base, long long L, const void* ep, const void* upd,
                  int ecap, int nc, int hints, int gather, int blocks,
                  long long window_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (window_bytes > 0) {
    int dev = 0, max_persist = 0, max_window = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&max_persist, cudaDevAttrMaxPersistingL2CacheSize, dev);
    cudaDeviceGetAttribute(&max_window, cudaDevAttrMaxAccessPolicyWindowSize, dev);
    cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, (size_t)max_persist);
    cudaStreamAttrValue v = {};
    v.accessPolicyWindow.base_ptr = const_cast<void*>(upd);
    v.accessPolicyWindow.num_bytes = (size_t)(window_bytes < max_window ? window_bytes : max_window);
    const double ratio = (double)max_persist / (double)v.accessPolicyWindow.num_bytes;
    v.accessPolicyWindow.hitRatio = ratio < 1.0 ? (float)ratio : 1.0f;
    v.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
    v.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
    cudaError_t err = cudaStreamSetAttribute(st, cudaStreamAttributeAccessPolicyWindow, &v);
    if (err != cudaSuccess) return (int)err;
  }
  const long long n4 = L / 4;
  const unsigned grid = blocks > 0 ? (unsigned)blocks : (unsigned)((n4 + 255) / 256);
#define LAUNCH(NCV, H, G) bcast_var<NCV, H, G><<<grid, 256, 0, st>>>((float*)drift, \
      (float*)base, L, (const int*)ep, (const double*)upd, ecap)
  if (!gather) { if (nc == 1) LAUNCH(1, true, false); else LAUNCH(2, true, false); }
  else if (nc == 1) { if (hints) LAUNCH(1, true, true); else LAUNCH(1, false, true); }
  else { if (hints) LAUNCH(2, true, true); else LAUNCH(2, false, true); }
#undef LAUNCH
  return (int)cudaGetLastError();
}

int bcast_packed_variant(void* drift, void* base, long long L, const void* ep,
                         const void* upd32, int hints, int blocks, void* stream) {
  const long long n4 = L / 4;
  const unsigned grid = blocks > 0 ? (unsigned)blocks : (unsigned)((n4 + 255) / 256);
  if (hints)
    bcast_packed<true><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (float*)drift, (float*)base, L, (const int*)ep, (const float4*)upd32);
  else
    bcast_packed<false><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (float*)drift, (float*)base, L, (const int*)ep, (const float4*)upd32);
  return (int)cudaGetLastError();
}

// Ends the window of bcast_variant, drops the persisting lines and gives
// the set-aside back.
int bcast_window_off(void* stream) {
  cudaStreamAttrValue v = {};
  v.accessPolicyWindow.num_bytes = 0;
  cudaError_t err = cudaStreamSetAttribute((cudaStream_t)stream,
                                           cudaStreamAttributeAccessPolicyWindow, &v);
  if (err != cudaSuccess) return (int)err;
  err = cudaCtxResetPersistingL2Cache();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, 0);
}

}  // extern "C"
"""

VARIANTS_EVICT_LAST = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}
__device__ __forceinline__ double ld_last(const double* p, uint64_t pol) {
  double v;
  asm volatile("ld.global.nc.L2::cache_hint.f64 %0, [%1], %2;" : "=d"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ double2 ld_last2(const double2* p, uint64_t pol) {
  double2 v;
  asm volatile("ld.global.nc.L2::cache_hint.v2.f64 {%0, %1}, [%2], %3;"
               : "=d"(v.x), "=d"(v.y) : "l"(p), "l"(pol));
  return v;
}

template <int NC>
__global__ void __launch_bounds__(256)
bcast_el(float* __restrict__ drift, float* __restrict__ base, long long L,
         const int* __restrict__ ep, const double* __restrict__ upd, int ecap) {
  const uint64_t pol = evict_last_policy();
  const long long n4 = L >> 2;
  const int4* ep4 = reinterpret_cast<const int4*>(ep);
  float4* b4 = reinterpret_cast<float4*>(base);
  float4* d4 = reinterpret_cast<float4*>(drift);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long q = (long long)blockIdx.x * 256 + threadIdx.x; q < n4;
       q += (long long)gridDim.x * 256) {
    const int4 e4 = __ldcs(ep4 + q);
    const int e[4] = {e4.x, e4.y, e4.z, e4.w};
    float u[4][4];
    if constexpr (NC == 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) u[0][i] = (float)ld_last(upd + e[i], pol);
    } else {
      const double2* u0 = reinterpret_cast<const double2*>(upd);
      const double2* u1 = reinterpret_cast<const double2*>(upd + ecap);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const double2 x = ld_last2(u0 + (e[i] >> 1), pol), y = ld_last2(u1 + (e[i] >> 1), pol);
        const bool odd = e[i] & 1;
        u[0][i] = (float)(odd ? x.y : x.x);
        u[1][i] = (float)(odd ? x.x : x.y);
        u[2][i] = (float)(odd ? y.y : y.x);
        u[3][i] = (float)(odd ? y.x : y.y);
      }
    }
#pragma unroll
    for (int p = 0; p < (NC == 1 ? 1 : 4); ++p) {
      float4 b = __ldcs(b4 + p * n4 + q);
      b = make_float4(b.x + u[p][0], b.y + u[p][1], b.z + u[p][2], b.w + u[p][3]);
      __stcs(b4 + p * n4 + q, b);
      __stcs(d4 + p * n4 + q, zero);
    }
  }
}

extern "C" int bcast_evict_last(void* drift, void* base, long long L, const void* ep,
                                const void* upd, int ecap, int nc, int blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nc == 1)
    bcast_el<1><<<blocks, 256, 0, st>>>((float*)drift, (float*)base, L, (const int*)ep,
                                       (const double*)upd, ecap);
  else
    bcast_el<2><<<blocks, 256, 0, st>>>((float*)drift, (float*)base, L, (const int*)ep,
                                       (const double*)upd, ecap);
  return (int)cudaGetLastError();
}
"""

P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGS = {
    "bcast_variant": [P, P, LL, P, P, I, I, I, I, I, LL, P],
    "bcast_packed_variant": [P, P, LL, P, P, I, I, P],
    "bcast_evict_last": [P, P, LL, P, P, I, I, I, P],
    "bcast_window_off": [P],
    "strata_merge_bcast": [P, P, LL, P, P, I, I, P],
    "strata_merge_bcast_blocked": [P, P, LL, P, P, I, I, I, P, P, I, I, LL, P],
}


def build_libs(parent: str | None, out: str) -> dict:
    """nvcc, one process a source, all at once: VARIANTS,
    VARIANTS_EVICT_LAST and the parent's strata_sgd.cu / strata_blocked.cu.
    Returns the C entries by "label:name"."""
    jobs = {}
    for label, text in (("variants", VARIANTS), ("evict_last", VARIANTS_EVICT_LAST)):
        jobs[label] = os.path.join(out, f"bcast_{label}.cu")
        with open(jobs[label], "w") as f:
            f.write(text)
    if parent:
        csrc = os.path.join(parent, "odgi_tpu_torch", "csrc")
        for stem in ("strata_sgd", "strata_blocked"):
            jobs[f"parent_{stem}"] = os.path.join(csrc, f"{stem}.cu")
    procs = {}
    for label, path in jobs.items():
        so = os.path.join(out, f"{label}.so")
        procs[label] = (so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    fns = {}
    for label, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            if label == "evict_last":
                print(json.dumps(dict(skipped=label, nvcc=err[-2000:])), flush=True)
                continue
            raise RuntimeError(f"nvcc {label}: {err}")
        lib = ctypes.CDLL(so)
        for name, argtypes in SIGS.items():
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, I
                fns[f"{label}:{name}"] = fn
    return fns


def state_of(g, one_d: bool, dev):
    """The xxl route's state of `g` at a short plan (the broadcast's work
    depends on the planes and the endpoints only), with a random update."""
    if one_d:
        cfg = derive_config_1d(g, iter_max=2, min_term_updates=cs.SHORT_TERMS)
        init = g.node_offset.astype(np.float32)
    else:
        cfg = derive_config_2d(g, iter_max=2, min_term_updates=cs.SHORT_TERMS)
        init = cs.ot.init_layout(g, "d")
    st = strata_sgd.StrataState.build(g, cfg, init, one_d, dev, "xxl")
    E = st.mi.recip.shape[0]
    rng = np.random.default_rng(3)
    upd = np.zeros(tuple(st.upd.shape))
    upd[:, :E] = rng.normal(size=(upd.shape[0], E)) * 10.0
    st.upd.copy_(torch.from_numpy(upd))
    st.drift.fill_(1.0)  # every design must reset it
    return st


def designs(st, fns: dict, sms: int) -> dict:
    """label -> fn(drift, base) launching that design on the state."""
    L, nc, ecap = st.drift.shape[1], st.upd.shape[0], st.mi.ecap
    stream = lambda: kernels._stream(st.drift.device)
    ptr, ep, upd = kernels._ptr, st.mi.ep, st.upd

    def check(err):
        if err != 0:
            raise RuntimeError(f"CUDA error {err}")

    def variant(hints, blocks, window=0, gather=1):
        fn = fns["variants:bcast_variant"]
        return lambda d, b: check(fn(ptr(d), ptr(b), L, ptr(ep), ptr(upd), ecap, nc, hints,
                                     gather, blocks, window, stream()))

    out = {"port": lambda d, b: kernels.strata_merge_bcast(d, b, st.mi, upd)}
    for k in (6, 8, 16):
        out[f"hints_grid{k}"] = variant(1, k * sms)
    out["hints_oneshot"] = variant(1, 0)
    out["nohints_grid6"] = variant(0, 6 * sms)
    out["nohints_oneshot"] = variant(0, 0)
    table = upd.numel() * 8
    out["window_grid6"] = variant(0, 6 * sms, table)
    out["hints_window_grid6"] = variant(1, 6 * sms, table)
    out["diag_stream_only"] = variant(1, 6 * sms, gather=0)
    last = fns.get("evict_last:bcast_evict_last")
    if last is not None:
        out["evict_last_table"] = lambda d, b: check(last(ptr(d), ptr(b), L, ptr(ep), ptr(upd),
                                                          ecap, nc, 6 * sms, stream()))
    if nc == 2:
        upd32 = torch.stack([upd[0, 0::2], upd[0, 1::2], upd[1, 0::2], upd[1, 1::2]],
                            1).to(torch.float32).contiguous()
        packed = fns["variants:bcast_packed_variant"]
        for label, blocks in (("packed_f32_grid6", 6 * sms), ("packed_f32_oneshot", 0)):
            out[label] = (lambda blocks: lambda d, b: check(packed(
                ptr(d), ptr(b), L, ptr(ep), ptr(upd32), 1, blocks, stream())))(blocks)
    flat = fns.get("parent_strata_sgd:strata_merge_bcast")
    if flat is not None:
        out["parent_flat"] = lambda d, b: check(flat(ptr(d), ptr(b), L, ptr(ep), ptr(upd),
                                                     ecap, nc, stream()))
    blocked = fns.get("parent_strata_blocked:strata_merge_bcast_blocked")
    if blocked is not None:
        bs = st.bsch
        out["parent_blocked"] = lambda d, b: check(blocked(
            ptr(d), ptr(b), L, ptr(ep), ptr(upd), st.mi.recip.shape[0], ecap, nc,
            ptr(bs.tile), ptr(bs.block), bs.num_entries, bs.bs, bs.num_steps, stream()))
    return out


def clocks() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def time_designs(st, runs: dict, reps: int, window_off) -> dict:
    """Each design's times in alternating rounds (round 0 warms up,
    untimed), the designs without an L2 window first, then the window
    designs beside `port`; each set's clocks before and after."""
    want_b, want_d = st.base.clone(), st.drift.clone()
    strata_sgd.merge_bcast_plain(want_d, want_b, st.mi, st.upd)
    res, sets = {}, []
    plain = [k for k in runs if "window" not in k]
    windowed = ["port"] + [k for k in runs if "window" in k]
    for name, order in (("no_window", plain), ("window", windowed)):
        ms = {k: [] for k in order}
        before = clocks()
        for r in range(reps + 1):
            for k in (order if r % 2 else order[::-1]):
                d, b = st.drift.clone(), st.base.clone()
                t = cs.timed(runs[k], d, b)
                if "window" in k:
                    window_off()
                torch.cuda.synchronize()
                if not k.startswith("diag_") and not (torch.equal(b, want_b) and not d.any()):
                    cs.fail(f"{k}: differs from merge_bcast_plain")
                if r:
                    ms[k].append(t)
        sets.append(dict(set=name, clocks_before=before, clocks_after=clocks()))
        for k, v in ms.items():
            res[k if name == "no_window" or k != "port" else "port_in_window_set"] = dict(
                mean_ms=sum(v) / len(v), min_ms=min(v), ms=v)
    return dict(designs=res, sets=sets)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit, for its kernels")
    ap.add_argument("--reps", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bcast_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kernels.build()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        fns = build_libs(args.parent, tmp)
        build_s = time.perf_counter() - t0
        window_off = lambda: fns["variants:bcast_window_off"](kernels._stream(dev))
        g = cs.shuffled_graph(cs.BIG_STEPS, cs.BIG_NODES, cs.BIG_PATH_STEPS)
        g_run, _ = cs.strata_xxl.relabel(g)
        for one_d in (True, False):
            st = state_of(g, one_d, dev)
            L = st.drift.shape[1]
            bound, by = cs.bound_ms(cs.merge_bcast_bound(g_run, L, one_d))
            res = time_designs(st, designs(st, fns, sms), args.reps, window_off)
            print(json.dumps(dict(graph="big", dim="1d" if one_d else "2d", slots=L,
                                  endpoints=int(st.mi.recip.shape[0]), bound_ms=bound,
                                  bound_by=by, build_s=build_s, reps=args.reps, **res)),
                  flush=True)
            del st
            torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
