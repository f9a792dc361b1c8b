"""Quantized zeta tables and Zipf draws for the jump distances of PG-SGD.

A copy of ``odgi_tpu/ops/zipf.py``.  ``zeta_table`` and ``zeta_eta_table``
run on the host: index i (1..space_max) holds zeta(i); index
space_max+1+k holds zeta(space_max + k*quant_step).  The strata plan reads
one entry of each (``strata_plan._zeta_consts``), so the values must match
bit for bit.  ``zeta_index`` and ``zipf_sample`` are the batched sampler's
per-lane f32 tensor functions (``ops/batched_sgd.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def zeta_table(space: int, space_max: int, quant_step: int, theta: float) -> np.ndarray:
    """Quantized zeta partial-sum table in f64 (chunked cumsum)."""
    n_entries = (
        space
        if space <= space_max
        else space_max + (space - space_max) // quant_step + 1
    ) + 1
    zetas = np.zeros(n_entries, dtype=np.float64)
    running = 0.0
    chunk = 1 << 22
    for lo in range(1, space + 1, chunk):
        hi = min(space + 1, lo + chunk)
        i = np.arange(lo, hi, dtype=np.float64)
        z = running + np.cumsum(np.power(1.0 / i, theta))
        running = z[-1]
        hi_exact = min(hi, space_max + 1)
        if lo < hi_exact:
            zetas[lo:hi_exact] = z[: hi_exact - lo]
        # quantized region: i >= space_max and (i - space_max) % step == 0
        if space > space_max:
            idx = np.arange(lo, hi)
            q = (idx >= space_max) & ((idx - space_max) % quant_step == 0)
            q &= space_max + 1 + (idx - space_max) // quant_step < len(zetas)
            if q.any():
                zetas[space_max + 1 + (idx[q] - space_max) // quant_step] = z[q]
    return zetas


def zeta_eta_table(space: int, space_max: int, quant_step: int, theta: float) -> np.ndarray:
    """(T, 2) f32 table of [zeta(s_i), eta(s_i)] per zeta-table entry, where
    eta(n) = (1 - (2/n)^(1-theta)) / (1 - zeta(2)/zeta(n)) is the per-space
    constant of the closed-form Zipf inversion."""
    zetas = zeta_table(space, space_max, quant_step, theta)
    n_entries = len(zetas)
    s = np.arange(n_entries, dtype=np.float64)
    if space > space_max:
        q = s > space_max
        s[q] = space_max + (s[q] - space_max - 1) * quant_step
    s = np.maximum(s, 1.0)
    zeta2 = zetas[2] if n_entries > 2 else 1.0
    denom = 1.0 - np.divide(zeta2, zetas, out=np.ones_like(zetas), where=zetas != 0)
    denom = np.where(denom == 0.0, 1e-9, denom)
    eta = (1.0 - np.power(2.0 / s, 1.0 - theta)) / denom
    return np.stack([zetas, eta], axis=1).astype(np.float32)


def zeta_index(jump_space: torch.Tensor, space_max: int, quant_step: int) -> torch.Tensor:
    """The zeta-table index of each jump space (i32 tensor): the space
    itself up to space_max, past it the quantized entry.  The divide runs
    as an f32 multiply, as the JAX package's does."""
    q = (jump_space - space_max).to(torch.float32) * _f32(1.0 / quant_step)
    quantized = space_max + 1 + torch.floor(q).to(torch.int32)
    return torch.where(jump_space > space_max, quantized, jump_space)


def zipf_sample(u: torch.Tensor, n: torch.Tensor, theta: float, zetan: torch.Tensor,
                eta: torch.Tensor) -> torch.Tensor:
    """Closed-form Zipf(n, theta) draws in [1, n] from f32 uniforms `u`, with
    each lane's zeta(n) and eta(n) from `zeta_eta_table`; all in f32, as
    the JAX package's `zipf_sample`.  The power is exp2(alpha * log2(x))
    written as XLA lowers it, exp((alpha * (log(x) * (1/ln 2))) * ln 2);
    XLA's own log and exp differ from PyTorch's in the last bits, so a
    rare lane's floor lands one step off."""
    nf = n.to(torch.float32)
    x = eta * u - eta + 1.0
    log2x = torch.log(x) * _f32(1.0 / math.log(2.0))
    powx = torch.exp((_f32(1.0 / (1.0 - theta)) * log2x) * _f32(math.log(2.0)))
    uz = u * zetan
    two_at = 1.0 + _pow_f32(0.5, theta)
    val = torch.where(uz < 1.0, 1.0, torch.where(uz < two_at, 2.0, 1.0 + nf * powx))
    return torch.minimum(torch.clamp_min(torch.floor(val).to(torch.int32), 1),
                         n.to(torch.int32))


def _f32(v: float) -> float:
    """`v` rounded to f32.  A Python scalar meets an f32 tensor in f32
    arithmetic, so this multiplies as an f32 constant would, with no
    host-to-device copy."""
    return float(np.float32(v))


def _pow_f32(x: float, y: float) -> float:
    """f32 x**y, computed in f32 on the host."""
    return float(torch.pow(torch.tensor(np.float32(x)), torch.tensor(np.float32(y))))
