"""Quantized zeta tables for the Zipf jump distances of PG-SGD (host).

A copy of ``zeta_table`` and ``zeta_eta_table`` from ``odgi_tpu/ops/zipf.py``:
index i (1..space_max) holds zeta(i); index space_max+1+k holds
zeta(space_max + k*quant_step).  The strata plan reads one entry of each
(``strata_plan._zeta_consts``), so the values must match bit for bit.
"""

from __future__ import annotations

import numpy as np


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
