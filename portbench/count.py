"""The least time a job's PG-SGD needs on the card, from ``count.json`` and
the benchmark's own plan of the job (``plan.py``), never from the
program's plan objects."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from . import plan as pl

COUNT = json.loads((Path(__file__).resolve().parent / "count.json").read_text())


class Counter:
    """Per graph: the step -> node map on `device`."""

    def __init__(self, f: dict, device):
        self.f = f
        self.dev = torch.device(device)
        self.node = torch.as_tensor(f["step_handle"] >> 1, device=self.dev)
        self.S, self.N = len(f["step_handle"]), len(f["node_len"])

    def least_s(self, seed: int, one_d: bool) -> float:
        """Summed over the merge groups of the job with PG-SGD seed `seed`:
        max(bytes / HBM rate, operations / f32 rate)."""
        w = COUNT["1d" if one_d else "2d"]
        peak = COUNT["peak"]
        cfg = pl.derive_1d(self.f, seed) if one_d else pl.derive_2d(self.f, seed)
        p = pl.plan(self.f, cfg, one_d)
        cgs = p["cgs"]
        valid = pl.valid_pairs(self.f["path_offset"], p["o"], p["d"])
        o = torch.as_tensor(p["o"].astype(np.int64) * pl.LANE, device=self.dev)
        d = torch.as_tensor(p["d"].astype(np.int64), device=self.dev)
        steps = torch.empty(p["groups"], dtype=torch.int64, device=self.dev)
        nodes = torch.empty_like(steps)
        one = torch.ones(2 * cgs, dtype=torch.int32, device=self.dev)
        for g in range(p["groups"]):
            og, dg = o[g * cgs:(g + 1) * cgs], d[g * cgs:(g + 1) * cgs]
            lo = torch.cat([og, og + dg]).clamp_max(self.S)
            hi = (lo + pl.CHUNK).clamp_max(self.S)
            diff = torch.zeros(self.S + 1, dtype=torch.int32, device=self.dev)
            diff.index_add_(0, lo, one)
            diff.index_add_(0, hi, -one)
            mask = torch.cumsum(diff[:-1], 0) > 0
            seen = torch.zeros(self.N, dtype=torch.bool, device=self.dev)
            seen[self.node[mask]] = True
            steps[g] = mask.sum()
            nodes[g] = seen.sum()
        nbytes = (steps.cpu().numpy() * w["step_bytes"] + nodes.cpu().numpy() * w["node_bytes"])
        ops = valid.reshape(p["groups"], cgs).sum(axis=1) * w["ops_per_valid_pair"]
        t = np.maximum(nbytes / peak["hbm_bytes_per_s"], ops / peak["f32_ops_per_s"])
        return float(t.sum())
