"""The check that decides `correct` fails what it must, at sizes a test run
holds: the control (the plain reference with its sums and node coordinates
in float32, put in the program's place) and the program with its timed path
broken underneath.  The exchange between chips does not exist in a cell of
one chip, so it has no fault here."""

import types

import numpy as np
import pytest
import torch

from portbench import jobs, reference
from portbench.tests.helpers import TINY, run_tiny

# Sizes at which the control's gap reads above the cell's limit.
CONTROL = {
    "chrom-90hap.layout": TINY["chrom-90hap.layout"],
    "locus-90hap.layout": dict(haplotypes=20, nodes=1000),
    "chrom-90hap.sort-Ygs": TINY["chrom-90hap.sort-Ygs"],
}


def _fields(g):
    from odgi_tpu_torch.convert import graph_to_arrays

    return graph_to_arrays(g)


@pytest.mark.parametrize("cell", sorted(CONTROL))
def test_control_is_not_correct(cell, monkeypatch):
    if "sort" in cell:
        def run(self, g, seed, device):
            out = reference.sort_ygs(_fields(g), seed, device, torch.float32)
            self.last_x = out["x"]
            return types.SimpleNamespace(**out)

        monkeypatch.setattr(jobs.SortJob, "run", run)
    else:
        monkeypatch.setattr(jobs.LayoutJob, "run", lambda self, g, seed, device: reference.layout(
            _fields(g), seed, device, torch.float32))
    res, _, _ = run_tiny(cell, config=CONTROL[cell])
    assert res["correct"] is False
    if "sort" in cell:
        # the sorted graph does not move; the positions do
        assert res["checks"]["graph_mismatch"]["value"] == 0
        assert res["checks"]["x_gap"]["value"] > res["checks"]["x_gap"]["limit"]


def _state_unchanged(monkeypatch):
    from odgi_tpu_torch.ops import strata_sgd

    monkeypatch.setattr(strata_sgd.StrataState, "run",
                        lambda self, delta=0.0: dict(iterations=0, delta_max=[]))


def _half_batch(monkeypatch):
    """Each merge group runs the first half of its conflict levels only; the
    merge still divides by every visit."""
    from odgi_tpu_torch.ops import kernels

    for name in ("strata_chunks_2d_levels", "strata_chunks_1d_levels"):
        orig = getattr(kernels, name)

        def half(drift, base, planes, od, eta, cpi, perm, lvl_off, *rest, _orig=orig, **kw):
            return _orig(drift, base, planes, od, eta, cpi, perm,
                         lvl_off[:max(2, (len(lvl_off) + 1) // 2)], *rest, **kw)

        monkeypatch.setattr(kernels, name, half)


def _answer_altered(monkeypatch):
    from odgi_tpu_torch.algorithms import layout, path_sgd_sort

    pack = layout.pack_components

    def nudged(g, coords, border=1000.0):
        out = pack(g, coords, border)
        out[len(out) // 2, 0] += 1.0   # one endpoint moved by one bp
        return out

    topo = path_sgd_sort.topological_order

    def swapped(g, use_heads=True, use_tails=False):
        out = topo(g, use_heads, use_tails).copy()
        out[[0, 1]] = out[[1, 0]]
        return out

    monkeypatch.setattr(layout, "pack_components", nudged)
    monkeypatch.setattr(path_sgd_sort, "topological_order", swapped)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(TINY))
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res, _, _ = run_tiny(cell)
    assert res["correct"] is False, res["checks"]


def test_sound_tiny_runs_read_zero():
    for cell in sorted(TINY):
        res, _, _ = run_tiny(cell)
        assert all(v["value"] == 0 for v in res["checks"].values()), (cell, res["checks"])
        assert np.isfinite([v["limit"] for v in res["checks"].values()]).all()
