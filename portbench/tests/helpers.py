"""Shared pieces of the benchmark's CPU tests: tiny configurations of every
cell, and a run of a cell on the CPU through the program's plain paths."""

from __future__ import annotations

import io
import json
import time
from contextlib import redirect_stderr, redirect_stdout

from portbench import harness


def configured_sizes(root=harness.ROOT) -> dict:
    """The ``"tiny"`` object of each cell's configuration file, where it
    has one: the keys the CPU tests lay over it.  A cell added as new files
    brings its tiny size there."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    confs = {c["name"]: json.loads((root / c["file"]).read_text()) for c in bench["configs"]}
    return {w["name"]: confs[w["config"]]["tiny"] for w in bench["workloads"]
            if "tiny" in confs[w["config"]]}


# Every cell at a size the CPU runs in seconds, on its route where it can:
# chrom-90hap keeps the xxl route (more than 16,383 nodes).
TINY = {
    **configured_sizes(),
    "chrom-90hap.layout": dict(haplotypes=2, nodes=20000),
    "locus-90hap.layout": dict(haplotypes=8, nodes=600),
    # 34,000 nodes: past 32,767 a 1D run takes the xxl route, as the cell's
    # does.  4 haplotypes: at 2, about 18 nodes lie on no path; such nodes
    # are alike and have no edges, so a fault that swaps the first two nodes
    # of the topological order may swap two of them and leave the sorted
    # graph as it was (the cell's 90 haplotypes leave no node off the paths).
    "chrom-90hap.sort-Ygs": dict(haplotypes=4, nodes=34000),
}
SEED = 2**31 + 12345


def run_tiny(cell: str, trace: bool = False, root=harness.ROOT, config=None) -> tuple:
    """(result dict as printed, stdout, stderr) of one run of `cell` on the
    CPU for 0.5 s, at its tiny size or with `config` laid over its file."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        if config is None:
            config = {**configured_sizes(root), **TINY}[cell]
        r = harness.run_cell(root, cell, SEED, 0.5, trace, "cpu", time.perf_counter(),
                             config=config)
        r.pop("info")
        harness.report(r)
    last = out.getvalue().strip().splitlines()[-1]
    return json.loads(last), out.getvalue(), err.getvalue()
