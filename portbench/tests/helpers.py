"""Shared pieces of the benchmark's CPU tests: tiny configurations of every
cell, and a run of a cell on the CPU through the program's plain paths."""

from __future__ import annotations

import io
import json
import time
from contextlib import redirect_stderr, redirect_stdout

from portbench import harness

# Every cell at a size the CPU runs in seconds, on its route where it can:
# chrom-90hap keeps the xxl route (more than 16,383 nodes).
TINY = {
    "chrom-90hap.layout": dict(haplotypes=2, nodes=20000),
    "locus-90hap.layout": dict(haplotypes=8, nodes=600),
    "locus-90hap.sort-Ygs": dict(haplotypes=8, nodes=600),
}
SEED = 2**31 + 12345


def run_tiny(cell: str, trace: bool = False, root=harness.ROOT, config=None) -> tuple:
    """(result dict as printed, stdout, stderr) of one run of `cell` on the
    CPU for 0.5 s."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        r = harness.run_cell(root, cell, SEED, 0.5, trace, "cpu", time.perf_counter(),
                             config=config or TINY[cell])
        r.pop("info")
        harness.report(r)
    last = out.getvalue().strip().splitlines()[-1]
    return json.loads(last), out.getvalue(), err.getvalue()
