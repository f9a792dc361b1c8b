"""The parts of a sort job's host ``gs`` (groom, then the topological
order from the heads), timed on the graph they see in a benchmark job.

    python3 tools/gs_parts.py [--config chrom-90hap-sort] [--seed N] [--reps 3]
                              [--device cuda|cpu] [--tiny]

The graph is the configuration's (``portbench/configs``, walk seed
`--seed`) after the Y pass of ``sort_pipeline`` on `--device`, as ``gs``
gets it.  Each repetition times, on a fresh copy of that graph:

- ``adjacency``: ``SideAdjacency.build``, on the packed key and on the rows
  (``np.unique(axis=0)``, the form the packed key replaced);
- ``groom`` and ``topological_order``: ``apply_groom`` and
  ``topological_order(use_heads=True)`` as a job calls them, in C++
  (``native/src/graph_passes.cpp``) and in Python, the adjacency built.

Then one whole ``sort_pipeline(g, "Ygs")`` job, as the benchmark runs it:
its seconds and what it adds to ``gs.native`` and ``gs.python`` (2 and 0
where g++ built the library).  Both paths' flip masks and orders must be
equal, or it exits 1.  Prints one JSON line of seconds (each
repetition's), the graph's size, the job's counters, and the card's name
and power limit when it runs on one.
``--tiny`` cuts the graph to 8 haplotypes of 3,000 nodes.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from odgi_tpu_torch import native  # noqa: E402
from odgi_tpu_torch.algorithms import groom, topological  # noqa: E402
from odgi_tpu_torch.algorithms.path_sgd_sort import sort_pipeline  # noqa: E402
from odgi_tpu_torch.convert import graph_from_arrays, graph_to_arrays  # noqa: E402
from odgi_tpu_torch.core import graph as core_graph  # noqa: E402
from odgi_tpu_torch.utils.metrics import TOTALS  # noqa: E402
from portbench import graphgen  # noqa: E402


def card() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return time.perf_counter() - t0, out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="chrom-90hap-sort")
    ap.add_argument("--seed", type=int, default=2300000001)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    a = ap.parse_args()

    config = json.loads((ROOT / "portbench" / "configs" / f"{a.config}.json").read_text())
    if a.tiny:
        config = dict(config, haplotypes=8, nodes=3000)
    f = graphgen.graph_arrays(config, a.seed)
    t_y, g_y = timed(sort_pipeline, graph_from_arrays(f), "Y",
                     sgd_overrides={"seed": a.seed}, device=a.device)
    arrays = graph_to_arrays(g_y)
    lib = native.gs_lib()
    if lib is None:
        print(json.dumps({"ok": False, "error": native._gs["error"]}))
        return 1

    parts: dict = {k: [] for k in ("adjacency_packed", "adjacency_rows", "groom_native",
                                   "groom_python", "topological_order_native",
                                   "topological_order_python")}
    ok = True
    for _ in range(a.reps):
        t, adj = timed(core_graph.SideAdjacency.build, graph_from_arrays(arrays))
        parts["adjacency_packed"].append(t)
        packed_max = core_graph._PACKED_KEY_MAX
        core_graph._PACKED_KEY_MAX = 0
        try:
            t, rows = timed(core_graph.SideAdjacency.build, graph_from_arrays(arrays))
        finally:
            core_graph._PACKED_KEY_MAX = packed_max
        parts["adjacency_rows"].append(t)
        ok &= (np.array_equal(adj.offsets, rows.offsets)
               and np.array_equal(adj.targets, rows.targets))
        got = {}
        gs_lib = native.gs_lib
        for path, use in (("native", lib), ("python", None)):
            native.gs_lib = lambda use=use: use
            try:
                g = graph_from_arrays(arrays)
                g.adjacency
                t, g2 = timed(groom.apply_groom, g)
                parts[f"groom_{path}"].append(t)
                t, order = timed(topological.topological_order, g2, use_heads=True)
                parts[f"topological_order_{path}"].append(t)
            finally:
                native.gs_lib = gs_lib
            got[path] = (g2.step_handle, order)
        ok &= all(np.array_equal(x, y) for x, y in zip(got["native"], got["python"]))

    names = ("gs.native", "gs.python", "groom.flipped", "groom.restarts",
             "topological_order.seeded", "topological_order.restarts")
    before = [TOTALS.get(k, {}).get("runs", 0) for k in names]
    t_job, _ = timed(sort_pipeline, graph_from_arrays(f), "Ygs",
                     sgd_overrides={"seed": a.seed}, device=a.device)
    counters = {k: TOTALS.get(k, {}).get("runs", 0) - b for k, b in zip(names, before)}
    print(json.dumps({"ok": bool(ok), "config": a.config, "seed": a.seed, "tiny": a.tiny,
                      "device": a.device, "card": card(), "nodes": g_y.num_nodes,
                      "edges": int(len(g_y.edge_from)), "steps": g_y.num_steps,
                      "y_pass_s": t_y, "seconds": parts, "job_s": t_job,
                      "job_counters": counters}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
