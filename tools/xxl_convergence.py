#!/usr/bin/env python3
"""Does the port's 1D strata run converge as odgi_tpu's does past the
xxl node cap?  On the CPU, both packages' plain versions of the 1D strata
PG-SGD at the default schedule, on one graph.

The graph is tools/bigscale_bench.py's synth_graph (BIGSCALE_r05.json's
generator and shape, 10 paths of 1-bp nodes, node ids shuffled by
permutation(5) as ``--shuffle`` does), cut from 1M nodes / 10M steps to
40,000 nodes / 400,000 steps: still past the 1D xxl cap of 32,767
nodes, so the port takes its xxl route (the blocked sum after a relabel
by first visit).  odgi_tpu runs ``path_sgd_1d_strata_xla`` (its
any-backend twin of the TPU kernel); the port runs ``path_sgd_1d_strata``
on the CPU (the plain PyTorch versions of its kernels).  Each x is turned
into a node order (``order_from_x``) and the sorted graph's nt-distance
(``sum_of_path_node_distances().all_nt_space``) is printed beside the
start's, as one JSON line with the walls and the largest difference of
the two x.  With ``--kernel``, odgi_tpu's TPU kernel itself
(``path_sgd_1d_pallas_xxl``) runs too, in Pallas's interpret mode on the
CPU (about 6 s an iteration at 40,000 nodes), and its nt-distance is
printed beside the twin's.

    python tools/xxl_convergence.py [--nodes 40000] [--steps 400000] [--iters 100] [--kernel]

Needs odgi_tpu (jax) and the port; CPU only.  At 40,000 nodes the two
plain runs take seconds, the kernel about 11 minutes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

from odgi_tpu.algorithms import stats as j_stats  # noqa: E402
from odgi_tpu.algorithms.path_sgd_sort import order_from_x  # noqa: E402
from odgi_tpu.ops import pallas_sgd as ps  # noqa: E402
from odgi_tpu.ops import pallas_sgd_xxl as xxl  # noqa: E402
from odgi_tpu.ops.sgd import derive_config_1d as j_derive  # noqa: E402

from odgi_tpu_torch.convert import graph_from_arrays, graph_to_arrays  # noqa: E402
from odgi_tpu_torch.ops import strata_route  # noqa: E402
from odgi_tpu_torch.ops.sgd import derive_config_1d as t_derive  # noqa: E402
from odgi_tpu_torch.ops.strata_sgd import path_sgd_1d_strata  # noqa: E402

sys.path.insert(0, os.path.join(REPO, "tools"))
from bigscale_bench import synth_graph  # noqa: E402


def nt_after(g, x) -> float:
    return float(j_stats.sum_of_path_node_distances(
        g.apply_ordering(order_from_x(g, np.asarray(x)))).all_nt_space)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=40_000)
    ap.add_argument("--steps", type=int, default=400_000)
    ap.add_argument("--paths", type=int, default=10)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--kernel", action="store_true",
                    help="also run odgi_tpu's xxl kernel in interpret mode")
    args = ap.parse_args()

    g = synth_graph(args.steps, args.nodes, args.steps // args.paths)
    g = g.apply_ordering(np.random.default_rng(5).permutation(g.num_nodes))
    gt = graph_from_arrays(graph_to_arrays(g))
    cfg_j, cfg_t = j_derive(g, iter_max=args.iters), t_derive(gt, iter_max=args.iters)
    out = dict(nodes=g.num_nodes, steps=g.num_steps, paths=g.num_paths, iters=args.iters,
               route=strata_route.graph_route(gt, cfg_t, one_d=True),
               nt_before=float(j_stats.sum_of_path_node_distances(g).all_nt_space))

    t0 = time.perf_counter()
    x_j = np.asarray(ps.path_sgd_1d_strata_xla(g, cfg_j), np.float64)
    out["odgi_tpu_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    x_t = path_sgd_1d_strata(gt, cfg_t, None, "cpu").numpy()
    out["port_s"] = time.perf_counter() - t0

    out["nt_after_odgi_tpu"] = nt_after(g, x_j)
    out["nt_after_port"] = nt_after(g, x_t)
    out["nt_after_rel_diff"] = abs(out["nt_after_port"] - out["nt_after_odgi_tpu"]) / out["nt_after_odgi_tpu"]
    scale = float(np.abs(x_j).max())
    out["x_max_abs_diff_of_scale"] = float(np.abs(x_t - x_j).max()) / scale
    out["same_order"] = bool(np.array_equal(order_from_x(g, x_j), order_from_x(g, x_t)))
    if args.kernel:
        t0 = time.perf_counter()
        x_k = np.asarray(xxl.path_sgd_1d_pallas_xxl(g, cfg_j, interpret=True), np.float64)
        out["kernel_interpret_s"] = time.perf_counter() - t0
        out["nt_after_kernel"] = nt_after(g, x_k)
        out["kernel_x_max_abs_diff_of_scale"] = float(np.abs(x_k - x_j).max()) / scale
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
