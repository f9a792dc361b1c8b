#!/usr/bin/env python3
"""The sharded 2D path over real ranks, held against its simulation.

    python3 tools/sharded_ranks.py [--ranks 4] [--backend nccl|gloo] [--steps N]

Spawns `--ranks` processes, each running
``odgi_tpu_torch.parallel.sharded_strata.run_rank`` (NCCL: one GPU a rank;
gloo: the CPU), on chip_smoke.py's synthetic graph of `--steps` steps (30
paths' shape: 50,000 steps a path over 10,000 nodes at the default size),
from ``init_layout(g, "d")`` at the default 2D schedule.  Then this process
runs the same number of devices simulated (NCCL: on GPU 0; gloo: on the
CPU).  Prints one JSON line: the ranks' wall seconds from spawn to the last
join, the simulation's, whether every rank's coordinates equal the
simulation's bit for bit, and the stress before and after.  Exits non-zero
on any mismatch or failed rank.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import odgi_tpu_torch as ot  # noqa: E402
from chip_smoke import synth_graph  # noqa: E402
from odgi_tpu_torch.ops import kernels  # noqa: E402
from odgi_tpu_torch.ops.sgd import derive_config_2d  # noqa: E402
from odgi_tpu_torch.parallel import sharded_strata  # noqa: E402

JOIN_S = 900


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--steps", type=int, default=1_500_000)
    args = ap.parse_args()
    if args.backend == "nccl":
        if not torch.cuda.is_available():
            print("sharded_ranks: no CUDA device", file=sys.stderr)
            return 1
        sharded_strata.check_world(args.ranks, "nccl", torch.device("cuda"))
        kernels.build()  # once, before the ranks look for the libraries
        dev = torch.device("cuda", 0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()
    else:
        dev, smi = torch.device("cpu"), []
    nodes = max(1, args.steps // 150)
    g = synth_graph(args.steps, nodes, min(50_000, args.steps // 30))
    c0 = ot.init_layout(g, "d")
    cfg = derive_config_2d(g)

    with socket.socket() as s:
        s.bind(("localhost", 0))
        init = f"tcp://localhost:{s.getsockname()[1]}"
    with tempfile.TemporaryDirectory() as tmp:
        ctx = multiprocessing.get_context("spawn")
        outs = [os.path.join(tmp, f"rank{r}.npy") for r in range(args.ranks)]
        procs = [ctx.Process(target=sharded_strata.run_rank,
                             args=(r, args.ranks, init, args.backend, g, c0, cfg, outs[r]))
                 for r in range(args.ranks)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(JOIN_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        ranks_s = time.perf_counter() - t0
        codes = [p.exitcode for p in procs]
        ranks = [np.load(o) if c == 0 else None for o, c in zip(outs, codes)]

    t0 = time.perf_counter()
    sim = sharded_strata.path_sgd_2d_strata_sharded(g, c0, cfg, n_dev=args.ranks, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    sim = sim.cpu().numpy()
    stress = lambda c: ot.sum_of_path_node_distances(
        g, (c[:, 0], c[:, 1]), device=dev).all_2d_by_nucleotides
    equal = [r is not None and bool(np.array_equal(r, sim)) for r in ranks]
    print(json.dumps(dict(
        backend=args.backend, ranks=args.ranks, steps=g.num_steps, nodes=g.num_nodes,
        exit_codes=codes, ranks_wall_s=ranks_s, simulation_s=sim_s, equal=equal,
        stress_before=stress(c0), stress_after=stress(sim), device=str(dev),
        cuda_devices=torch.cuda.device_count())), flush=True)
    for line in smi:
        print(line, flush=True)
    return 0 if all(equal) and codes == [0] * args.ranks else 1


if __name__ == "__main__":
    sys.exit(main())
