"""Readings that a cell's correctness limits are set from, at the cell's size.

    python3 portbench/calibrate.py --workload <cell> --graph-seeds 11 12 \
        --jobs 6 --control 3 [--out file.jsonl]

For each graph seed (a run's --seed: the walk of the graph) the program runs
`--jobs` jobs, with the PG-SGD seeds a run's window would draw; each is
compared with the plain reference (the sound readings).  For the first
`--control` of them the control, the reference with its sums and node
coordinates in float32 instead of float64, is compared with the reference
too (the control's readings).  One JSON line a job; the benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench import harness, jobs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--graph-seeds", type=int, nargs="+", required=True)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    c = harness.load_cell(harness.ROOT, args.workload)
    job = jobs.make(c["traffic"], c["kind_dir"])
    sink = open(args.out, "a") if args.out else None
    sync = torch.cuda.synchronize if args.device == "cuda" else (lambda: None)
    try:
        for gseed in args.graph_seeds:
            from odgi_tpu_torch.convert import graph_from_arrays

            f = harness.graph_fields(c["config"], gseed, c["graph_dir"])
            g = graph_from_arrays(f)
            workdir = harness.prepare(job, dataclasses.replace(g, _cache={}))
            job.install()
            for k in range(1, args.jobs + 1):
                s = harness.job_seed(gseed, k)
                t = time.perf_counter()
                out = job.run(dataclasses.replace(g, _cache={}), s, args.device)
                sync()
                line = dict(workload=args.workload, graph_seed=gseed, job_seed=s,
                            job_s=time.perf_counter() - t)
                got = job.keep(out)
                del out
                t = time.perf_counter()
                ref = job.reference(f, s, args.device, torch.float64)
                line["reference_s"] = time.perf_counter() - t
                line["sound"] = job.compare(got, ref)
                if k <= args.control:
                    t = time.perf_counter()
                    ctl = job.reference(f, s, args.device, torch.float32)
                    line["control_s"] = time.perf_counter() - t
                    line["control"] = job.compare(ctl, ref)
                print(json.dumps(line), flush=True)
                if sink:
                    sink.write(json.dumps(line) + "\n")
                    sink.flush()
            job.uninstall()
            if workdir is not None:
                workdir.cleanup()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
