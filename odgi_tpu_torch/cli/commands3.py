"""The subcommands of ``odgi_tpu/cli/commands3.py`` that the port has:
groom, crush, break, unitig, inject, cover, priv and procbed (graph edits
and generators), with ``odgi_tpu.cli``'s flags, output and written bytes.
Host code.
"""

from __future__ import annotations

import sys

from ..algorithms.edits2 import (
    break_cycles,
    crush_n,
    diff_priv,
    edges_inducing_cycles,
    inject_ranges,
    path_cover,
    procbed_adjust,
    write_unitigs,
)
from ..algorithms.groom import apply_groom


def cmd_groom(args):
    from .main import load_any, _out_graph

    g = load_any(args.input, args.device)
    target = None
    if args.target_paths:
        with open(args.target_paths) as f:
            names = [l.strip() for l in f if l.strip()]
        target = [g.path_names.index(n) for n in names]
    g = apply_groom(g, target_paths=target)
    _out_graph(g, args.out)
    return 0


def cmd_crush(args):
    from .main import load_any, _out_graph

    g = load_any(args.input, args.device)
    _out_graph(crush_n(g), args.out)
    return 0


def cmd_break(args):
    from .main import load_any, _out_graph

    g = load_any(args.input, args.device)
    if args.show:
        for a, b in edges_inducing_cycles(g, args.cycle_max_bp, args.max_search_bp):
            print(
                f"{int(g.node_id[a >> 1])}{'-' if a & 1 else '+'} -> "
                f"{int(g.node_id[b >> 1])}{'-' if b & 1 else '+'}"
            )
        return 0
    g, removed = break_cycles(
        g, args.cycle_max_bp, args.max_search_bp, args.repeat_up_to
    )
    _out_graph(g, args.out)
    return 0


def cmd_unitig(args):
    from .main import load_any

    g = load_any(args.input, args.device)
    write_unitigs(
        g,
        sys.stdout,
        fake_fastq=args.fake_fastq,
        min_begin_node_length=args.min_begin_node_length,
        sample_to=args.sample_to,
        sample_plus=args.sample_plus,
        seed=args.seed,
    )
    return 0


def cmd_inject(args):
    from .main import load_any, _out_graph

    g = load_any(args.input, args.device)
    intervals = []
    with open(args.bed_targets) as f:
        for line in f:
            line = line.rstrip("\r\n")
            if not line:
                continue
            vals = line.split("\t")
            if len(vals) < 4:
                print(
                    f"[odgi::inject] BED line lacks interval fields: {line}",
                    file=sys.stderr,
                )
                return 1
            if vals[0] not in g.path_names:
                print(
                    f"[odgi::inject] warning: no path '{vals[0]}' in graph",
                    file=sys.stderr,
                )
                continue
            intervals.append((vals[0], int(vals[1]), int(vals[2]), vals[3]))
    if not intervals:
        print(
            "[odgi::inject] error: no BED interval matched a path in the graph",
            file=sys.stderr,
        )
        return 1
    _out_graph(inject_ranges(g, intervals), args.out)
    return 0


def cmd_cover(args):
    from .main import load_any, _out_graph

    g = load_any(args.input, args.device)
    g = path_cover(
        g,
        num_paths_per_component=args.num_paths_per_component,
        node_window_size=args.node_window_size,
        min_node_depth=args.min_node_depth,
        ignore_paths=args.ignore_paths,
    )
    _out_graph(g, args.out)
    return 0


def cmd_priv(args):
    from .main import load_any, _out_graph

    g = load_any(args.input, args.device)
    g = diff_priv(
        g,
        epsilon=args.epsilon,
        target_coverage=args.target_depth,
        min_haplotype_freq=args.min_hap_freq,
        bp_limit=args.bp_target,
        seed=args.seed,
        write_samples=sys.stdout if args.write_haps else None,
    )
    _out_graph(g, args.out)
    return 0


def cmd_procbed(args):
    from .main import load_any

    g = load_any(args.input, args.device)
    with open(args.bed_targets) as f:
        procbed_adjust(g, f, sys.stdout)
    return 0


def register(sub):
    p = sub.add_parser("groom", help="harmonize node orientations")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-d", "--use-dfs", action="store_true")
    p.add_argument("-R", "--target-paths", default=None)
    p.set_defaults(fn=cmd_groom)

    p = sub.add_parser("crush", help="crush runs of N")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--out", required=True)
    p.set_defaults(fn=cmd_crush)

    p = sub.add_parser("break", help="break cycles and drop paths")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--out", default=None)
    p.add_argument("-c", "--cycle-max-bp", type=int, default=0)
    p.add_argument("-s", "--max-search-bp", type=int, default=0)
    p.add_argument("-u", "--repeat-up-to", type=int, default=1)
    p.add_argument("-d", "--show", action="store_true")
    p.set_defaults(fn=cmd_break)

    p = sub.add_parser("unitig", help="output unitigs")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-f", "--fake-fastq", action="store_true")
    p.add_argument("-t", "--sample-to", type=int, default=0)
    p.add_argument("-p", "--sample-plus", type=int, default=0)
    p.add_argument("-l", "--min-begin-node-length", type=int, default=0)
    p.add_argument("--seed", type=int, default=None)
    p.set_defaults(fn=cmd_unitig)

    p = sub.add_parser("inject", help="inject BED annotations as paths")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-b", "--bed-targets", required=True)
    p.set_defaults(fn=cmd_inject)

    p = sub.add_parser("cover", help="greedy path cover")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-n", "--num-paths-per-component", type=int, default=16)
    p.add_argument("-k", "--node-window-size", type=int, default=2)
    p.add_argument("-c", "--min-node-depth", type=int, default=0)
    p.add_argument("-I", "--ignore-paths", action="store_true")
    p.set_defaults(fn=cmd_cover)

    p = sub.add_parser("priv", help="differentially private sampling")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-e", "--epsilon", type=float, default=0.01)
    p.add_argument("-d", "--target-depth", type=float, default=1.0)
    p.add_argument("-c", "--min-hap-freq", type=int, default=2)
    p.add_argument("-b", "--bp-target", type=int, default=10000)
    p.add_argument("-W", "--write-haps", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.set_defaults(fn=cmd_priv)

    p = sub.add_parser("procbed", help="adjust BED to subgraph coordinates")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-b", "--bed-targets", required=True)
    p.set_defaults(fn=cmd_procbed)
