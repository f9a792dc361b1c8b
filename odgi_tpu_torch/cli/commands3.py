"""The subcommands of ``odgi_tpu/cli/commands3.py``: groom, crush, break,
unitig, inject, cover, priv and procbed (graph edits and generators), tips
and bin (analytics), pathindex, stepindex and server (the path indexes
and the HTTP position server), layout0 (the legacy stress-SGD layout to
SVG) and test (the port's own tests), with ``odgi_tpu.cli``'s flags,
output and written bytes.  Host code.
"""

from __future__ import annotations

import ast
import glob
import importlib.util
import os
import sys
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import unquote

from ..algorithms.bin_cmd import bin_path_info_cmd
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
from ..algorithms.layout0 import draw_svg, sgd_layout
from ..algorithms.tips import walk_tips
from ..core.graph import GraphBuilder
from ..core.index import XPT_MAGIC, PathIndex, StepIndex


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


def _resolve_paths(g, one, many):
    if one:
        return [g.path_names.index(one)]
    if many:
        with open(many) as f:
            return [g.path_names.index(l.strip()) for l in f if l.strip()]
    return None


def cmd_tips(args):
    from .main import load_any

    g = load_any(args.input, args.device)
    nv = open(args.not_visited_tsv, "w") if args.not_visited_tsv else None
    try:
        walk_tips(
            g,
            sys.stdout,
            query_paths=_resolve_paths(g, args.query_path, args.query_paths),
            target_paths=_resolve_paths(g, args.target_path, args.target_paths),
            n_best=args.n_best,
            walking_dist=args.jaccard_context,
            report_additional_jaccards=args.jaccards,
            not_visited_out=nv,
        )
    finally:
        if nv:
            nv.close()
    return 0


def cmd_bin(args):
    from .main import load_any

    if not args.num_bins and not args.bin_width:
        print("[odgi::bin] error: a bin width or a bin count is required", file=sys.stderr)
        return 1
    g = load_any(args.input, args.device)
    bin_path_info_cmd(
        g,
        sys.stdout,
        num_bins=args.num_bins,
        bin_width=args.bin_width,
        path_delim=args.path_delim or "",
        aggregate_delim=args.aggregate_delim,
        json_out=args.json,
        no_seqs=args.no_seqs,
        no_gap_links=args.no_gap_links,
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


def cmd_pathindex(args):
    from .main import load_any

    g = load_any(args.input, args.device)
    PathIndex.build(g).save(args.out)
    return 0


def cmd_stepindex(args):
    from .main import load_any

    g = load_any(args.input, args.device)
    rate = args.step_index_sample_rate
    if rate and rate % 2 != 0:
        print(
            "[odgi::stepindex] error: sample rate must be divisible by 2 (or 0)",
            file=sys.stderr,
        )
        return 1
    StepIndex.build(g, sample_rate=rate).save(args.out)
    return 0


def cmd_server(args):
    """HTTP path:pos -> pangenome-pos server (reference:
    src/subcommand/server_main.cpp; GET /<path>/<1-based-pos>)."""
    with open(args.input, "rb") as f:
        head = f.read(8)
    if head == XPT_MAGIC:
        index = PathIndex.load(args.input)
    else:
        from .main import load_any

        index = PathIndex.build(load_any(args.input, args.device))

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            def reply(text: str):
                body = text.encode()
                self.send_response(200)
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header("Access-Control-Expose-Headers", "text/plain")
                self.send_header(
                    "Access-Control-Allow-Methods", "GET, POST, DELETE, PUT"
                )
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            if self.path == "/hi":
                reply("Hello World!")
                return
            if self.path == "/stop":
                reply("bye")
                raise KeyboardInterrupt
            # cpp-httplib decodes percent-encoding before matching
            # (reference: server_main.cpp:103-116); do the same so
            # path names with '|' ':' etc. resolve from any client
            parts = unquote(self.path).strip("/").rsplit("/", 1)
            pan_pos = 0
            if len(parts) == 2 and parts[1].isdigit():
                name, pos1 = parts[0], int(parts[1])
                if index.has_path(name) and index.has_position(name, pos1 - 1):
                    pan_pos = index.get_pangenome_pos(name, pos1 - 1) + 1
            reply(str(pan_pos))

        def log_message(self, fmt, *a):
            print(
                "GOT REQUEST :", self.path, file=sys.stderr
            )

    ip = args.ip or "localhost"
    httpd = HTTPServer((ip, int(args.port)), Handler)
    print(f"http server listening on http://{ip}:{args.port}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


def cmd_layout0(args):
    from .main import load_any

    g = load_any(args.input, args.device)
    layout = sgd_layout(
        g,
        pivots=args.n_pivots,
        t_max=args.iter_max,
        eps=args.eps,
        x_padding=args.x_padding,
    )
    if args.out == "-":
        draw_svg(sys.stdout, layout, g, args.render_scale)
    else:
        with open(args.out, "w") as f:
            draw_svg(f, layout, g, args.render_scale)
    return 0


def imports_odgi_tpu(path: str) -> bool:
    """Whether the test file at `path` imports odgi_tpu or jax anywhere (read
    with ast, not imported)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        if any(n.split(".")[0] in ("odgi_tpu", "jax") for n in names):
            return True
    return False


def cmd_test(args):
    """Run the port's own tests, ``tests/test_torch_*.py``, under pytest
    with ``--noconftest`` (tests/conftest.py imports jax), the arguments
    after ``--`` passed on; the exit code is pytest's.  Arguments that name
    existing files or directories (``path`` or ``path::test``) replace the
    default files.  Where jax is not installed, odgi_tpu cannot run, so the
    files that import it (or jax) are left out, and stderr names them.
    Without pytest, inline smoke checks (as ``odgi_tpu``'s ``test`` has
    them)."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    tests_dir = os.path.join(repo, "tests")
    if importlib.util.find_spec("pytest") and os.path.isdir(tests_dir):
        import pytest

        extra = list(args.extra or [])
        named = [a for a in extra if not a.startswith("-") and os.path.exists(a.split("::")[0])]
        extra = [a for a in extra if a not in named]
        files = named or sorted(glob.glob(os.path.join(tests_dir, "test_torch_*.py")))
        if importlib.util.find_spec("jax") is None:
            out = [f for f in files
                   if f.split("::")[0].endswith(".py") and imports_odgi_tpu(f.split("::")[0])]
            if out:
                print(f"[odgi::test] jax is not installed, so odgi_tpu cannot run: "
                      f"leaving out {len(out)} files that import it: "
                      + " ".join(os.path.basename(f) for f in out), file=sys.stderr)
            files = [f for f in files if f not in out]
            if not files:
                return int(pytest.ExitCode.NO_TESTS_COLLECTED)
        else:
            # what tests/conftest.py sets up for the JAX twins: the CPU, 8 devices
            os.environ.setdefault("JAX_PLATFORMS", "cpu")
            flags = os.environ.get("XLA_FLAGS", "")
            if "xla_force_host_platform_device_count" not in flags:
                os.environ["XLA_FLAGS"] = (
                    flags + " --xla_force_host_platform_device_count=8").strip()
        return pytest.main(["--noconftest", "-q", *files, *extra])
    b = GraphBuilder()
    b.add_node(1, b"ACGT")
    b.add_node(2, b"T")
    b.add_edge(1, False, 2, False)
    p = b.add_path("x")
    b.append_step(p, 1, False)
    b.append_step(p, 2, False)
    g = b.build()
    assert g.num_nodes == 2 and g.num_edges == 1 and g.num_steps == 2
    assert g.validate() == []
    print("All tests passed")
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

    p = sub.add_parser("tips", help="path tip breakpoints vs references")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-q", "--query-path", default=None)
    p.add_argument("-r", "--target-path", default=None)
    p.add_argument("-Q", "--query-paths", default=None)
    p.add_argument("-R", "--target-paths", default=None)
    p.add_argument("-v", "--not-visited-tsv", default=None)
    p.add_argument("-n", "--n-best", type=int, default=1)
    p.add_argument("-w", "--jaccard-context", type=int, default=10000)
    p.add_argument("-j", "--jaccards", action="store_true")
    p.set_defaults(fn=cmd_tips)

    p = sub.add_parser("bin", help="pangenome binning")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-D", "--path-delim", default=None)
    p.add_argument("-a", "--aggregate-delim", action="store_true")
    p.add_argument("-j", "--json", action="store_true")
    p.add_argument("-n", "--num-bins", type=int, default=0)
    p.add_argument("-w", "--bin-width", type=int, default=0)
    p.add_argument("-s", "--no-seqs", action="store_true")
    p.add_argument("-g", "--no-gap-links", action="store_true")
    p.set_defaults(fn=cmd_bin)

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

    # flag parity with the reference commands (pathindex_main.cpp:21-30,
    # stepindex_main.cpp:22-36): -t/--threads and -P/--progress accepted
    # and unused
    p = sub.add_parser("pathindex", help="build positional path index (.xpt)")
    p.add_argument("-i", "--input", "--idx", required=True, dest="input")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-t", "--threads", type=int, default=0)
    p.add_argument("-P", "--progress", action="store_true")
    p.set_defaults(fn=cmd_pathindex)

    p = sub.add_parser("stepindex", help="build step index (.stpidx)")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument(
        "-a", "--step-index-sample-rate", type=int, default=8
    )
    p.add_argument("-t", "--threads", type=int, default=0)
    p.add_argument("-P", "--progress", action="store_true")
    p.set_defaults(fn=cmd_stepindex)

    p = sub.add_parser("server", help="HTTP path:pos -> pangenome pos server")
    p.add_argument("-i", "--input", required=True, help="graph or .xpt index")
    p.add_argument("-p", "--port", required=True)
    p.add_argument("-a", "--ip", default=None)
    p.set_defaults(fn=cmd_server)

    p = sub.add_parser("layout0", help="legacy stress-SGD 2D layout -> SVG")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-m", "--iter-max", type=int, default=30)
    p.add_argument("-p", "--n-pivots", type=int, default=0)
    p.add_argument("-e", "--eps", type=float, default=0.01)
    p.add_argument("-x", "--x-padding", type=float, default=10.0)
    p.add_argument("-R", "--render-scale", type=float, default=5.0)
    p.set_defaults(fn=cmd_layout0)

    p = sub.add_parser("test", help="run built-in self tests")
    p.add_argument("extra", nargs="*", default=None)
    p.set_defaults(fn=cmd_test)
