"""The port's command line: every subcommand ``odgi_tpu/cli/main.py``
registers itself, and (``commands2.py``, ``commands3.py``) depth, degree,
viz, draw, chop, unchop, normalize, flip, prune, explode, squeeze,
flatten, groom, crush, break, unitig, inject, cover, priv, procbed,
kmers, matrix, similarity, tension, heaps, pav, untangle, panpos,
position, extract, overlap, tips, bin, pathindex, stepindex, server,
layout0 and test: all 46 of ``odgi_tpu.cli``'s subcommands.

``python -m odgi_tpu.cli build|view|validate|stats|sort|layout|paths|version``
and those have their counterparts in ``python -m odgi_tpu_torch.cli``, which
takes the same flags, flag for flag, and writes the same bytes: every sort
code and ``sort -u``, ``stats --is-acyclic / --count-walks /
--shortest-cycle``, and every flag of ``paths``.  Graph inputs are GFA
text, the native ``.otg`` container or the reference's ``.og``, told apart
by their first bytes.  ``sort`` and ``layout`` run the PG-SGD through the
port's kernels on the card; ``stats`` computes its array metrics there;
the other sort codes, the graph walks of ``stats``, ``paths``, the
pictures, the edits, the positions, indexes and analytics, ``layout0`` and
``test`` (which runs the port's own tests) are host code.

``main(argv, device)`` runs on the card when `device` is None and raises
without one; the tests pass ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import zlib
from typing import List, Optional

import numpy as np

from ..algorithms import stats
from ..algorithms import paths_cmd as pc
from ..algorithms.components import num_self_loops, weak_components
from ..algorithms.graph_misc import count_walks, is_acyclic, shortest_cycle_length
from ..algorithms.layout import layout_graph, layout_to_tsv
from ..algorithms.path_sgd_sort import sort_pipeline
from ..algorithms.topological import topological_order
from ..algorithms.transforms import prefix_and_id_ordered_paths
from ..core.graph import handle_rank
from ..device import resolve_device
from ..io.gfa import parse_gfa, write_gfa
from ..io.lay import load_layout, save_lay, save_layout
from ..io.og import MAGIC, load_graph, save_graph
from ..io.og_compat import OG_MAGIC_BE, load_og, save_og
from ..ops.sgd import derive_config_2d
from ..utils.metrics import StepMetrics, maybe_profile
from ..utils.progress import ProgressMeter
from .. import version
from .commands2 import register as register2
from .commands3 import register as register3


def load_any(path: str, device):
    """Load `path` by its first bytes: .otg, the reference's .og, or GFA
    ("-" reads GFA from stdin)."""
    if path == "-":
        return parse_gfa(sys.stdin.buffer.read(), device=device)
    with open(path, "rb") as f:
        head = f.read(8)
    if head == MAGIC:
        return load_graph(path)
    if head[:4] == OG_MAGIC_BE:
        return load_og(path)
    if head[:4] == b"GFAZ":
        print(
            f"[odgi] error: {path} is a GFAz (compressed GFA) file; "
            "decompress it to GFAv1 first (GFAz decoding unsupported).",
            file=sys.stderr,
        )
        sys.exit(1)
    return parse_gfa(path, device=device)


def _out_graph(g, path: str):
    """Write by extension: .gfa text, .og the reference's binary, anything
    else the native .otg container."""
    if path.endswith(".gfa"):
        write_gfa(g, path)
    elif path.endswith(".og"):
        save_og(g, path)
    else:
        save_graph(g, path)


def cmd_build(args):
    g = load_any(args.gfa, args.device)
    if args.optimize:
        g = g.optimize()
    if args.sort:
        g = g.apply_ordering(topological_order(g))
    _out_graph(g, args.out)
    return 0


def cmd_view(args):
    g = load_any(args.input, args.device)
    if args.node_annotation:
        # per-S-line DP (step count) and RC (step count * node length) tags
        sc = np.bincount(handle_rank(g.step_handle), minlength=g.num_nodes)
        print("H\tVN:Z:1.0")
        for r in range(g.num_nodes):
            print(
                f"S\t{int(g.node_id[r])}\t{g.node_seq_str(r)}\t"
                f"DP:i:{int(sc[r])}\tRC:i:{int(sc[r]) * int(g.node_len[r])}"
            )
        buf = io.StringIO()
        write_gfa(g, buf)
        for line in buf.getvalue().splitlines():
            if not (line.startswith("S\t") or line.startswith("H\t")):
                print(line)
    elif args.to_gfa:
        write_gfa(g, sys.stdout)
    # like the reference, `view` without an output flag prints nothing
    return 0


def cmd_validate(args):
    g = load_any(args.input, args.device)
    problems = g.validate()
    for p in problems:
        print(p, file=sys.stderr)
    return 1 if problems else 0


def _g(v) -> str:
    """6-significant-digit formatting like the reference's default cout."""
    if v is None:
        return "0"
    return f"{v:.6g}"


def cmd_stats(args):
    """`odgi stats`: TSV, or YAML with -y and MultiQC with -m."""
    dev = args.device
    g = load_any(args.input, dev)
    yaml = bool(args.yaml or args.multiqc)
    mqc = bool(args.multiqc)
    xy = None
    if args.coords_in:
        coords = load_layout(args.coords_in)
        xy = (coords[:, 0], coords[:, 1])

    a_delim = a_pos = None
    if args.pangenome_sequence_class_counts:
        parts = args.pangenome_sequence_class_counts.split(",")
        if len(parts) != 2:
            print(
                "[odgi::stats] error: Argument for -a,"
                "--pangenome-sequence-classes malformed. Please follow "
                "DEL,POS.",
                file=sys.stderr,
            )
            return 1
        a_delim, a_pos = parts[0], int(parts[1])

    no_args = not any(
        [
            args.weakly_connected_components, args.self_loops,
            args.nondeterministic_edges, args.base_content, args.delim,
            args.file_size, args.pangenome_sequence_class_counts,
            args.mean_links_length, args.no_gap_links,
            args.sum_path_nodes_distances,
            args.penalize_different_orientation, args.path_statistics,
            args.weighted_feedback_arc, args.weighted_reversing_join,
            args.links_length_per_nuc, args.multiqc, args.yaml,
            args.is_acyclic, args.count_walks, args.shortest_cycle,
        ]
    )

    if yaml:
        print("---")

    if args.summarize or mqc or no_args:
        s = stats.summary(g)
        if yaml:
            for k in ("length", "nodes", "edges", "paths", "steps"):
                print(f"{k}: {s[k]}")
        else:
            print("#length\tnodes\tedges\tpaths\tsteps")
            print(
                f"{s['length']}\t{s['nodes']}\t{s['edges']}\t{s['paths']}\t{s['steps']}"
            )

    if args.weakly_connected_components or mqc:
        comps = weak_components(g)
        if yaml:
            print(f"num_weakly_connected_components: {len(comps)}")
            print("weakly_connected_components: ")
        else:
            print(f"##num_weakly_connected_components: {len(comps)}")
            print("#component\tnodes\tis_acyclic")
        for i, c in enumerate(comps):
            acyc = "yes" if stats.component_is_acyclic(g, c) else "no"
            if yaml:
                print("  - component:")
                print(f"      id: {i}")
                print(f"      nodes: {len(c)}")
                print(f"      is_acyclic: '{acyc}'")
            else:
                print(f"{i}\t{len(c)}\t{acyc}")

    if args.self_loops or mqc:
        total = num_self_loops(g)
        uniq = stats.unique_self_loop_nodes(g, device=dev)
        if yaml:
            print("num_nodes_self_loops:")
            print(f"  total: {total}")
            print(f"  unique: {uniq}")
        else:
            print("#type\tnum")
            print(f"total\t{total}")
            print(f"unique\t{uniq}")

    if args.nondeterministic_edges and not yaml:
        print("#from_node\tto_node")
        for frm, to in stats.nondeterministic_edges(g):
            print(f"{frm}\t{to}")

    if args.base_content or mqc:
        for base, count in sorted(stats.base_content(g, device=dev).items()):
            print(f"{base}: {count}" if yaml else f"{base}\t{count}")

    if args.file_size or mqc:
        try:
            fsize = os.path.getsize(args.input)
        except OSError as e:
            print(f"[odgi::stats] error: {args.input} : {e}", file=sys.stderr)
            return 1
        print(f"file_size_in_bytes: {fsize}" if yaml else f"{fsize}")

    if a_delim is not None:
        cc = stats.pangenome_class_counts(g, a_delim, a_pos, device=dev)
        if yaml:
            print("pangenome_sequence_class_counts:")
            for name, (core, priv, shell) in cc.items():
                print("  - sample: ")
                print(f"      name: {name}")
                print(f"      core: {core}")
                print(f"      private: {priv}")
                print(f"      shell: {shell}")
        else:
            print("#name\tcore\tprivate\tshell")
            for name, (core, priv, shell) in cc.items():
                print(f"{name}\t{core}\t{priv}\t{shell}")

    if args.mean_links_length or mqc:
        m = stats.mean_links_length(
            g, xy=xy, penalize_gap_links=not args.no_gap_links, device=dev
        )
        in_2d = xy is not None
        if yaml:
            print("mean_links_length:")
        else:
            print("#mean_links_length")
            if in_2d:
                print("path\tin_2D_space\tnum_links_considered")
            else:
                hdr = "path\tin_node_space\tin_nucleotide_space\tnum_links_considered"
                if args.no_gap_links:
                    hdr += "\tnum_gap_links_not_penalized"
                print(hdr)

        def links_row(name, node_sp, nt_sp, d2, nl, ngl, is_all):
            if yaml:
                print("  - length:")
                print(f"      path: {name}")
                if in_2d:
                    print(f"      in_2D_space: {_g(d2)}")
                else:
                    print(f"      in_node_space: {_g(node_sp)}")
                    print(f"      in_nucleotide_space: {_g(nt_sp)}")
                print(f"      num_links_considered: {nl}")
                if args.no_gap_links or (mqc and is_all):
                    print(f"      num_gap_links_not_penalized: {ngl}")
            elif in_2d:
                print(f"{name}\t{_g(d2)}\t{nl}")
            else:
                row = f"{name}\t{_g(node_sp)}\t{_g(nt_sp)}\t{nl}"
                if args.no_gap_links:
                    row += f"\t{ngl}"
                print(row)

        if args.path_statistics:
            for p in range(g.num_paths):
                links_row(
                    g.path_names[p],
                    m.per_path_node_space[p],
                    m.per_path_nt_space[p],
                    m.per_path_2d[p] if in_2d else None,
                    int(m.per_path_num_links[p]),
                    int(m.per_path_num_gap_links[p]),
                    False,
                )
        links_row(
            "all_paths", m.all_node_space, m.all_nt_space, m.all_2d,
            m.all_num_links, m.all_num_gap_links, True,
        )

    if args.sum_path_nodes_distances or mqc:
        d = stats.sum_of_path_node_distances(
            g, xy=xy, penalize_diff_orientation=args.penalize_different_orientation,
            device=dev,
        )
        in_2d = xy is not None
        if yaml:
            print("sum_of_path_node_distances:")
        else:
            print("#sum_of_path_node_distances")
            if in_2d:
                hdr = "path\tin_2D_space_by_nodes\tin_2D_space_by_nucleotides\tnodes\tnucleotides"
            else:
                hdr = "path\tin_node_space\tin_nucleotide_space\tnodes\tnucleotides\tnum_penalties"
            if args.penalize_different_orientation:
                hdr += "\tnum_penalties_different_orientation"
            print(hdr)

        def dist_row(name, node_sp, nt_sp, d2n, d2nt, nodes, nts, pen, pend, is_all):
            if yaml:
                print("  - distance:")
                print(f"      path: {name}")
                if in_2d:
                    print(f"      in_2D_space_by_nodes: {_g(d2n)}")
                    print(f"      in_2D_space_by_nucleotides: {_g(d2nt)}")
                    print(f"      nodes: {nodes}")
                    print(f"      nucleotides: {nts}")
                else:
                    print(f"      in_node_space: {_g(node_sp)}")
                    print(f"      in_nucleotide_space: {_g(nt_sp)}")
                    print(f"      nodes: {nodes}")
                    print(f"      nucleotides: {nts}")
                    print(f"      num_penalties: {pen}")
                if args.penalize_different_orientation or (mqc and is_all):
                    print(f"      num_penalties_different_orientation: {pend}")
            else:
                if in_2d:
                    row = f"{name}\t{_g(d2n)}\t{_g(d2nt)}\t{nodes}\t{nts}"
                else:
                    row = f"{name}\t{_g(node_sp)}\t{_g(nt_sp)}\t{nodes}\t{nts}\t{pen}"
                if args.penalize_different_orientation:
                    row += f"\t{pend}"
                print(row)

        if args.path_statistics:
            for p in range(g.num_paths):
                dist_row(
                    g.path_names[p],
                    d.per_path_node_space[p],
                    d.per_path_nt_space[p],
                    d.per_path_2d[p] if in_2d else None,
                    (
                        d.per_path_2d[p]
                        * d.per_path_nodes[p]
                        / max(int(d.per_path_nucleotides[p]), 1)
                        if in_2d
                        else None
                    ),
                    int(d.per_path_nodes[p]),
                    int(d.per_path_nucleotides[p]),
                    int(d.per_path_num_penalties[p]),
                    int(d.per_path_num_penalties_diff_orientation[p]),
                    False,
                )
        dist_row(
            "all_paths", d.all_node_space, d.all_nt_space,
            d.all_2d_by_nodes, d.all_2d_by_nucleotides,
            int(d.per_path_nodes.sum()), int(d.per_path_nucleotides.sum()),
            d.all_num_penalties, d.all_num_penalties_diff_orientation, True,
        )

    for flag, fn, label in (
        ("weighted_feedback_arc", stats.weighted_feedback_arcs, "weighted_feedback_arc"),
        ("weighted_reversing_join", stats.weighted_reversing_joins, "weighted_reversing_join"),
    ):
        if getattr(args, flag):
            per, total = fn(g, device=dev)
            if yaml:
                print(f"{label}: {total}")
            else:
                print(f"path\t{label}")
                if args.path_statistics:
                    for p in range(g.num_paths):
                        print(f"{g.path_names[p]}\t{int(per[p])}")
                print(f"all_paths\t{total}")

    if args.is_acyclic:
        print("is_acyclic: " + ("yes" if is_acyclic(g) else "no"))
    if args.count_walks:
        print(f"count_walks: {count_walks(g)}")
    if args.shortest_cycle:
        c = shortest_cycle_length(g)
        print(f"shortest_cycle_length: {c if c < (1 << 63) - 1 else 'none'}")

    if args.links_length_per_nuc:
        links_len, nucs = stats.links_length_per_nuc(g, device=dev)
        ratio = links_len / nucs if nucs else 0.0
        if yaml:
            print(f"links_length_per_nuc: {_g(ratio)}")
        else:
            print("path\tlinks_length_per_nuc")
            print(f"all_paths\t{_g(ratio)}")
    return 0


def _path_indices(g, fname: str, cmd: str) -> Optional[List[int]]:
    """Path indices of the names in `fname`, one a line; None (after an
    error line on stderr) when a name is not in the graph."""
    out = []
    with open(fname) as f:
        for line in f:
            line = line.strip()
            if line:
                if line not in g.path_names:
                    print(f"[odgi::{cmd}] error: path {line} not found in graph",
                          file=sys.stderr)
                    return None
                out.append(g.path_names.index(line))
    return out


def cmd_sort(args):
    """`odgi sort` with the reference's sort-mode precedence."""
    dev = args.device
    g = load_any(args.input, dev)
    if args.optimize:
        g = g.optimize()
    sgd_overrides = {}
    for flag, key in [
        ("sgd_iter_max", "iter_max"),
        ("sgd_eps", "eps"),
        ("sgd_delta", "delta"),
        ("sgd_eta_max", "eta_max"),
        ("sgd_zipf_theta", "theta"),
        ("sgd_zipf_space", "space"),
        ("sgd_zipf_space_max", "space_max"),
        ("sgd_zipf_space_quantization_step", "space_quantization_step"),
        ("sgd_cooling", "cooling_start"),
        ("sgd_iter_with_max_learning_rate", "iter_with_max_learning_rate"),
    ]:
        v = getattr(args, flag)
        if v is not None:
            sgd_overrides[key] = v
    if args.sgd_seed is not None:
        # the reference hashes its seed string; integers are taken as they are
        try:
            sgd_overrides["seed"] = int(args.sgd_seed)
        except ValueError:
            sgd_overrides["seed"] = zlib.crc32(args.sgd_seed.encode())
    if args.sgd_mtu_nodes:
        sgd_overrides["min_term_updates"] = int(args.sgd_mtu_nodes * g.num_nodes)
    elif args.sgd_mtu_paths:
        sgd_overrides["min_term_updates"] = int(args.sgd_mtu_paths * g.num_steps)
    if args.sgd_zipf_max_dists and "space_quantization_step" not in sgd_overrides:
        # the quantization step derived from the largest count of distributions
        space = int(g.path_length.max()) if g.num_paths else 1
        space_max = sgd_overrides.get("space_max", 100)
        md = max(args.sgd_zipf_max_dists, space_max + 1)
        if space > space_max:
            sgd_overrides["space_quantization_step"] = max(
                2, -(-(space - space_max) // (md - space_max))
            )
    if args.pipeline:
        pipeline = args.pipeline
    elif args.two:
        pipeline = "w"
    elif args.sort_order:
        with open(args.sort_order) as f:
            order_ids = [int(line) for line in f if line.strip()]
        order = np.asarray([g.id_to_rank[i] for i in order_ids], dtype=np.int64)
        g = g.apply_ordering(order, compact_ids=True)
        pipeline = ""
    elif args.dagify_sort:
        pipeline = "d"
    elif args.cycle_breaking:
        pipeline = "c"
    elif args.no_seeds:
        pipeline = "n"
    elif args.path_sgd:
        pipeline = "Y"
    elif args.breadth_first:
        pipeline = "b"
    elif args.depth_first:
        pipeline = "z"
    elif args.random:
        pipeline = "r"
    elif args.optimize:
        pipeline = ""
    else:
        pipeline = "s"
    use_paths = target_paths = None
    if args.sgd_use_paths:
        use_paths = _path_indices(g, args.sgd_use_paths, "sort")
        if use_paths is None:
            return 1
    if args.sgd_target_paths:
        target_paths = _path_indices(g, args.sgd_target_paths, "sort")
        if target_paths is None:
            return 1
    if pipeline:
        metrics = StepMetrics(args.metrics, "sort1d") if args.metrics else None
        with maybe_profile(args.profile, dev):
            g = sort_pipeline(
                g,
                pipeline,
                progress=args.progress,
                sgd_overrides=sgd_overrides or None,
                target_paths=target_paths,
                snapshot_prefix=args.sgd_snapshot,
                use_paths=use_paths,
                bfs_chunk=args.breadth_first_chunk,
                dfs_chunk=args.depth_first_chunk,
                device=dev,
            )
        if args.sgd_layout_out:
            # -e: the sorted 1D positions as a .lay (y = 0)
            pos = g.node_offset.astype(np.float64)
            coords = np.zeros((2 * g.num_nodes, 2), np.float64)
            coords[0::2, 0] = pos
            coords[1::2, 0] = pos + g.node_len
            save_lay(coords, args.sgd_layout_out)
        if metrics is not None:
            metrics.record_summary(pipeline=pipeline, nodes=int(g.num_nodes),
                                   steps=int(g.num_steps))
            metrics.write()
    delim = args.path_delim or ""
    for flag, avg, rev in (("paths_min", False, False), ("paths_max", False, True),
                           ("paths_avg", True, False), ("paths_avg_rev", True, True)):
        if getattr(args, flag):
            g = g.keep_paths(prefix_and_id_ordered_paths(g, delim, avg=avg, rev=rev))
    _out_graph(g, args.out)
    return 0


def cmd_layout(args):
    """`odgi layout` with the reference's PG-SGD flag surface."""
    dev = args.device
    g = load_any(args.input, dev)
    if not g.is_optimized():
        g = g.optimize()
    overrides = {}
    if args.iter_max:
        overrides["iter_max"] = args.iter_max
    if args.path_sgd_min_term_updates_paths:
        overrides["min_term_updates"] = int(
            args.path_sgd_min_term_updates_paths * g.num_steps
        )
    elif args.path_sgd_min_term_updates_nodes:
        overrides["min_term_updates"] = int(
            args.path_sgd_min_term_updates_nodes * g.num_nodes
        )
    for flag, key in (("path_sgd_delta", "delta"), ("path_sgd_eta", "eps"),
                      ("path_sgd_eta_max", "eta_max"), ("path_sgd_zipf_theta", "theta"),
                      ("path_sgd_cooling", "cooling_start"),
                      ("path_sgd_iteration_max_learning_rate", "iter_with_max_learning_rate"),
                      ("path_sgd_zipf_space_max", "space_max"),
                      ("path_sgd_seed", "seed")):
        v = getattr(args, flag)
        if v is not None:
            overrides[key] = v
    if args.path_sgd_zipf_space is not None:
        overrides["space"] = min(args.path_sgd_zipf_space, int(g.path_step_count.max()))
    if args.path_sgd_zipf_space_quantization_step is not None:
        overrides["space_quantization_step"] = max(
            2, args.path_sgd_zipf_space_quantization_step
        )
    use_paths = None
    if args.path_sgd_use_paths:
        with open(args.path_sgd_use_paths) as f:
            use_paths = [g.path_names.index(line.strip()) for line in f if line.strip()]
    snapshot_cb = None
    if args.path_sgd_snapshot:
        prefix = args.path_sgd_snapshot

        def snapshot_cb(it, coords):
            # one .lay an iteration
            save_layout(coords, f"{prefix}{it + 1}", device=dev)

    if args.progress and snapshot_cb is None:
        meter = ProgressMeter(overrides.get("iter_max", 30),
                              "[odgi_tpu_torch::layout] 2D PG-SGD iterations")

        def snapshot_cb(it, coords, _m=meter):
            _m.increment()
            if it + 1 >= _m.total:
                _m.finish()

    metrics = None
    if args.metrics:
        # a per-iteration callback: the batched path, as -u takes
        metrics = StepMetrics(args.metrics, "layout2d")
        prev_cb = snapshot_cb

        def snapshot_cb(it, coords, _p=prev_cb, _m=metrics):
            _m.record_iteration(it, coords)
            if _p is not None:
                _p(it, coords)

    cfg = derive_config_2d(g, **overrides)
    with maybe_profile(args.profile, dev):
        coords = layout_graph(g, cfg, init_mode=args.init, use_paths=use_paths,
                              snapshot_cb=snapshot_cb, device=dev)
    if metrics is not None:
        metrics.record_summary(iter_max=cfg.iter_max, min_term_updates=cfg.min_term_updates)
        metrics.write()
    if args.out:
        save_layout(coords, args.out, device=dev)
    if args.tsv:
        layout_to_tsv(coords, sys.stdout if args.tsv == "-" else args.tsv)
    return 0


def cmd_paths(args):
    """`odgi paths`: list, lengths, FASTA, the haplotype matrix, the
    non-reference nodes and ranges, sequence classes, overlaps and path
    subsets."""
    g = load_any(args.input, args.device)
    if args.list and args.list_path_start_end:
        for p in range(g.num_paths):
            print(f"{g.path_names[p]}\t1\t{int(g.path_length[p])}")
    elif args.list:
        for name in g.path_names:
            print(name)
    if args.lengths:
        print("#path\tlength\tsteps")
        for p in range(g.num_paths):
            print(f"{g.path_names[p]}\t{int(g.path_length[p])}\t{int(g.path_step_count[p])}")
    if args.fasta:
        pc.write_fasta(g, sys.stdout, line_width=args.fasta_line_width)
    if args.haplotypes:
        pc.write_haplotype_matrix(g, sys.stdout, scale_by_length=args.scale_by_node_length,
                                  group_delim=args.delim)

    def load_names(fname):
        out = []
        with open(fname) as f:
            for line in f:
                line = line.strip()
                if line:
                    if line not in g.path_names:
                        print(f"[odgi::paths] error: path'{line}' does not exist in graph.",
                              file=sys.stderr)
                        sys.exit(1)
                    out.append(g.path_names.index(line))
        return out

    if args.non_reference_nodes:
        refs = load_names(args.non_reference_nodes)
        print("#node.id\tnode.len\tnum.uncalled.bases\tpaths")
        for row in pc.non_reference_nodes_rows(g, refs, args.min_size):
            print("\t".join(str(v) for v in row))
    elif args.non_reference_ranges:
        refs = load_names(args.non_reference_ranges)
        print("#path.name\tstart\tend" + ("\tsteps" if args.show_step_ranges else ""))
        for row in pc.non_reference_ranges_rows(g, refs, args.min_size, args.show_step_ranges):
            print("\t".join(str(v) for v in row))

    if args.coverage_levels or args.fraction_levels:
        levels = [float(v) for v in (args.coverage_levels or args.fraction_levels).split(",")]
        hdr, rows = pc.sequence_class_tables(
            g, levels, bool(args.fraction_levels), delim=args.delim,
            delim_pos=max(args.delim_pos - 1, 0), min_size=args.min_size,
            path_ranges=args.path_range_class, show_steps=args.show_step_ranges,
        )
        print(hdr)
        for row in rows:
            print("\t".join(str(v) for v in row))

    if args.overlaps:
        groups = {}
        with open(args.overlaps) as f:
            for line in f:
                line = line.rstrip("\n")
                if line:
                    vals = line.split("\t")
                    groups.setdefault(vals[0], []).append(vals[1] if len(vals) > 1 else vals[0])
        print("group.name\tquery\ttarget\toverlap\toverlap.frac")
        for row in pc.overlaps_table(g, sorted(groups.items())):
            print(f"{row[0]}\t{row[1]}\t{row[2]}\t{row[3]}\t{row[4]:.6g}")

    if args.keep_paths or args.drop_paths:
        keep = load_names(args.keep_paths) if args.keep_paths else list(range(g.num_paths))
        if args.drop_paths:
            drop = set(load_names(args.drop_paths))
            keep = [p for p in keep if p not in drop]
        if args.out:
            _out_graph(g.keep_paths(keep), args.out)
    return 0


def cmd_version(args):
    if args.version:
        print(version.get_version())
    elif args.codename:
        print(version.get_codename())
    elif args.release:
        print(version.get_release())
    else:
        print(version.get_short())
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="odgi_tpu_torch", description="pangenome graph engine on one NVIDIA H100"
    )
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("build", help="construct a graph from GFA")
    p.add_argument("-g", "--gfa", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-O", "--optimize", action="store_true")
    p.add_argument("-s", "--sort", action="store_true")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-P", "--progress", action="store_true")
    p.add_argument("-d", "--debug", action="store_true")
    p.set_defaults(fn=cmd_build)

    p = sub.add_parser("view", help="write graph as GFA to stdout")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-g", "--to-gfa", action="store_true")
    p.add_argument("-a", "--node-annotation", action="store_true")
    p.add_argument("-P", "--progress", action="store_true")
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("validate", help="check path/edge consistency")
    p.add_argument("-i", "--input", required=True)
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser("stats", help="graph statistics")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-S", "--summarize", action="store_true")
    p.add_argument("-W", "--weakly-connected-components", action="store_true")
    p.add_argument("-L", "--self-loops", action="store_true")
    p.add_argument("-b", "--base-content", action="store_true")
    p.add_argument("-l", "--mean-links-length", action="store_true")
    p.add_argument("-g", "--no-gap-links", action="store_true")
    p.add_argument("-s", "--sum-path-nodes-distances", action="store_true")
    p.add_argument("-d", "--penalize-different-orientation", action="store_true")
    p.add_argument("-w", "--weighted-feedback-arc", action="store_true")
    p.add_argument("-j", "--weighted-reversing-join", action="store_true")
    p.add_argument("-c", "--coords-in", default=None)
    p.add_argument("-p", "--path-statistics", action="store_true")
    p.add_argument("-m", "--multiqc", action="store_true")
    p.add_argument("-y", "--yaml", action="store_true")
    p.add_argument("-f", "--file-size", action="store_true")
    p.add_argument("-a", "--pangenome-sequence-class-counts", default=None)
    p.add_argument("-D", "--delim", default=None)
    p.add_argument("-q", "--links_length_per_nuc", "--links-length-per-nuc",
                   dest="links_length_per_nuc", action="store_true")
    p.add_argument("-N", "--nondeterministic-edges", action="store_true")
    p.add_argument("--is-acyclic", action="store_true",
                   help="extension: whole-graph acyclicity check")
    p.add_argument("--count-walks", action="store_true",
                   help="extension: source-to-sink walk count")
    p.add_argument("--shortest-cycle", action="store_true",
                   help="extension: shortest cycle length in bp")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-P", "--progress", action="store_true")
    p.set_defaults(fn=cmd_stats)

    p = sub.add_parser("sort", help="sort the graph")
    p.add_argument("-i", "--input", "--idx", dest="input", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-p", "--pipeline", default=None, help="e.g. Ygs")
    p.add_argument("-Y", "--path-sgd", action="store_true")
    p.add_argument("-O", "--optimize", action="store_true")
    p.add_argument("-b", "--breadth-first", action="store_true")
    p.add_argument("-z", "--depth-first", action="store_true")
    p.add_argument("-c", "--cycle-breaking", action="store_true")
    p.add_argument("-w", "--two", action="store_true")
    p.add_argument("-n", "--no-seeds", action="store_true")
    p.add_argument("-r", "--random", action="store_true")
    p.add_argument("-d", "--dagify-sort", action="store_true")
    p.add_argument("-s", "--sort-order")
    p.add_argument("-L", "--paths-min", action="store_true")
    p.add_argument("-M", "--paths-max", action="store_true")
    p.add_argument("-A", "--paths-avg", action="store_true")
    p.add_argument("-R", "--paths-avg-rev", action="store_true")
    p.add_argument("-D", "--path-delim")
    p.add_argument("-x", "--path-sgd-iter-max", dest="sgd_iter_max", type=int)
    p.add_argument("-g", "--path-sgd-eps", dest="sgd_eps", type=float)
    p.add_argument("-j", "--path-sgd-delta", dest="sgd_delta", type=float)
    p.add_argument("-v", "--path-sgd-eta-max", dest="sgd_eta_max", type=float)
    p.add_argument("-a", "--path-sgd-zipf-theta", dest="sgd_zipf_theta", type=float)
    p.add_argument("-k", "--path-sgd-zipf-space", dest="sgd_zipf_space", type=int)
    p.add_argument(
        "-I", "--path-sgd-zipf-space-max", dest="sgd_zipf_space_max", type=int
    )
    p.add_argument(
        "-l",
        "--path-sgd-zipf-space-quantization-step",
        dest="sgd_zipf_space_quantization_step",
        type=int,
    )
    p.add_argument("-K", "--path-sgd-cooling", dest="sgd_cooling", type=float)
    p.add_argument(
        "-F",
        "--iteration-max-learning-rate",
        dest="sgd_iter_with_max_learning_rate",
        type=int,
    )
    p.add_argument("-u", "--path-sgd-snapshot", dest="sgd_snapshot", default=None)
    p.add_argument("-H", "--target-paths", dest="sgd_target_paths", default=None)
    p.add_argument("-q", "--path-sgd-seed", dest="sgd_seed", default=None)
    p.add_argument(
        "-f", "--path-sgd-use-paths", dest="sgd_use_paths", default=None
    )
    p.add_argument(
        "-G", "--path-sgd-min-term-updates-paths",
        dest="sgd_mtu_paths", type=float, default=None,
    )
    p.add_argument(
        "-U", "--path-sgd-min-term-updates-nodes",
        dest="sgd_mtu_nodes", type=float, default=None,
    )
    p.add_argument(
        "-y", "--path-sgd-zipf-max-num-distributions",
        dest="sgd_zipf_max_dists", type=int, default=None,
    )
    p.add_argument(
        "-e", "--path-sgd-layout", dest="sgd_layout_out", default=None
    )
    p.add_argument("-B", "--breadth-first-chunk", type=int, default=0)
    p.add_argument("-Z", "--depth-first-chunk", type=int, default=0)
    # accepted for drop-in parity: indexes are built in memory and no
    # temporary files are used
    p.add_argument("-X", "--path-index", default=None)
    p.add_argument("-C", "--temp-dir", default=None)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-P", "--progress", action="store_true")
    p.add_argument("--metrics", default=None, metavar="FILE",
                   help="write JSONL run metrics (see utils/metrics.py)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the optimization, with the "
                        "program's spans (PERF.md section 3 lists them)")
    p.set_defaults(fn=cmd_sort)

    p = sub.add_parser("layout", help="2D PG-SGD layout")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--out", default=None)
    p.add_argument("-T", "--tsv", default=None)
    p.add_argument("-X", "--path-index", default=None)
    p.add_argument("-C", "--temp-dir", default=None)
    p.add_argument("-f", "--path-sgd-use-paths", default=None)
    p.add_argument("-N", "--init", "--layout-initialization", dest="init",
                   default="d", choices=list("drugh"))
    p.add_argument("-G", "--path-sgd-min-term-updates-paths", type=float)
    p.add_argument("-U", "--path-sgd-min-term-updates-nodes", type=float)
    p.add_argument("-j", "--path-sgd-delta", type=float)
    p.add_argument("-g", "--path-sgd-eta", type=float)
    p.add_argument("-v", "--path-sgd-eta-max", type=float)
    p.add_argument("-a", "--path-sgd-zipf-theta", type=float)
    p.add_argument("-x", "--path-sgd-iter-max", "--iter-max",
                   dest="iter_max", type=int, default=None)
    p.add_argument("-K", "--path-sgd-cooling", type=float)
    p.add_argument("-F", "--path-sgd-iteration-max-learning-rate", type=int)
    p.add_argument("-k", "--path-sgd-zipf-space", type=int)
    p.add_argument("-I", "--path-sgd-zipf-space-max", type=int)
    p.add_argument("-l", "--path-sgd-zipf-space-quantization-step", type=int)
    p.add_argument("-q", "--path-sgd-seed", type=int)
    p.add_argument("-u", "--path-sgd-snapshot", default=None)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-P", "--progress", action="store_true")
    p.add_argument("--metrics", default=None, metavar="FILE",
                   help="write JSONL per-iteration metrics (a per-iteration "
                        "callback: the batched path)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the optimization, with the "
                        "program's spans (PERF.md section 3 lists them)")
    p.set_defaults(fn=cmd_layout)

    p = sub.add_parser("paths", help="path information")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--out", default=None)
    p.add_argument("-L", "--list", "--list-paths", action="store_true")
    p.add_argument("-e", "--list-path-start-end", action="store_true")
    p.add_argument("-l", "--lengths", action="store_true")
    p.add_argument("-f", "--fasta", action="store_true")
    p.add_argument("-w", "--fasta-line-width", type=int, default=0)
    p.add_argument("-H", "--haplotypes", action="store_true")
    p.add_argument("-D", "--delim", default=None)
    p.add_argument("-p", "--delim-pos", type=int, default=1)
    p.add_argument("-N", "--scale-by-node-length", "-s",
                   dest="scale_by_node_length", action="store_true")
    p.add_argument("--non-reference-nodes", default=None)
    p.add_argument("--non-reference-ranges", default=None)
    p.add_argument("--coverage-levels", default=None)
    p.add_argument("--fraction-levels", default=None)
    p.add_argument("--path-range-class", action="store_true")
    p.add_argument("--min-size", type=int, default=0)
    p.add_argument("--show-step-ranges", action="store_true")
    p.add_argument("-O", "--overlaps", default=None)
    p.add_argument("-K", "--keep-paths", default=None)
    p.add_argument("-X", "--drop-paths", default=None)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-P", "--progress", action="store_true")
    p.set_defaults(fn=cmd_paths)

    p = sub.add_parser("version", help="print the version")
    p.add_argument("-v", "--version", action="store_true")
    p.add_argument("-c", "--codename", action="store_true")
    p.add_argument("-r", "--release", action="store_true")
    p.set_defaults(fn=cmd_version)

    register2(sub)
    register3(sub)
    return ap


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """Run one subcommand on `device` (None: the card, raising without
    one); returns its exit code."""
    args = build_parser().parse_args(argv)
    args.device = resolve_device(device)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # downstream closed (e.g. | head); exit quietly like a unix tool
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    sys.exit(main())
