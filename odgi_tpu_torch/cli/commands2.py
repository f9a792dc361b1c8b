"""The subcommands of ``odgi_tpu/cli/commands2.py``: depth, degree, viz,
draw (the pictures and the numbers beside them); chop, unchop, normalize,
flip, prune, explode, squeeze, flatten (graph edits); kmers, matrix,
similarity, tension, heaps, pav (pangenome analytics); and untangle,
panpos, position, extract, overlap (positions and subgraphs), with
``odgi_tpu.cli``'s flags, output and written bytes.  Host code; pictures
are written without PIL (``io/png.py``, ``algorithms/font.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import io as _io
import os
import re
import sys
from collections import Counter
from contextlib import nullcontext

import numpy as np

from ..algorithms import coverage as cov
from ..algorithms import degree as degalg
from ..algorithms import liftover as lift
from ..algorithms.analytics import (
    for_each_graph_kmer,
    heaps_permutations,
    node_tension,
    pav_table,
    write_graph_kmers,
    write_matrix,
)
from ..algorithms.chop import chop
from ..algorithms.draw import bed_node_colors, draw_png, draw_svg
from ..algorithms.extract import extract_nodes, nodes_in_path_range, read_bed
from ..algorithms.paths_cmd import flatten, path_jaccard_matrix
from ..algorithms.position import panpos, path_index
from ..algorithms.simplify import normalize
from ..algorithms.transforms import (
    cut_tips,
    explode,
    flip_paths,
    prune_high_degree,
    prune_low_depth,
    squeeze,
)
from ..algorithms.unchop import unchop
from ..algorithms.untangle import self_dotplot, untangle
from ..algorithms.viz import render_viz
from ..core.graph import handle_rank
from ..core.index import XPT_MAGIC, PathIndex
from ..io import png
from ..io.lay import load_layout
from .region import (
    PathRange,
    add_bed_range,
    fmt_double,
    get_graph_pos_of_path_pos,
    load_subset_paths,
    parse_graph_pos,
    parse_path_pos,
    parse_windows_spec,
    path_index_by_name,
)


def cmd_depth(args):
    """Full-parity `odgi depth` (reference: src/subcommand/depth_main.cpp):
    graph/path positions, BED ranges, path subsets, depth tables/vectors,
    summaries and depth windows."""
    from .main import load_any

    if args.windows_in and args.windows_out:
        print(
            "[odgi::depth] error: please specify -w/--windows-in or "
            "-W/--windows-out, not both.",
            file=sys.stderr,
        )
        return 1
    win = None
    if args.windows_in:
        win = parse_windows_spec(args.windows_in, "depth", "-w/--windows-in")
    if args.windows_out:
        win = parse_windows_spec(args.windows_out, "depth", "-W/--windows-out")

    g = load_any(args.input, args.device)
    paths_mask = (
        load_subset_paths(g, args.subset_paths, "depth")
        if args.subset_paths
        else np.ones(g.num_paths, dtype=bool)
    )
    sel_paths = [p for p in range(g.num_paths) if paths_mask[p]]
    subset = sel_paths if args.subset_paths else None
    depth = cov.node_depth(g, subset)
    depth_uniq = cov.node_depth_unique(g, subset)

    graph_positions = []
    path_positions = []
    path_ranges = []

    if args.summarize:
        pass
    elif args.graph_depth_table:
        for r in range(g.num_nodes):
            graph_positions.append(
                parse_graph_pos(g, str(int(g.node_id[r])), "depth")
            )
    elif args.graph_depth_vec:
        out = [f"{args.input}_vec"]
        for r in range(g.num_nodes):
            out.append(f" {int(depth[r])}" * int(g.node_len[r]))
        sys.stdout.write("".join(out) + "\n")
        return 0
    elif args.path_depth or args.self_depth:
        # -D uses TOTAL step count per node (reference: depth_main.cpp:281);
        # -a counts only the path's own steps (reference: :312-319)
        total_depth = cov.node_depth(g)
        for p in sel_paths:
            lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
            ranks = handle_rank(g.step_handle[lo:hi])
            lens = g.node_len[ranks]
            if args.self_depth:
                own = np.bincount(ranks, minlength=g.num_nodes)
                vals = own[ranks]
            else:
                vals = total_depth[ranks]
            parts = [g.path_names[p]]
            for v, ln in zip(vals, lens):
                parts.append(f" {int(v)}" * int(ln))
            sys.stdout.write("".join(parts) + "\n")
        return 0
    elif args.graph_pos:
        graph_positions.append(parse_graph_pos(g, args.graph_pos, "depth"))
    elif args.graph_pos_file:
        with open(args.graph_pos_file) as f:
            for line in f:
                line = line.rstrip("\n")
                if line:
                    graph_positions.append(parse_graph_pos(g, line, "depth"))
    elif args.path_pos:
        pp = parse_path_pos(g, args.path_pos, "depth")
        if pp:
            path_positions.append(pp)
    elif args.path_pos_file:
        with open(args.path_pos_file) as f:
            for line in f:
                line = line.rstrip("\n")
                if line:
                    pp = parse_path_pos(g, line, "depth")
                    if pp:
                        path_positions.append(pp)
    elif args.bed_input:
        with open(args.bed_input) as f:
            for line in f:
                add_bed_range(path_ranges, g, line.rstrip("\n"))
    elif args.path:
        add_bed_range(path_ranges, g, args.path)
    elif args.paths:
        with open(args.paths) as f:
            for line in f:
                line = line.rstrip("\n")
                if line:
                    add_bed_range(path_ranges, g, line)
    elif win is None:
        for p in range(g.num_paths):
            add_bed_range(path_ranges, g, g.path_names[p])

    if win is not None:
        merge_len, wmin, wmax, only_tips = win
        wdep = depth_uniq if args.window_unique_depth else depth
        if args.windows_in:
            in_bounds = (wdep >= wmin) & (wdep <= wmax)
        else:
            in_bounds = (wdep < wmin) | (wdep > wmax)
        print("#path\tstart\tend")
        plens = g.path_length
        wpaths = sel_paths if args.subset_paths else range(g.num_paths)
        for p, s, e in degalg.windows_in_out(g, wpaths, in_bounds, merge_len):
            if only_tips and s != 0 and e != int(plens[p]):
                continue
            print(f"{g.path_names[p]}\t{s}\t{e}")

    if args.summarize:
        print(
            "#node.count\tgraph.length\tstep.count\tpath.length"
            "\tmean.node.depth\tmean.graph.depth"
        )
        node_count = g.num_nodes
        graph_length = int(g.node_len.sum())
        step_count = int(depth.sum())
        path_length = int((g.node_len * depth).sum())
        print(
            f"{node_count}\t{graph_length}\t{step_count}\t{path_length}\t"
            f"{fmt_double(step_count / node_count)}\t"
            f"{fmt_double(path_length / graph_length)}"
        )

    if graph_positions:
        print("#node.id\tdepth\tdepth.uniq")
        for gp in graph_positions:
            r = g.id_to_rank[gp.node_id]
            print(f"{gp.node_id}\t{int(depth[r])}\t{int(depth_uniq[r])}")

    if path_positions:
        print("#path.position\tdepth\tdepth.uniq")
        for pp in path_positions:
            gp = get_graph_pos_of_path_pos(g, pp, "depth")
            r = g.id_to_rank.get(gp.node_id)
            d, u = (
                (int(depth[r]), int(depth_uniq[r])) if r is not None else (0, 0)
            )
            print(
                f"{g.path_names[pp.path]},{pp.offset},"
                f"{'-' if pp.is_rev else '+'}\t{d}\t{u}"
            )

    if path_ranges:
        print("#path\tstart\tend\tmean.depth")
        for r, mean in cov.path_range_mean_depth(g, path_ranges, depth):
            print(
                f"{g.path_names[r.path]}\t{r.start}\t{r.end}\t"
                f"{fmt_double(mean)}"
            )
    return 0


def cmd_degree(args):
    """Full-parity `odgi degree` (reference: src/subcommand/degree_main.cpp;
    golden outputs: test/binary/degree/* via scripts/degree.sh)."""
    from .main import load_any

    if args.windows_in and args.windows_out:
        print(
            "[odgi::degree] error: please specify -w/--windows-in or "
            "-W/--windows-out, not both.",
            file=sys.stderr,
        )
        return 1
    if args.summarize and (args.windows_in or args.windows_out):
        print(
            "[odgi::degree] error: please specify -S/--summarize without "
            "specifying windows-in or -W/--windows-out.",
            file=sys.stderr,
        )
        return 1
    win = None
    if args.windows_in:
        win = parse_windows_spec(args.windows_in, "degree", "-w/--windows-in")
    if args.windows_out:
        win = parse_windows_spec(args.windows_out, "degree", "-W/--windows-out")

    g = load_any(args.input, args.device)
    paths_mask = (
        load_subset_paths(g, args.subset_paths, "degree")
        if args.subset_paths
        else np.ones(g.num_paths, dtype=bool)
    )
    deg = degalg.node_total_degree(g)
    in_deg, out_deg = degalg.node_degree_sides(g)
    eff_deg = degalg.effective_degree(g, paths_mask)

    graph_positions = []
    path_positions = []
    path_ranges = []

    if args.summarize:
        pass
    elif args.graph_degree_table:
        for r in range(g.num_nodes):
            graph_positions.append(parse_graph_pos(g, str(int(g.node_id[r])), "degree"))
    elif args.graph_degree_vec:
        out = [f"{args.input}_vec"]
        for r in range(g.num_nodes):
            out.append(f" {int(eff_deg[r])}" * int(g.node_len[r]))
        sys.stdout.write("".join(out) + "\n")
        return 0
    elif args.path_degree or args.self_degree:
        self_counts = degalg.node_self_step_count(g) if args.self_degree else None
        for p in range(g.num_paths):
            if not paths_mask[p]:
                continue
            lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
            ranks = handle_rank(g.step_handle[lo:hi])
            lens = g.node_len[ranks]
            vals = deg[ranks]
            if args.self_degree:
                vals = vals * self_counts[lo:hi]
            parts = [g.path_names[p]]
            for v, ln in zip(vals, lens):
                parts.append(f" {int(v)}" * int(ln))
            sys.stdout.write("".join(parts) + "\n")
        return 0
    elif args.graph_pos:
        graph_positions.append(parse_graph_pos(g, args.graph_pos, "degree"))
    elif args.graph_pos_file:
        with open(args.graph_pos_file) as f:
            for line in f:
                line = line.rstrip("\n")
                if line:
                    graph_positions.append(parse_graph_pos(g, line, "degree"))
    elif args.path_pos:
        pp = parse_path_pos(g, args.path_pos, "degree")
        if pp:
            path_positions.append(pp)
    elif args.path_pos_file:
        with open(args.path_pos_file) as f:
            for line in f:
                line = line.rstrip("\n")
                if line:
                    pp = parse_path_pos(g, line, "degree")
                    if pp:
                        path_positions.append(pp)
    elif args.bed_input:
        with open(args.bed_input) as f:
            for line in f:
                add_bed_range(path_ranges, g, line.rstrip("\n"))
    elif args.path:
        add_bed_range(path_ranges, g, args.path)
    elif args.paths:
        with open(args.paths) as f:
            for line in f:
                line = line.rstrip("\n")
                if line:
                    add_bed_range(path_ranges, g, line)
    elif win is None:
        for p in range(g.num_paths):
            add_bed_range(path_ranges, g, g.path_names[p])

    if win is not None:
        merge_len, wmin, wmax, only_tips = win
        if args.windows_in:
            in_bounds = (deg >= wmin) & (deg <= wmax)
        else:
            in_bounds = (deg < wmin) | (deg > wmax)
        print("#path\tstart\tend")
        plens = g.path_length
        wpaths = [p for p in range(g.num_paths) if paths_mask[p]] if args.subset_paths else range(g.num_paths)
        for p, s, e in degalg.windows_in_out(g, wpaths, in_bounds, merge_len):
            if only_tips and s != 0 and e != int(plens[p]):
                continue
            print(f"{g.path_names[p]}\t{s}\t{e}")

    if args.summarize:
        total = int(deg.sum())
        print("#node.count\tedge.count\tavg.degree\tmin.degree\tmax.degree")
        print(
            f"{g.num_nodes}\t{total // 2}\t"
            f"{fmt_double(total / g.num_nodes)}\t{int(deg.min())}\t{int(deg.max())}"
        )

    if graph_positions:
        hdr = "#node.id\tnode.degree"
        if args.in_out_degree:
            hdr += "\tnode.in.degree\tnode.out.degree"
        print(hdr)
        for gp in graph_positions:
            r = g.id_to_rank[gp.node_id]
            line = f"{gp.node_id}\t{int(deg[r])}"
            if args.in_out_degree:
                line += f"\t{int(in_deg[r])}\t{int(out_deg[r])}"
            print(line)

    if path_positions:
        uniq = degalg.node_unique_path_count(g, paths_mask)
        print("#path.position\tdegree\tdegree.uniq")
        for pp in path_positions:
            gp = get_graph_pos_of_path_pos(g, pp, "degree")
            r = g.id_to_rank.get(gp.node_id)
            d, u = (int(eff_deg[r]), int(uniq[r])) if r is not None else (0, 0)
            print(
                f"{g.path_names[pp.path]},{pp.offset},"
                f"{'-' if pp.is_rev else '+'}\t{d}\t{u}"
            )

    if path_ranges:
        path_ranges.sort(key=lambda r: (r.path, r.start, r.end, r.is_rev))
        means = degalg.path_range_means(g, eff_deg, path_ranges)
        print("#path\tstart\tend\tmean.degree")
        for r, m in zip(path_ranges, means):
            print(
                f"{g.path_names[r.path]}\t{r.start}\t{r.end}\t{fmt_double(m)}"
            )
    return 0


def cmd_viz(args):
    """`odgi viz` with the reference's main flag families
    (reference: src/subcommand/viz_main.cpp:52-160): color modes (strand
    -z is our 'strand', mean-inversion -z gradients 'inversion', uncalled
    -N, prefix -s, custom -c FILE, depth w/ colorbrewer -B), path-name
    labels (-H/-C), prefix merging -M, ignore -I, packing -R, borders
    -n/-b, darkness gradient -d, node highlighting -m."""
    from .main import load_any

    g = load_any(args.input, args.device)
    if args.image_height:
        # reference semantics: -y sets the image height; divide the
        # drawable band among the displayed paths (>= 1 px each)
        n_paths = g.num_paths
        band = max(args.image_height - 20, n_paths)
        args.path_height = max(1, band // max(n_paths, 1))
    color_by = args.color_by
    if args.color_by_mean_inversion_rate:
        color_by = "inversion"
    elif args.color_by_uncalled_bases:
        color_by = "uncalled"
    elif args.color_by_prefix:
        color_by = "prefix"
    elif args.color_by_mean_depth:
        color_by = "depth"

    path_colors = None
    if args.path_colors_file:
        path_colors = {}
        with open(args.path_colors_file) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                name, _, spec = line.partition("\t")
                spec = spec.strip()
                if spec.startswith("#"):
                    rgb = tuple(
                        int(spec[i : i + 2], 16) for i in (1, 3, 5)
                    )
                else:
                    rgb = tuple(int(v) for v in spec.split(","))[:3]
                path_colors[name] = rgb

    merge_prefixes = None
    if args.prefix_merges:
        with open(args.prefix_merges) as f:
            merge_prefixes = [l.strip() for l in f if l.strip()]

    highlight = None
    if args.highlight_node_ids:
        with open(args.highlight_node_ids) as f:
            highlight = [int(l) for l in f if l.strip()]

    paths = None
    if args.path_names_file:
        paths = []
        with open(args.path_names_file) as f:
            for line in f:
                line = line.strip()
                if line:
                    paths.append(g.path_names.index(line))

    img = render_viz(
        g,
        width=args.width,
        path_height=args.path_height,
        color_by=color_by,
        paths=paths,
        prefix_delim=args.color_by_prefix or "#",
        path_colors=path_colors,
        colorbrewer_scheme=args.colorbrewer_palette,
        no_grey_depth=args.no_grey_depth,
        pack_paths=args.pack_paths,
        merge_prefixes=merge_prefixes,
        ignore_prefix=args.ignore_prefix,
        show_path_names=not args.hide_path_names,
        color_path_names_background=args.color_path_names_background,
        max_name_chars=min(args.max_num_of_characters, 128),
        path_borders=not args.no_path_borders,
        black_path_borders=args.black_path_borders,
        change_darkness=args.change_darkness,
        highlight_nodes=highlight,
    )
    png.write(img, args.out)
    return 0


def cmd_draw(args):
    """`odgi draw` with PNG and SVG outputs (reference:
    src/subcommand/draw_main.cpp; SVG: src/algorithms/draw.cpp:200-443)."""
    from .main import load_any

    g = load_any(args.input, args.device)
    coords = load_layout(args.coords_in)
    node_colors = bed_node_colors(g, args.bed) if args.bed else None
    if args.png:
        draw_png(
            g, coords, args.png, width=args.width, color_by=args.color_by
        )
    if args.svg:
        draw_svg(
            g,
            coords,
            args.svg,
            scale=args.scale,
            border=args.border,
            line_width=args.line_width,
            node_colors=node_colors,
            sparsification_factor=args.sparsification_factor,
        )
    if not args.png and not args.svg:
        print(
            "[odgi::draw] error: specify -p/--png and/or -s/--svg output",
            file=sys.stderr,
        )
        return 1
    return 0


def cmd_chop(args):
    from .main import load_any, _out_graph

    g = load_any(args.input, args.device)
    _out_graph(chop(g, args.chop_to), args.out)
    return 0


def cmd_unchop(args):
    from .main import load_any, _out_graph

    g = load_any(args.input, args.device)
    _out_graph(unchop(g), args.out)
    return 0


def cmd_normalize(args):
    """unchop + simplify_siblings fixpoint (reference:
    src/subcommand/normalize_main.cpp + src/algorithms/normalize.cpp)."""
    from .main import load_any, _out_graph

    g = load_any(args.input, args.device)
    g = normalize(g, max_iter=args.max_iterations)
    _out_graph(g, args.out)
    return 0


def cmd_flip(args):
    from .main import load_any, _out_graph

    g = load_any(args.input, args.device)
    _out_graph(flip_paths(g), args.out)
    return 0


def cmd_prune(args):
    from .main import load_any, _out_graph

    g = load_any(args.input, args.device)
    if args.max_degree:
        g = prune_high_degree(g, args.max_degree)
    if args.min_depth:
        g = prune_low_depth(g, args.min_depth)
    if args.cut_tips:
        g = cut_tips(g)
    _out_graph(g, args.out)
    return 0


def cmd_explode(args):
    from .main import load_any, _out_graph

    g = load_any(args.input, args.device)
    for i, part in enumerate(explode(g)):
        _out_graph(part, f"{args.prefix}{i}.otg")
    return 0


def cmd_squeeze(args):
    from .main import load_any, _out_graph

    graphs = [load_any(p, args.device) for p in args.input_list]
    _out_graph(squeeze(graphs), args.out)
    return 0


def cmd_flatten(args):
    from .main import load_any

    if not args.fasta and not args.bed:
        print(
            "[odgi_tpu::flatten] error: please specify at least one "
            "output (-f/--fasta and/or -b/--bed)",
            file=sys.stderr,
        )
        return 1
    g = load_any(args.input, args.device)
    name = args.name or args.input
    fa_cm = open(args.fasta, "w") if args.fasta else nullcontext(_io.StringIO())
    bed_cm = open(args.bed, "w") if args.bed else nullcontext(_io.StringIO())
    with fa_cm as fa, bed_cm as bed:
        flatten(g, fa, bed, name=name)
    return 0


def cmd_kmers(args):
    """`odgi kmers` (reference: src/subcommand/kmers_main.cpp): graph-kmer
    enumeration across edges with furcation cap (-e), optional
    high-degree-node removal (-D), kmers to stdout with -c, otherwise a
    characterization summary."""
    from .main import load_any

    g = load_any(args.input, args.device)
    if args.max_degree:

        g = prune_high_degree(g, args.max_degree)
    if args.stdout:
        write_graph_kmers(g, args.kmer_length, sys.stdout, args.max_furcations)
    else:
        total = 0
        distinct = set()
        for seq, _, _, _ in for_each_graph_kmer(
            g, args.kmer_length, args.max_furcations
        ):
            total += 1
            distinct.add(seq)
        print("#k\ttotal.kmers\tdistinct.kmers")
        print(f"{args.kmer_length}\t{total}\t{len(distinct)}")
    return 0


def cmd_matrix(args):
    from .main import load_any

    g = load_any(args.input, args.device)
    write_matrix(g, sys.stdout, weight_by_paths=args.weight_by_paths)
    return 0


def cmd_similarity(args):
    from .main import load_any

    g = load_any(args.input, args.device)
    jac = path_jaccard_matrix(g)
    print("group.a\tgroup.b\tjaccard")
    for a in range(g.num_paths):
        for b in range(g.num_paths):
            if jac[a, b] > 0:
                print(f"{g.path_names[a]}\t{g.path_names[b]}\t{jac[a, b]:.6g}")
    return 0


def cmd_tension(args):
    from .main import load_any

    g = load_any(args.input, args.device)
    coords = load_layout(args.coords_in)
    t = node_tension(g, coords)
    print("#node.id\ttension")
    for r in range(g.num_nodes):
        print(f"{int(g.node_id[r])}\t{t[r]:.6g}")
    return 0


def cmd_heaps(args):
    """`odgi heaps` (reference: heaps_main.cpp): pangenome growth
    curves with -p/-S/-H groupings, -b BED node targets and -d minimum
    node depth."""

    from .main import load_any

    g = load_any(args.input, args.device)
    path_groups = None
    if args.path_groups:
        mapping = {}
        with open(args.path_groups) as f:
            for line in f:
                if line.strip():
                    nm, _, grp = line.rstrip("\n").partition("\t")
                    mapping[nm] = grp or nm
        path_groups = [mapping.get(n, n) for n in g.path_names]
    elif args.group_by_sample:
        path_groups = [n.split("#")[0] for n in g.path_names]
    elif args.group_by_haplotype:
        path_groups = ["#".join(n.split("#")[:2]) for n in g.path_names]
    mask_ranks = None
    if args.bed_targets:

        sel = []
        for name, a, b in read_bed(args.bed_targets):
            sel.append(nodes_in_path_range(g, path_index(g, name), a, b))
        mask_ranks = np.unique(np.concatenate(sel)) if sel else np.zeros(0)
    curves = heaps_permutations(
        g,
        n_permutations=args.permutations,
        group_delim=args.delim,
        path_groups=path_groups,
        mask_ranks=mask_ranks,
        min_depth=args.min_node_depth,
    )
    print("#permutation\tnth.genome\tbase.pairs")
    for t in range(curves.shape[0]):
        for k in range(curves.shape[1]):
            print(f"{t + 1}\t{k + 1}\t{int(curves[t, k])}")
    return 0


def cmd_pav(args):
    """`odgi pav` (reference: pav_main.cpp): long table by default
    (chrom start end name group pav), matrix with -M; groups via
    -p FILE / -S sample / -H haplotype (PanSN), binary values with
    -B THRESHOLD."""
    from .main import load_any

    g = load_any(args.input, args.device)
    # 4-column BED (the name feeds the output's `name` column)
    rows = []
    with open(args.bed) as f:
        for line in f:
            if line.startswith(("#", "track", "browser")) or not line.strip():
                continue
            parts = line.rstrip("\n").split("\t")
            rows.append(
                (parts[0], int(parts[1]), int(parts[2]),
                 parts[3] if len(parts) > 3 else ".")
            )
    path_groups = None
    if args.path_groups:
        mapping = {}
        with open(args.path_groups) as f:
            for line in f:
                if line.strip():
                    nm, _, grp = line.rstrip("\n").partition("\t")
                    mapping[nm] = grp or nm
        path_groups = [mapping.get(n, n) for n in g.path_names]
    elif args.group_by_sample:
        path_groups = [n.split("#")[0] for n in g.path_names]
    elif args.group_by_haplotype:
        path_groups = ["#".join(n.split("#")[:2]) for n in g.path_names]
    thresh = args.binary_values
    if thresh and not (0 < thresh <= 1):
        print(
            "[odgi::pav] error: the PAV ratio threshold must be greater "
            "than 0 and lower than 1.",
            file=sys.stderr,
        )
        return 1

    def fmt(v):
        if thresh:
            return str(int(v >= thresh))
        return f"{v:.6g}"

    first = True
    for name, s, e, rname in rows:
        p = path_index(g, name)
        cols, tab = pav_table(
            g, p, [(s, e)], group_delim=args.delim,
            path_groups=path_groups,
        )
        if args.matrix_output:
            if first:
                print("chrom\tstart\tend\tname\t" + "\t".join(cols))
                first = False
            print(
                f"{name}\t{s}\t{e}\t{rname}\t"
                + "\t".join(fmt(v) for v in tab[0])
            )
        else:
            if first:
                print("chrom\tstart\tend\tname\tgroup\tpav")
                first = False
            for c, v in zip(cols, tab[0]):
                print(f"{name}\t{s}\t{e}\t{rname}\t{c}\t{fmt(v)}")
    return 0


def cmd_untangle(args):
    from .main import load_any

    g = load_any(args.input, args.device)

    def load_path_list(fname):
        out = []
        with open(fname) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(path_index(g, line))
        return out

    if args.query:
        queries = [path_index(g, q) for q in args.query]
    elif args.query_paths:
        queries = load_path_list(args.query_paths)
    else:
        queries = list(range(g.num_paths))
    if args.target:
        targets = [path_index(g, t) for t in args.target]
    elif args.target_paths:
        targets = load_path_list(args.target_paths)
    else:
        targets = list(range(g.num_paths))
    if args.self_dotplot:

        for q in queries:
            self_dotplot(g, q, sys.stdout)
        return 0
    fmt = "bedpe"
    if args.paf_output:
        fmt = "paf"
    elif args.gene_order:
        fmt = "order"
    elif args.gggenes_output:
        fmt = "gggenes"
    elif args.gggenes_schematic:
        fmt = "schematic"
    untangle(
        g,
        queries,
        targets,
        merge_dist=args.merge_dist,
        max_self_coverage=args.max_self_coverage,
        n_best=args.n_best,
        min_jaccard=args.min_jaccard,
        cut_every=args.cut_every,
        fmt=fmt,
        cut_points_input=args.cut_points_input,
        cut_points_output=args.cut_points_output,
        out=sys.stdout,
    )
    return 0


def cmd_panpos(args):

    with open(args.input, "rb") as f:
        head = f.read(8)
    if head == XPT_MAGIC:
        # .xpt positional index input (role of .xp in the reference,
        # src/subcommand/panpos_main.cpp)
        idx = PathIndex.load(args.input)
        print(idx.get_pangenome_pos(args.path, args.pos))
        return 0
    from .main import load_any

    g = load_any(args.input, args.device)
    print(panpos(g, args.path, args.pos))
    return 0


def cmd_position(args):
    """Full-parity `odgi position` (reference:
    src/subcommand/position_main.cpp; goldens: test/binary/position/* via
    scripts/position.sh).  Lifting between graphs (-x) included."""
    from .main import load_any

    target = load_any(args.input, args.device)
    lifting = bool(args.source)
    source = load_any(args.source, args.device) if lifting else None

    # reference paths (in the target graph)
    ref_paths = []
    if args.ref_path:
        p = path_index_by_name(target, args.ref_path)
        if p is None:
            print(
                f"[odgi::position] error: ref path {args.ref_path} not found in graph",
                file=sys.stderr,
            )
            return 1
        ref_paths.append(p)
    elif args.ref_paths:
        with open(args.ref_paths) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                p = path_index_by_name(target, line)
                if p is None:
                    print(
                        f"[odgi::position] error: ref path {line} not found in graph",
                        file=sys.stderr,
                    )
                    return 1
                ref_paths.append(p)
    else:
        ref_paths = list(range(target.num_paths))

    if ref_paths and args.all_positions:
        print("path\tnode_id\tposition")

        for p in ref_paths:
            lo, hi = int(target.path_offset[p]), int(target.path_offset[p + 1])
            name = target.path_names[p]
            ranks = handle_rank(target.step_handle[lo:hi])
            for r, w in zip(ranks, target.step_pos[lo:hi]):
                sys.stdout.write(f"{name}\t{int(target.node_id[r])}\t{int(w)}\n")

    # subgraph-aware path name map for GFF lifting
    # (position_main.cpp:163-196: 'name:start-end' subgraph paths)
    path_start_end = {}
    if args.gff_input:
        if not os.path.exists(args.gff_input):
            print(
                f'[odgi::position] error: the given file "{args.gff_input}" does '
                "not exist. Please specify an existing GFF/GTF file -E=[FILE], "
                "--gff-input=[FILE].",
                file=sys.stderr,
            )
            return 1
        for p in range(target.num_paths):
            name = target.path_names[p]
            vals = name.split(":")
            if len(vals) > 1:
                s, e = vals[1].split("-")
                path_start_end[vals[0]] = (name, int(s), int(e))
            else:
                path_start_end[name] = (name, 0, int(target.path_length[p]) - 1)

    # lift paths (common to source and target)
    lift_src, lift_tgt = [], []
    if (args.lift_path or args.lift_paths) and not lifting:
        print(
            "[odgi::position] error: lifting requires a separate source and "
            "target graph, specify --source",
            file=sys.stderr,
        )
        return 1
    if lifting:
        names = []
        if args.lift_path:
            names = [args.lift_path]
        elif args.lift_paths:
            with open(args.lift_paths) as f:
                names = [l.rstrip("\n") for l in f if l.rstrip("\n")]
        else:
            names = sorted(set(source.path_names) & set(target.path_names))
        for n in names:
            ps, pt = path_index_by_name(source, n), path_index_by_name(target, n)
            if ps is None or pt is None:
                print(
                    f"[odgi::position] error: lift path {n} not found in both "
                    "source and target graph",
                    file=sys.stderr,
                )
                return 1
            lift_src.append(ps)
            lift_tgt.append(pt)
        if not lift_src:
            print(
                "[odgi::position] error: no lift paths common to both target "
                "and source, cannot proceed",
                file=sys.stderr,
            )
            return 1

    # collect query positions
    graph_positions = []  # (node_id, is_rev, offset)
    path_positions = []  # PathPos against source (if lifting) else target
    path_ranges = []
    in_graph = source if lifting else target

    def add_graph_pos(gr, buffer):
        vals = buffer.split(",")
        nid = int(vals[0])
        if nid not in gr.id_to_rank:
            print(f"[odgi::position] error: no node {nid} in graph", file=sys.stderr)
            sys.exit(1)
        off = 0
        if len(vals) >= 2:
            off = int(vals[1])
            if int(gr.node_len[gr.id_to_rank[nid]]) - 1 < off:
                print(
                    f"[odgi::position] error: offset of {off} lies beyond the "
                    f"end of node {nid}",
                    file=sys.stderr,
                )
                sys.exit(1)
        rev = len(vals) == 3 and vals[2] == "-"
        graph_positions.append((nid, rev, off))

    def add_path_pos(gr, buffer):
        if not buffer:
            return
        vals = buffer.split(",")
        p = path_index_by_name(gr, vals[0])
        if p is None:
            print(
                f"[odgi::position] error: ref path {vals[0]} not found in graph",
                file=sys.stderr,
            )
            sys.exit(1)
        path_positions.append(
            (p, int(vals[1]) if len(vals) > 1 else 0, len(vals) == 3 and vals[2] == "-")
        )

    def add_gff_range(gr, buffer):
        # position_main.cpp:324-416 add_gff_range (1-based GFF adjusted to
        # the (sub)graph range)
        if not buffer or buffer[0] == "#":
            return
        vals = buffer.split("\t")
        name = vals[0]
        if name not in path_start_end:
            print(
                f"[odgi::position] error: GFF/GTF path {name} not found in "
                "path_start_end_pos_map!",
                file=sys.stderr,
            )
            sys.exit(1)
        long_name, gstart, gend = path_start_end[name]
        start = int(vals[3]) if len(vals) > 2 else 0
        end = int(vals[4]) if len(vals) > 3 else int(
            gr.path_length[path_index_by_name(gr, name)]
        )
        if start > end:
            print(
                "[odgi::position::add_gff_range] error: wrong input coordinates "
                f"in row: {buffer}",
                file=sys.stderr,
            )
            sys.exit(1)
        if start >= gend or end <= gstart:
            return
        elif start <= gstart and end <= gend:
            start, end = 0, end - gstart - 1
        elif start >= gstart and end >= gend:
            start, end = start - gstart - 1, gend - gstart - 1
        elif start >= gstart and end <= gend:
            start, end = start - gstart - 1, end - gstart - 1
        elif start <= gstart and end >= gend:
            start, end = 0, gend - gstart
        else:
            return
        if start > end:
            print(
                "[odgi::position::add_gff_range] error: wrong input coordinates "
                f"in row: {buffer}for detected start: {start} and end: {end}",
                file=sys.stderr,
            )
            sys.exit(1)
        p = path_index_by_name(gr, long_name)
        path_ranges.append(
            PathRange(
                p, start, end, len(vals) > 6 and vals[6] == "-", vals[8], vals[8]
            )
        )

    if not args.gff_input:
        if args.graph_pos:
            add_graph_pos(in_graph, args.graph_pos)
        elif args.graph_pos_file:
            with open(args.graph_pos_file) as f:
                for line in f:
                    line = line.rstrip("\n")
                    if line:
                        add_graph_pos(in_graph, line)
        elif args.path_pos:
            add_path_pos(in_graph, args.path_pos)
        elif args.path_pos_file:
            with open(args.path_pos_file) as f:
                for line in f:
                    line = line.rstrip("\n")
                    if line:
                        add_path_pos(in_graph, line)
        elif args.bed_input:
            with open(args.bed_input) as f:
                for line in f:
                    add_bed_range(path_ranges, in_graph, line.rstrip("\n"))
    else:
        with open(args.gff_input) as f:
            for line in f:
                add_gff_range(target, line.rstrip("\n"))

    search_radius = args.search_radius
    walking_dist = args.jaccard_context

    ref_set = set(ref_paths)
    lift_src_set = set(lift_src)

    tgt_ctx = lift.PositionContext(target)
    src_ctx = lift.PositionContext(source) if lifting else None

    def warn_no_hit(query):
        print(
            f"[odgi::position] warning: no reference position found for {query} "
            "(increase -d/--walking-dist?)",
            file=sys.stderr,
        )

    def lift_into_target(pos, step, jaccard):
        """source pos -> target graph pos via lift paths (or identity)."""
        res = lift.LiftResult()
        if lift.get_position(
            src_ctx, lift_src_set, pos, step, jaccard,
            search_radius, walking_dist, res,
        ):
            name = source.path_names[int(source.step_path[res.ref_hit])]
            tp = path_index_by_name(target, name)
            return lift.get_graph_pos(tgt_ctx, tp, res.path_offset)
        return (0, False, 0), -1

    strand = lambda rev: "-" if rev else "+"

    if graph_positions:
        hdr = "#source.graph.pos\ttarget.graph.pos\t" if lifting else "#target.graph.pos\t"
        if args.give_graph_pos:
            hdr += "target.graph.pos"
        elif args.all_immediate:
            hdr += "target.path.pos\tdist.to.ref\tstrand.vs.ref"
        elif args.ref_path or args.ref_paths:
            hdr += "target.path.pos\tdist.to.ref\tstrand.vs.ref"
        else:
            hdr += "target.path.pos\tdist.to.path\tstrand.vs.ref"
        print(hdr)
    for _pos in graph_positions:
        step = -1
        if lifting:
            pos, step = lift_into_target(_pos, -1, False)
        else:
            pos = _pos
        prefix = f"{_pos[0]},{_pos[2]},{strand(_pos[1])}\t" if lifting else ""
        if pos[0] and args.give_graph_pos:
            print(
                f"{prefix}{pos[0]},{pos[2]},{strand(pos[1])}\t"
                f"\t{pos[0]},{pos[2]},{strand(pos[1])}"
            )
            continue
        if args.all_immediate:
            results = lift.get_immediate(tgt_ctx, ref_set, pos)
            if results:
                for res in results:
                    p = int(target.step_path[res.ref_hit])
                    print(
                        f"{prefix}{pos[0]},{pos[2]},{strand(pos[1])}\t"
                        f"{target.path_names[p]},{res.path_offset},+\t"
                        f"{res.walked_to_hit_ref}\t{strand(res.is_rev_vs_ref)}"
                    )
                continue
        res = lift.LiftResult()
        if lift.get_position(
            tgt_ctx, ref_set, pos, step, False, search_radius, walking_dist, res
        ):
            p = int(target.step_path[res.ref_hit])
            print(
                f"{prefix}{pos[0]},{pos[2]},{strand(pos[1])}\t"
                f"{target.path_names[p]},{res.path_offset},+\t"
                f"{res.walked_to_hit_ref}\t{strand(res.is_rev_vs_ref)}"
            )
        else:
            warn_no_hit(f"{_pos[0]},{_pos[2]}")

    for pp, off, prev in path_positions:
        if lifting:
            _pos, step = lift.get_graph_pos(src_ctx, pp, off)
            if _pos[0]:
                pos, step = lift_into_target(_pos, step, True)
            else:
                pos, step = (0, False, 0), -1
            src_name = source.path_names[pp]
        else:
            pos, step = lift.get_graph_pos(tgt_ctx, pp, off)
            src_name = target.path_names[pp]
        hit = False
        if pos[0]:
            if args.give_graph_pos:
                print("#source.path.pos\ttarget.graph.pos")
                print(
                    f"{src_name},{off},{strand(prev)}\t"
                    f"{pos[0]},{pos[2]},{strand(pos[1])}"
                )
                hit = True
            else:
                res = lift.LiftResult()
                if lift.get_position(
                    tgt_ctx, ref_set, pos, step, True,
                    search_radius, walking_dist, res,
                ):
                    p = int(target.step_path[res.ref_hit])
                    print("#source.path.pos\ttarget.path.pos\tdist.to.ref\tstrand.vs.ref")
                    print(
                        f"{src_name},{off},{strand(prev)}\t"
                        f"{target.path_names[p]},{res.path_offset},+\t"
                        f"{res.walked_to_hit_ref}\t{strand(res.is_rev_vs_ref)}"
                    )
                    hit = True
        if not hit:
            warn_no_hit(f"{src_name},{off}")

    node_annotations = {}
    for r in path_ranges:
        if lifting:
            pos_b, step_b = lift.get_graph_pos(src_ctx, r.path, r.start)
            pos_e, step_e = lift.get_graph_pos(src_ctx, r.path, r.end)
            if pos_b[0] and pos_e[0]:
                pos_b, step_b = lift_into_target(pos_b, step_b, True)
                pos_e, step_e = lift_into_target(pos_e, step_e, True)
            else:
                pos_b = pos_e = (0, False, 0)
        elif args.gff_input:
            # collect node -> annotation over the range (inclusive bounds;
            # position_main.cpp:507-544)
            lo, hi = int(target.path_offset[r.path]), int(target.path_offset[r.path + 1])
            offs = target.step_pos[lo:hi]

            ranks = handle_rank(target.step_handle[lo:hi])
            lens = target.node_len[ranks]
            sel = (offs <= r.end) & (offs + lens - 1 >= r.start)
            for rank in ranks[sel]:
                node_annotations.setdefault(int(target.node_id[rank]), set()).add(r.name)
            continue
        else:
            pos_b, step_b = lift.get_graph_pos(tgt_ctx, r.path, r.start)
            pos_e, step_e = lift.get_graph_pos(tgt_ctx, r.path, r.end)
        hit = False
        if pos_b[0] and pos_e[0]:
            if args.give_graph_pos:
                print(
                    f"{r.data}\t{pos_b[0]},{pos_b[2]},{strand(pos_b[1])}\t"
                    f"{pos_e[0]},{pos_e[2]},{strand(pos_e[1])}"
                )
                hit = True
            elif args.all_ref_positions:
                for rp in ref_paths:
                    lb, le = lift.LiftResult(), lift.LiftResult()
                    if lift.get_position(
                        tgt_ctx, {rp}, pos_b, step_b, True,
                        search_radius, walking_dist, lb,
                    ) and lift.get_position(
                        tgt_ctx, {rp}, pos_e, step_e, True,
                        search_radius, walking_dist, le,
                    ):
                        pb = int(target.step_path[lb.ref_hit])
                        pe = int(target.step_path[le.ref_hit])
                        print(
                            f"{r.data}\t{target.path_names[pb]},{lb.path_offset},"
                            f"{strand(lb.is_rev_vs_ref)}\t"
                            f"{target.path_names[pe]},{le.path_offset},"
                            f"{strand(le.is_rev_vs_ref)}\t"
                            f"{strand(lb.is_rev_vs_ref ^ r.is_rev)}"
                        )
                        hit = True
            else:
                lb, le = lift.LiftResult(), lift.LiftResult()
                if lift.get_position(
                    tgt_ctx, ref_set, pos_b, step_b, True,
                    search_radius, walking_dist, lb,
                ) and lift.get_position(
                    tgt_ctx, ref_set, pos_e, step_e, True,
                    search_radius, walking_dist, le,
                ):
                    pb = int(target.step_path[lb.ref_hit])
                    pe = int(target.step_path[le.ref_hit])
                    print(
                        f"{r.data}\t{target.path_names[pb]},{lb.path_offset},"
                        f"{strand(lb.is_rev_vs_ref)}\t"
                        f"{target.path_names[pe]},{le.path_offset},"
                        f"{strand(le.is_rev_vs_ref)}\t"
                        f"{strand(lb.is_rev_vs_ref ^ r.is_rev)}"
                    )
                    hit = True
        if not args.gff_input and not hit:
            warn_no_hit(r.data)

    if args.gff_input:
        print("NODE_ID,ANNOTATION,COLOR")
        items = sorted(node_annotations.items())
        for i, (nid, annos) in enumerate(items):
            anno = ";".join(sorted(annos))
            prev_set = items[i - 1][1] if i > 0 else None
            next_set = items[i + 1][1] if i + 1 < len(items) else None
            show = (
                prev_set != annos
                or i == len(items) - 1
                or (next_set is not None and next_set != annos)
            )
            h = hashlib.sha256(anno.encode()).digest()
            color = (h[24] << 16) | (h[8] << 8) | h[16]
            print(f"{nid},{anno if show else ''},#{color:06x}")
    return 0


def _merge_subpath_gaps(g, mask, max_dist: int, max_iters: int):
    """-d/--max-distance-subpaths: pull unselected nodes into the mask
    when they sit in a gap of < max_dist bp between two selected runs
    of the same path, repeated up to max_iters times (reference:
    extract_main.cpp -d/-e)."""

    for _ in range(max(1, max_iters)):
        changed = False
        ranks = handle_rank(g.step_handle)
        sel = mask[ranks]
        for p in range(g.num_paths):
            lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
            ps = sel[lo:hi]
            if not ps.any() or ps.all():
                continue
            idx = np.nonzero(ps)[0]
            pos = g.step_pos[lo:hi]
            lens = g.node_len[ranks[lo:hi]]
            # gaps between consecutive selected steps
            a, bnd = idx[:-1], idx[1:]
            gap_bp = pos[bnd] - (pos[a] + lens[a])
            for k in np.nonzero((bnd - a > 1) & (gap_bp < max_dist))[0]:
                seg = ranks[lo + a[k] + 1 : lo + bnd[k]]
                if not mask[seg].all():
                    mask[seg] = True
                    changed = True
        if not changed:
            break
    return mask


def _keep_full_path_names(sub):
    """-K: single-fragment subpaths get their original name back
    (multi-fragment paths keep ranged names to stay unique)."""
    bases = []
    for nm in sub.path_names:
        m = re.fullmatch(r"(.*):(\d+)-(\d+)", nm)
        bases.append(m.group(1) if m else nm)
    counts = Counter(bases)
    new = tuple(
        b if counts[b] == 1 else nm
        for nm, b in zip(sub.path_names, bases)
    )
    return dataclasses.replace(sub, path_names=new)


def cmd_extract(args):
    """`odgi extract` handler (reference: src/subcommand/extract_main.cpp):
    node/range/BED/pangenomic-range selection, context expansion in steps
    (-c) or bases (-L), inverse selection (-I), full-range lacing (-E),
    subpath-gap merging (-d/-e), per-range splitting (-s), path
    restriction (-p), full-name retention (-K) and id compaction (-O)."""

    from .main import load_any, _out_graph

    g = load_any(args.input, args.device)
    if args.paths_to_extract:
        with open(args.paths_to_extract) as f:
            wanted = [ln.strip() for ln in f if ln.strip()]
        keep = [i for i, nm in enumerate(g.path_names) if nm in set(wanted)]
        g = g.keep_paths(keep)

    if args.split_subgraphs:
        # one output per target range (reference -s)
        ranges = []
        if args.bed:
            ranges.extend(read_bed(args.bed))
        if args.path_range:
            name, rng = args.path_range.rsplit(":", 1)
            a, bnd = rng.split("-")
            ranges.append((name, int(a), int(bnd)))
        if not ranges:
            print(
                "[odgi::extract] error: -s/--split-subgraphs needs path "
                "ranges (-r and/or -b)",
                file=sys.stderr,
            )
            return 1
        base = args.out[:-3] if args.out.endswith(".og") else args.out
        for name, a, bnd in ranges:
            m = np.zeros(g.num_nodes, dtype=bool)
            p = path_index(g, name)
            m[nodes_in_path_range(g, p, a, bnd)] = True
            if args.max_distance_subpaths:
                m = _merge_subpath_gaps(
                    g, m, args.max_distance_subpaths,
                    args.max_merging_iterations,
                )
            rk = np.nonzero(m)[0]
            sub = extract_nodes(g, rk, args.context_steps, args.context_bases)
            if args.keep_full_path_names:
                sub = _keep_full_path_names(sub)
            if args.optimize:
                sub = sub.optimize()
            _out_graph(sub, f"{base}.{name}:{a}-{bnd}.og")
        return 0

    mask = np.zeros(g.num_nodes, dtype=bool)
    selected = False
    if args.node is not None:
        r = g.id_to_rank.get(args.node)
        if r is None:
            print(f"[odgi::extract] error: no node {args.node}", file=sys.stderr)
            return 1
        mask[r] = True
        selected = True
    if args.node_list:
        with open(args.node_list) as f:
            for line in f:
                line = line.strip()
                if line:
                    r = g.id_to_rank.get(int(line))
                    if r is not None:
                        mask[r] = True
        selected = True
    if args.bed:
        for name, start, end in read_bed(args.bed):
            p = path_index(g, name)
            mask[nodes_in_path_range(g, p, start, end)] = True
        selected = True
    if args.path_range:
        name, rng = args.path_range.rsplit(":", 1)
        start, end = rng.split("-")
        p = path_index(g, name)
        mask[nodes_in_path_range(g, p, int(start), int(end))] = True
        selected = True
    if args.pangenomic_range:
        start, end = (int(v) for v in args.pangenomic_range.split("-"))
        starts = g.node_offset
        ends = starts + g.node_len
        mask[(starts < end) & (ends > start)] = True
        selected = True
    if not selected:
        print(
            "[odgi::extract] error: specify a selection "
            "(-n/-nodes/-r/-b/-q)",
            file=sys.stderr,
        )
        return 1
    if args.inverse:
        mask = ~mask
    ranks = np.nonzero(mask)[0]
    if len(ranks) == 0:
        print("[odgi::extract] error: selection is empty", file=sys.stderr)
        return 1
    if args.full_range:
        ranks = np.arange(int(ranks.min()), int(ranks.max()) + 1)
    if args.max_distance_subpaths:
        mask2 = np.zeros(g.num_nodes, dtype=bool)
        mask2[ranks] = True
        mask2 = _merge_subpath_gaps(
            g, mask2, args.max_distance_subpaths,
            args.max_merging_iterations,
        )
        ranks = np.nonzero(mask2)[0]
    sub = extract_nodes(
        g, ranks, args.context_steps, args.context_bases
    )
    if args.keep_full_path_names:
        sub = _keep_full_path_names(sub)
    if args.drop_pathless:
        used = np.zeros(sub.num_nodes, dtype=bool)
        used[handle_rank(sub.step_handle)] = True
        if used.any() and not used.all():
            sub = extract_nodes(sub, np.nonzero(used)[0], 0, 0)
    if args.optimize:
        sub = sub.optimize()
    _out_graph(sub, args.out)
    return 0


def cmd_overlap(args):
    from .main import load_any

    g = load_any(args.input, args.device)
    rows = []
    if args.bed:
        rows.extend(read_bed(args.bed))
    if args.path:
        p = path_index(g, args.path)
        rows.append((args.path, 0, int(g.path_length[p])))
    if args.paths:
        with open(args.paths) as f:
            for line in f:
                nm = line.strip()
                if nm:
                    p = path_index(g, nm)
                    rows.append((nm, 0, int(g.path_length[p])))
    if not rows:
        print(
            "[odgi_tpu::overlap] error: please specify an input path "
            "(-r/--path), a list of paths (with -R/--paths), or a list "
            "of path ranges (-b/--bed-input).",
            file=sys.stderr,
        )
        return 1
    subset = None
    if args.subset_paths:
        with open(args.subset_paths) as f:
            subset = {ln.strip() for ln in f if ln.strip()}
    print("#path\tstart\tend\tpath.touched")
    ranks_of_path = {}
    for name, s, e in rows:
        p = path_index(g, name)
        sel = nodes_in_path_range(g, p, s, e)
        mask = np.zeros(g.num_nodes, dtype=bool)
        mask[sel] = True
        touched = np.unique(
            g.step_path[mask[handle_rank(g.step_handle)]]
        )
        for t in touched:
            tn = g.path_names[int(t)]
            if subset is not None and tn not in subset:
                continue
            print(f"{name}\t{s}\t{e}\t{tn}")
    return 0


def register(sub):
    """Attach this batch of subcommands to the argparse subparsers."""
    p = sub.add_parser("depth", help="node/path depth")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-s", "--subset-paths")
    p.add_argument("-r", "--path")
    p.add_argument("-R", "--paths")
    p.add_argument("-g", "--graph-pos")
    p.add_argument("-G", "--graph-pos-file")
    p.add_argument("-p", "--path-pos")
    p.add_argument("-F", "--path-pos-file")
    p.add_argument("-b", "--bed-input")
    p.add_argument("-d", "--graph-depth-table", action="store_true")
    p.add_argument("-v", "--graph-depth-vec", action="store_true")
    p.add_argument("-D", "--path-depth", action="store_true")
    p.add_argument("-a", "--self-depth", action="store_true")
    p.add_argument("-S", "--summarize", action="store_true")
    p.add_argument("-w", "--windows-in")
    p.add_argument("-W", "--windows-out")
    p.add_argument("-U", "--window-unique-depth", action="store_true")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-P", "--progress", action="store_true")
    p.set_defaults(fn=cmd_depth)

    p = sub.add_parser("degree", help="node degree")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-s", "--subset-paths")
    p.add_argument("-r", "--path")
    p.add_argument("-R", "--paths")
    p.add_argument("-g", "--graph-pos")
    p.add_argument("-G", "--graph-pos-file")
    p.add_argument("-p", "--path-pos")
    p.add_argument("-F", "--path-pos-file")
    p.add_argument("-b", "--bed-input")
    p.add_argument("-d", "--graph-degree-table", action="store_true")
    p.add_argument("-v", "--graph-degree-vec", action="store_true")
    p.add_argument("-D", "--path-degree", action="store_true")
    p.add_argument("-a", "--self-degree", action="store_true")
    p.add_argument("--in-out-degree", action="store_true")
    p.add_argument(
        "-S", "--summarize-graph-degree", dest="summarize", action="store_true"
    )
    p.add_argument("-w", "--windows-in")
    p.add_argument("-W", "--windows-out")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-P", "--progress", action="store_true")
    p.set_defaults(fn=cmd_degree)

    p = sub.add_parser("viz", help="1D raster PNG")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-x", "--width", type=int, default=1500)
    p.add_argument("-a", "--path-height", dest="path_height",
                   type=int, default=10)
    # reference -y is the TOTAL image height (viz_main.cpp:58); the
    # per-path height is derived from it when given
    p.add_argument("-y", "--height", dest="image_height", type=int,
                   default=None)

    p.add_argument(
        "--color-by", default="path",
        choices=["path", "strand", "depth", "gray", "inversion",
                 "uncalled", "prefix"],
    )
    p.add_argument("-z", "--color-by-mean-inversion-rate",
                   action="store_true")
    p.add_argument("-N", "--color-by-uncalled-bases", action="store_true")
    p.add_argument("-s", "--color-by-prefix", default=None)
    p.add_argument("-c", "--path-colors-file", default=None)
    p.add_argument("-m", "--color-by-mean-depth", action="store_true")
    p.add_argument("-B", "--colorbrewer-palette", default=None)
    p.add_argument("-G", "--no-grey-depth", action="store_true")
    p.add_argument("-R", "--pack-paths", action="store_true")
    p.add_argument("-M", "--prefix-merges", default=None)
    p.add_argument("-I", "--ignore-prefix", default=None)
    p.add_argument("-p", "--path-names-file", default=None)
    p.add_argument("-H", "--hide-path-names", action="store_true")
    p.add_argument("-C", "--color-path-names-background",
                   action="store_true")
    p.add_argument("--max-num-of-characters", type=int, default=32)
    p.add_argument("-n", "--no-path-borders", action="store_true")
    p.add_argument("-b", "--black-path-borders", action="store_true")
    p.add_argument("-d", "--change-darkness", action="store_true")
    p.add_argument("-J", "--highlight-node-ids", default=None)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-P", "--progress", action="store_true")
    p.set_defaults(fn=cmd_viz)

    p = sub.add_parser("draw", help="2D layout PNG/SVG")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-c", "--coords-in", required=True)
    p.add_argument("-p", "--png", default=None)
    p.add_argument("-s", "--svg", default=None)
    p.add_argument("-w", "--width", type=int, default=1000)
    p.add_argument("-C", "--color-by", default="node", choices=["node", "path"])
    p.add_argument("-R", "--scale", type=float, default=0.01)
    p.add_argument("-B", "--border", type=float, default=100.0)
    p.add_argument("--line-width", type=float, default=10.0)
    p.add_argument("-b", "--bed", default=None)
    p.add_argument("--sparsification-factor", type=float, default=0.0)
    p.set_defaults(fn=cmd_draw)

    p = sub.add_parser("chop", help="chop nodes to max length")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-c", "--chop-to", type=int, required=True)
    p.set_defaults(fn=cmd_chop)

    p = sub.add_parser("unchop", help="merge perfect-neighbor chains")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--out", required=True)
    p.set_defaults(fn=cmd_unchop)

    p = sub.add_parser("normalize", help="iterative unchop")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-I", "--max-iterations", type=int, default=10)
    p.set_defaults(fn=cmd_normalize)

    p = sub.add_parser("flip", help="flip paths to dominant strand")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--out", required=True)
    p.set_defaults(fn=cmd_flip)

    p = sub.add_parser("prune", help="remove nodes by degree/coverage")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-d", "--max-degree", type=int, default=0)
    p.add_argument("-c", "--min-depth", type=int, default=0)
    p.add_argument("-T", "--cut-tips", action="store_true")
    p.set_defaults(fn=cmd_prune)

    p = sub.add_parser("explode", help="one file per component")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-p", "--prefix", default="component.")
    p.set_defaults(fn=cmd_explode)

    p = sub.add_parser("squeeze", help="concatenate graphs")
    p.add_argument("-f", "--input-list", nargs="+", required=True)
    p.add_argument("-o", "--out", required=True)
    p.set_defaults(fn=cmd_squeeze)

    p = sub.add_parser("flatten", help="linearize to FASTA + BED")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-f", "--fasta")
    p.add_argument("-b", "--bed")
    p.add_argument("-n", "--name-seq", dest="name", default=None)
    p.set_defaults(fn=cmd_flatten)

    p = sub.add_parser("kmers", help="graph kmer enumeration")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-k", "--kmer-length", type=int, required=True)
    p.add_argument("-e", "--max-furcations", type=int, default=0)
    p.add_argument("-D", "--max-degree", type=int, default=0)
    p.add_argument("-c", "--stdout", action="store_true")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-P", "--progress", action="store_true")
    p.set_defaults(fn=cmd_kmers)

    p = sub.add_parser("matrix", help="sparse adjacency output")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-w", "--weight-by-paths", action="store_true")
    p.set_defaults(fn=cmd_matrix)

    p = sub.add_parser("similarity", help="path x path jaccard")
    p.add_argument("-i", "--input", required=True)
    p.set_defaults(fn=cmd_similarity)

    p = sub.add_parser("tension", help="layout-vs-path tension")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-c", "--coords-in", required=True)
    p.set_defaults(fn=cmd_tension)

    p = sub.add_parser("heaps", help="pangenome growth curves")
    p.add_argument("-i", "--input", "--idx", dest="input", required=True)
    p.add_argument("-n", "--permutations", type=int, default=100)
    p.add_argument("-D", "--delim", default=None)
    p.add_argument("-p", "--path-groups", default=None)
    p.add_argument("-S", "--group-by-sample", action="store_true")
    p.add_argument("-H", "--group-by-haplotype", action="store_true")
    p.add_argument("-b", "--bed-targets", default=None)
    p.add_argument("-d", "--min-node-depth", type=int, default=0)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-P", "--progress", action="store_true")
    p.set_defaults(fn=cmd_heaps)

    p = sub.add_parser("pav", help="presence/absence over BED")
    p.add_argument("-i", "--input", "--idx", dest="input", required=True)
    p.add_argument("-b", "--bed", "--bed-file", dest="bed", required=True)
    p.add_argument("-D", "--delim", default=None)
    p.add_argument("-p", "--path-groups", default=None)
    p.add_argument("-S", "--group-by-sample", action="store_true")
    p.add_argument("-H", "--group-by-haplotype", action="store_true")
    p.add_argument("-B", "--binary-values", type=float, default=0.0)
    p.add_argument("-M", "--matrix-output", action="store_true")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-P", "--progress", action="store_true")
    p.set_defaults(fn=cmd_pav)

    p = sub.add_parser("untangle", help="query-vs-target segmentation")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-q", "--query", action="append", default=None)
    p.add_argument("-r", "--target", action="append", default=None)
    p.add_argument("-Q", "--query-paths")
    p.add_argument("-R", "--target-paths")
    p.add_argument("-m", "--merge-dist", type=int, default=0)
    p.add_argument("-s", "--max-self-coverage", type=float, default=0.0)
    p.add_argument("-n", "--n-best", type=int, default=1)
    p.add_argument("-j", "--min-jaccard", type=float, default=0.0)
    p.add_argument("-e", "--cut-every", type=int, default=0)
    p.add_argument("-p", "--paf-output", action="store_true")
    p.add_argument("-G", "--gene-order", action="store_true")
    p.add_argument("-g", "--gggenes-output", action="store_true")
    p.add_argument("-X", "--gggenes-schematic", action="store_true")
    p.add_argument("-c", "--cut-points-input")
    p.add_argument("-d", "--cut-points-output")
    p.add_argument("-S", "--self-dotplot", action="store_true")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-P", "--progress", action="store_true")
    p.set_defaults(fn=cmd_untangle)

    p = sub.add_parser("panpos", help="pangenome position of path:pos")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-p", "--path", required=True)
    p.add_argument("-v", "--pos", type=int, required=True)
    p.set_defaults(fn=cmd_panpos)

    p = sub.add_parser("position", help="find/translate/liftover positions")
    p.add_argument("-i", "--target", dest="input", required=True)
    p.add_argument("-x", "--source")
    p.add_argument("-r", "--ref-path")
    p.add_argument("-R", "--ref-paths")
    p.add_argument("-l", "--lift-path")
    p.add_argument("-L", "--lift-paths")
    p.add_argument("-g", "--graph-pos")
    p.add_argument("-G", "--graph-pos-file")
    p.add_argument("-p", "--path-pos")
    p.add_argument("-F", "--path-pos-file")
    p.add_argument("-b", "--bed-input")
    p.add_argument("-E", "--gff-input")
    p.add_argument("-v", "--give-graph-pos", action="store_true")
    p.add_argument("-I", "--all-immediate", action="store_true")
    p.add_argument("-d", "--search-radius", type=int, default=10000)
    p.add_argument("-w", "--jaccard-context", type=int, default=10000)
    p.add_argument("--all-positions", action="store_true")
    p.add_argument("--all-ref-positions", action="store_true")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-P", "--progress", action="store_true")
    p.set_defaults(fn=cmd_position)

    p = sub.add_parser("extract", help="extract subgraph")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-r", "--path-range", default=None)
    p.add_argument("-b", "--bed", default=None)
    p.add_argument("-n", "--node", type=int, default=None)
    p.add_argument("-l", "--node-list", default=None)
    p.add_argument("-q", "--pangenomic-range", default=None)
    p.add_argument("-p", "--paths-to-extract", default=None)
    p.add_argument("-I", "--inverse", action="store_true")
    p.add_argument("-E", "--full-range", action="store_true")
    p.add_argument("-c", "--context-steps", type=int, default=0)
    p.add_argument("-L", "--context-bases", type=int, default=0)
    # reference -d is the subpath-gap merge distance
    # (extract_main.cpp); pathless-node dropping stays long-only
    p.add_argument("-d", "--max-distance-subpaths", type=int, default=0)
    p.add_argument("-e", "--max-merging-iterations", type=int, default=3)
    p.add_argument("-s", "--split-subgraphs", action="store_true")
    p.add_argument("-K", "--keep-full-path-names", action="store_true")
    p.add_argument("--drop-pathless", action="store_true")
    p.add_argument("-O", "--optimize", action="store_true")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-P", "--progress", action="store_true")
    p.set_defaults(fn=cmd_extract)

    p = sub.add_parser("overlap", help="paths overlapping BED ranges")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-b", "--bed-input", dest="bed")
    p.add_argument("-r", "--path")
    p.add_argument("-R", "--paths")
    p.add_argument("-s", "--subset-paths")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.set_defaults(fn=cmd_overlap)
