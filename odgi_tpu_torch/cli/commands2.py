"""The subcommands of ``odgi_tpu/cli/commands2.py`` that the port has:
depth, degree, viz, draw (the pictures and the numbers beside them) and
chop, unchop, normalize, flip, prune, explode, squeeze, flatten (graph
edits), with ``odgi_tpu.cli``'s flags, output and written bytes.  Host
code; pictures are written without PIL (``io/png.py``, ``algorithms/font.py``).
"""

from __future__ import annotations

import io as _io
import sys
from contextlib import nullcontext

import numpy as np

from ..algorithms import coverage as cov
from ..algorithms import degree as degalg
from ..algorithms.chop import chop
from ..algorithms.draw import bed_node_colors, draw_png, draw_svg
from ..algorithms.paths_cmd import flatten
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
from ..algorithms.viz import render_viz
from ..core.graph import handle_rank
from ..io import png
from ..io.lay import load_layout
from .region import (
    add_bed_range,
    fmt_double,
    get_graph_pos_of_path_pos,
    load_subset_paths,
    parse_graph_pos,
    parse_path_pos,
    parse_windows_spec,
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
