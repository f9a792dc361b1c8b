"""The port's depth, degree, viz and draw against odgi_tpu's, on the CPU.

Each command runs through `odgi_tpu.cli.main(argv)` and the port's
`main(argv, device="cpu")` on the same in-repo graphs, and must print the
same stdout and stderr, exit with the same code and write the same bytes:
the PNG files byte for byte against Pillow, the SVG text.  The port draws
without PIL, so its three replacements are held against PIL itself: the
PNG writer against `Image.save`, the segment rasterizer against
`ImageDraw.line`, and the font table against `tools/font_table.py`'s
rebuild of it and against PIL's raster of whole strings."""

import contextlib
import importlib.util
import io
import os
import sys

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image, ImageDraw, ImageFont

from odgi_tpu.algorithms import coverage as j_cov
from odgi_tpu.algorithms import degree as j_deg
from odgi_tpu.algorithms import draw as j_draw
from odgi_tpu.algorithms import viz as j_viz
from odgi_tpu.cli import main as j_cli
from odgi_tpu.core.graph import GraphBuilder
from odgi_tpu.core.graph import GraphTensors as JGraph
from odgi_tpu.io.gfa import write_gfa as j_write_gfa

import odgi_tpu_torch as ot
from odgi_tpu_torch.algorithms import coverage, degree, draw, font, viz
from odgi_tpu_torch.cli import main as t_cli
from odgi_tpu_torch.convert import graph_from_arrays, graph_to_arrays
from odgi_tpu_torch.io import png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROPS = settings(derandomize=True, deadline=None, max_examples=60,
                 suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])


def inv_graph(seed=3, nodes=48, paths=6):
    """A backbone of multi-base nodes (runs of N in some) that every path
    walks, skipping some nodes (bubbles) and, in every other path, running
    nodes 20-26 backwards (an inversion); one path is circular.  Nodes no
    path skips form the perfect chains unchop merges."""
    rng = np.random.default_rng(seed)
    b = GraphBuilder()
    for i in range(1, nodes + 1):
        seq = rng.choice(list(b"ACGT"), size=int(rng.integers(1, 9)))
        if i % 11 == 0:
            seq[: max(1, len(seq) // 2)] = ord("N")
        b.add_node(i, bytes(seq.astype(np.uint8)))
    skippable = set(rng.choice(np.arange(2, nodes), size=nodes // 6, replace=False).tolist())
    for pi in range(paths):
        p = b.add_path(f"{('HG1', 'HG2', 'ref')[pi % 3]}#{pi // 3 + 1}#chr1", circular=pi == 4)
        steps, i = [], 1
        while i <= nodes:
            if i == 20 and pi % 2:
                steps += [(j, True) for j in range(26, 19, -1)]
                i = 27
                continue
            if i in skippable and rng.random() < 0.5:
                i += 1
                continue
            steps.append((i, False))
            i += 1
        prev = None
        for n, rev in steps:
            if prev is not None:
                b.add_edge(prev[0], prev[1], n, rev)
            b.append_step(p, n, rev)
            prev = (n, rev)
    return b.build()


def synth_graph(num_steps=35_064, num_nodes=4_955, path_steps=2_922, seed=11):
    """tools/bigscale_bench.py's generator at DRB1-3123's scale (12 paths,
    35,064 steps over 4,955 1-bp nodes), node ids shuffled."""
    rng = np.random.default_rng(seed)
    P = -(-num_steps // path_steps)
    S = P * path_steps
    adv = num_nodes / path_steps
    steps = int(adv) + (rng.random(S) < adv - int(adv)).astype(np.int64)
    steps = (steps + rng.choice([0, 1, -1], size=S, p=[0.95, 0.025, 0.025])).reshape(P, path_steps)
    steps[:, 0] = 0
    node = np.clip(np.cumsum(steps, axis=1), 0, num_nodes - 1).reshape(-1)
    handle = (node << 1) | rng.integers(0, 2, S)
    keep = (np.arange(1, S) % path_steps) != 0
    a, b = handle[:-1][keep], handle[1:][keep]
    e = np.unique(np.stack([np.minimum(a, b), np.maximum(a, b)], 1), axis=0)
    g = JGraph(node_len=np.ones(num_nodes, np.int64),
               seq_offset=np.arange(num_nodes + 1, dtype=np.int64),
               seq=np.full(num_nodes, ord("A"), np.uint8),
               node_id=np.arange(1, num_nodes + 1, dtype=np.int64),
               edge_from=e[:, 0], edge_to=e[:, 1],
               path_names=tuple(f"HG{i // 2}#{i % 2 + 1}#chr6" for i in range(P)),
               path_circular=np.zeros(P, bool),
               path_offset=np.arange(P + 1, dtype=np.int64) * path_steps,
               step_handle=handle, step_pos=np.tile(np.arange(path_steps, dtype=np.int64), P))
    return g.apply_ordering(np.random.default_rng(5).permutation(num_nodes))


def run(main, argv, **kw):
    """(exit code, stdout, stderr) of one in-process command."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv, **kw)
    return rc, out.getvalue(), err.getvalue()


def run_both(d, argv, outputs=()):
    """Run `argv` through both CLIs in `d`; "{o}" in an argument becomes
    "j" / "t".  Asserts equal exit codes, stdout, stderr and the bytes of
    each file in `outputs`; returns the port's result.  A command that
    exits through SystemExit, or raises KeyError, ValueError or IndexError
    (an unknown path name, a bad range), must do so in both, with the same
    code or message."""
    res = {}
    for tag, main, kw in (("j", j_cli.main, {}), ("t", t_cli.main, {"device": "cpu"})):
        argv_o = [os.path.join(d, a.format(o=tag)) if "{o}" in a else a for a in argv]
        try:
            res[tag] = run(main, argv_o, **kw)
        except SystemExit as exc:
            res[tag] = ("exit", exc.code)
        except (KeyError, ValueError, IndexError) as exc:
            res[tag] = ("raise", type(exc).__name__, str(exc))
    assert res["t"] == res["j"]
    for name in outputs:
        with open(os.path.join(d, name.format(o="j")), "rb") as f:
            want = f.read()
        with open(os.path.join(d, name.format(o="t")), "rb") as f:
            assert f.read() == want, name
    return res["t"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """name -> the graph (odgi_tpu's), its .og and .otg (the tests read the
    .otg: a .og read takes seconds at DRB1 scale) and the side files the flags
    name: a .lay of random coordinates, BED ranges, position lists, path
    subsets, viz colors, prefix merges, path names and node ids."""
    d = str(tmp_path_factory.mktemp("render"))
    out = {}
    for name, gj in (("inv", inv_graph()), ("drb1", synth_graph())):
        f = lambda s: os.path.join(d, f"{name}.{s}")
        gfa = f("gfa")
        j_write_gfa(gj, gfa)
        for ext in ("og", "otg"):
            assert run(j_cli.main, ["build", "-g", gfa, "-o", f(ext)])[0] == 0
        rng = np.random.default_rng(len(name))
        names, ids = list(gj.path_names), gj.node_id
        lens = gj.path_length
        ot.save_layout(rng.normal(0, 100, (2 * gj.num_nodes, 2)), f("lay"), device="cpu")
        files = dict(
            BED=[f"{names[p]}\t{int(lens[p]) // 4}\t{int(lens[p]) // 2}\tr{p}\t0\t{'+-'[p % 2]}"
                 for p in range(0, len(names), 2)] + [f"{names[1]}\t0\t{int(lens[1])}"],
            SUBSET=names[::2],
            GPOSF=[f"{int(ids[r])},0,+" for r in range(0, gj.num_nodes, 7)],
            PPOSF=[f"{names[p]},{int(lens[p]) // 3},{'+-'[p % 2]}" for p in range(len(names))]
            + [f"{names[0]},{int(lens[0]) + 5}"],
            PATHS=[names[0], f"{names[1]}\t1\t{int(lens[1]) - 1}"],
            COLORS=[f"{names[0]}\t#10e0a0", f"{names[1]}\t200,30,40", "# a comment"],
            MERGES=["HG1", "HG2"] if name == "inv" else ["HG1#", "HG3"],
            NAMES=names[1::2],
            NODES=[str(int(i)) for i in ids[::5]] + ["999999"],
            BEDRGB=[f"{names[0]}\t2\t{int(lens[0]) // 2}\tgeneA\t0\t+\t0\t0\t255,0,0",
                    f"{names[1]}\t0\t{int(lens[1]) // 3}\tgeneB", "nope\t0\t3\tx"],
        )
        paths = dict(dir=d, og=f("og"), otg=f("otg"), lay=f("lay"), LAY=f("lay"), PATH=names[1],
                     GPOS=f"{int(ids[3])},0,-", PPOS=f"{names[2]},{int(lens[2]) // 2}")
        for key, lines in files.items():
            paths[key] = f(key.lower())
            with open(paths[key], "w") as fh:
                fh.writelines(line + "\n" for line in lines)
        out[name] = dict(paths=paths, g=gj)
    return out


def argv_of(p, words):
    return [p.get(w, w) if w.isupper() else w for w in words]


GRAPHS = ["inv", "drb1"]
DEPTH_FLAGS = [
    [], ["-d"], ["-v"], ["-D"], ["-a"], ["-S"], ["-s", "SUBSET"], ["-s", "SUBSET", "-d"],
    ["-s", "SUBSET", "-D"], ["-s", "SUBSET", "-a"], ["-s", "SUBSET", "-S"],
    ["-w", "3:1:3:0"], ["-W", "5:2:10:1"], ["-w", "0:2:4", "-U"], ["-W", "2:1:2", "-U", "-s", "SUBSET"],
    ["-w", "1:1:1:0", "-W", "1:1:1:0"], ["-w", "1:3:2:0"], ["-w", "x"],
    ["-b", "BED"], ["-r", "PATH"], ["-R", "PATHS"], ["-g", "GPOS"], ["-G", "GPOSF"],
    ["-p", "PPOS"], ["-F", "PPOSF"], ["-g", "999999"], ["-p", "nope,3"], ["-s", "NODES"],
    ["-S", "-t", "4", "-P"],
]
DEGREE_FLAGS = [f for f in DEPTH_FLAGS if "-U" not in f] + [
    ["-d", "--in-out-degree"], ["-g", "GPOS", "--in-out-degree"], ["-S", "-w", "1:1:1:0"],
]


def words_id(f):
    return "_".join(f).replace("-", "").replace(":", "") or "none"


@pytest.mark.parametrize("flags", DEPTH_FLAGS, ids=words_id)
@pytest.mark.parametrize("name", GRAPHS)
def test_depth(inputs, name, flags):
    p = inputs[name]["paths"]
    run_both(p["dir"], ["depth", "-i", p["otg"]] + argv_of(p, flags))


@pytest.mark.parametrize("flags", DEGREE_FLAGS, ids=words_id)
@pytest.mark.parametrize("name", GRAPHS)
def test_degree(inputs, name, flags):
    p = inputs[name]["paths"]
    run_both(p["dir"], ["degree", "-i", p["otg"]] + argv_of(p, flags))


VIZ_FLAGS = [
    [], ["-z"], ["-N"], ["-s", "#"], ["-c", "COLORS"], ["-m"], ["-m", "-B", "Spectral:5"],
    ["-m", "-B", "Set1:4", "-G"], ["-R"], ["-M", "MERGES"], ["-I", "HG2"], ["-p", "NAMES"],
    ["-H"], ["-C"], ["-n"], ["-b"], ["-d"], ["-J", "NODES"], ["-y", "200"],
    ["--color-by", "strand"], ["--color-by", "gray"], ["--color-by", "depth"],
    ["-x", "333", "-a", "4"], ["-a", "25", "--max-num-of-characters", "5"],
    ["-z", "-d", "-C", "-b", "-s", "#"], ["-N", "-R", "-H", "-n"], ["-m", "-M", "MERGES", "-y", "61"],
]


# every flag on the small graph; on the DRB1-scale one each colour mode
VIZ_CASES = [("inv", f) for f in VIZ_FLAGS] + [
    ("drb1", f) for f in VIZ_FLAGS if f[:1] in ([], ["-z"], ["-N"], ["-s"], ["-m"], ["-R"], ["-d"])]


@pytest.mark.parametrize("name,flags", VIZ_CASES, ids=lambda v: words_id(v) if isinstance(v, list) else v)
def test_viz(inputs, name, flags):
    p = inputs[name]["paths"]
    run_both(p["dir"], ["viz", "-i", p["otg"], "-o", "{o}_viz.png"] + argv_of(p, flags),
             outputs=["{o}_viz.png"])


DRAW_FLAGS = [
    ["-p", "{o}_d.png"], ["-s", "{o}_d.svg"], ["-p", "{o}_d.png", "-C", "path"],
    ["-s", "{o}_d.svg", "-b", "BEDRGB"], ["-p", "{o}_d.png", "-s", "{o}_d.svg", "-w", "300"],
    ["-s", "{o}_d.svg", "-R", "0.5", "-B", "10", "--line-width", "3",
     "--sparsification-factor", "0.3"], ["-p", "{o}_d.png", "-w", "64", "-C", "path"], [],
]


@pytest.mark.parametrize("flags", DRAW_FLAGS, ids=lambda f: words_id(f).replace("{o}_", ""))
@pytest.mark.parametrize("name", GRAPHS)
def test_draw(inputs, name, flags):
    p = inputs[name]["paths"]
    run_both(p["dir"], ["draw", "-i", p["otg"], "-c", p["lay"]] + argv_of(p, flags),
             outputs=[f for f in flags if "{o}" in f])


@pytest.mark.parametrize("argv", [["depth", "-d"], ["degree", "-S"], ["viz", "-o", "{o}_og.png"],
                                  ["draw", "-c", "LAY", "-s", "{o}_og.svg"]], ids=lambda a: a[0])
def test_og_input(inputs, argv):
    """The reference's .og as the input."""
    p = inputs["inv"]["paths"]
    run_both(p["dir"], [argv[0], "-i", p["og"]] + argv_of(p, argv[1:]),
             outputs=[a for a in argv if "{o}" in a])


# ---------------------------------------------------------------------------
# The modules, array for array
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=GRAPHS)
def pair(request, inputs):
    gj = inputs[request.param]["g"]
    return gj, graph_from_arrays(graph_to_arrays(gj))


def test_depth_and_degree_arrays(pair):
    gj, gt = pair
    sub = list(range(0, gj.num_paths, 2))
    mask = np.zeros(gj.num_paths, bool)
    mask[sub] = True
    for a, b in [(j_cov.node_depth(gj), coverage.node_depth(gt)),
                 (j_cov.node_depth(gj, sub), coverage.node_depth(gt, sub)),
                 (j_cov.node_depth_unique(gj, sub), coverage.node_depth_unique(gt, sub)),
                 (j_deg.effective_degree(gj, mask), degree.effective_degree(gt, mask)),
                 (j_deg.node_self_step_count(gj), degree.node_self_step_count(gt)),
                 (j_deg.node_unique_path_count(gj, mask), degree.node_unique_path_count(gt, mask))]:
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(), dict(color_by="depth", colorbrewer_scheme="RdBu:7"),
                                dict(pack_paths=True, color_by="inversion"),
                                dict(merge_prefixes=["HG"], color_path_names_background=True)],
                         ids=["path", "depth", "pack", "merge"])
def test_render_viz_arrays(pair, kw):
    gj, gt = pair
    bj, bt = j_viz.bin_paths(gj, 700), viz.bin_paths(gt, 700)
    for f in ("mean_depth", "mean_inv", "mean_pos", "mean_uncalled", "first_bin", "last_bin"):
        assert np.array_equal(getattr(bj, f), getattr(bt, f)), f
    assert np.array_equal(j_viz.render_viz(gj, width=700, **kw), viz.render_viz(gt, width=700, **kw))


# ---------------------------------------------------------------------------
# What replaces PIL, against PIL
# ---------------------------------------------------------------------------


def pil_png(img):
    buf = io.BytesIO()
    Image.fromarray(img, "RGB").save(buf, format="PNG")
    return buf.getvalue()


@st.composite
def images(draw_, max_side=24):
    """Small images of few values (rows whose filters tie) or noise."""
    h = draw_(st.integers(1, max_side))
    w = draw_(st.integers(1, max_side))
    seed = draw_(st.integers(0, 2**32 - 1))
    levels = draw_(st.sampled_from([2, 3, 256]))
    rng = np.random.default_rng(seed)
    img = (rng.integers(0, levels, (h, w, 3)) * (255 // (levels - 1))).astype(np.uint8)
    if draw_(st.booleans()):
        img = np.cumsum(img, axis=draw_(st.integers(0, 1)), dtype=np.uint8)
    return img


@PROPS
@given(images())
def test_png_equals_pillow(img):
    data = png.encode(img)
    assert data == pil_png(img)
    assert np.array_equal(png.decode(data), img)


@pytest.mark.parametrize("shape", [(300, 300), (40, 2000), (12, 17000), (420, 1500)])
def test_png_equals_pillow_across_idat_chunks(shape):
    """Noise images whose deflate stream spans several IDAT chunks, and
    widths whose rows pass Pillow's 65,536-byte block (4 * width)."""
    rng = np.random.default_rng(shape[1])
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    img[::5] = 255
    data = png.encode(img)
    assert data.count(b"IDAT") > 1
    assert data == pil_png(img)
    assert np.array_equal(png.decode(data), img)


segment = st.tuples(*[st.floats(-20, 140, allow_nan=False, width=32)] * 4)


@PROPS
@given(st.lists(segment, min_size=1, max_size=40), st.booleans())
def test_raster_equals_imagedraw(segs, halves):
    """Segments in index order through ImageDraw.line(width=1), colored by
    their index, against raster_segments' owner of each pixel."""
    seg = np.asarray(segs, dtype=np.float64)
    if halves:
        seg = np.round(seg * 2) / 2
    W, H = 97, 61
    im = Image.new("RGB", (W, H), (0, 0, 0))
    d = ImageDraw.Draw(im)
    for i, s in enumerate(seg):
        d.line(tuple(s), fill=(1 + (i & 0x7F), (i >> 7) & 0xFF, 9), width=1)
    got = draw.raster_segments(seg[:, 0], seg[:, 1], seg[:, 2], seg[:, 3], W, H)
    a = np.asarray(im).astype(np.int64)
    want = np.where(a[..., 2] == 9, (a[..., 0] - 1) + (a[..., 1] << 7), -1)
    assert np.array_equal(got, want)


coord = st.floats(-20, 140, allow_nan=False, width=32)


@st.composite
def wide_segment(draw_):
    """One segment of a kind a wide line treats apart: any, horizontal,
    vertical, steep, drawn right to left, zero-length, or reaching far off
    the image."""
    kind = draw_(st.sampled_from(["any", "horizontal", "vertical", "steep", "reversed",
                                  "zero", "off"]))
    x0, y0 = draw_(coord), draw_(coord)
    if kind == "horizontal":
        return x0, y0, draw_(coord), y0 + draw_(st.floats(-0.875, 0.875, width=32))
    if kind == "vertical":
        return x0, y0, x0 + draw_(st.floats(-0.875, 0.875, width=32)), draw_(coord)
    if kind == "steep":
        return x0, y0, x0 + draw_(st.floats(-4, 4, width=32)), draw_(coord)
    if kind == "reversed":
        return x0, y0, x0 - draw_(st.floats(0, 120, width=32)), draw_(coord)
    if kind == "zero":
        return x0, y0, x0, y0
    far = st.floats(-400, 500, allow_nan=False, width=32)
    return x0, y0, draw_(far), draw_(far)


@pytest.mark.parametrize("w", range(2, 9))
@PROPS
@given(segs=st.lists(wide_segment(), min_size=1, max_size=25))
def test_wide_raster_equals_imagedraw(w, segs):
    """Wide segments in index order through ImageDraw.line(width=w), colored
    by their index, against raster_segments' owner of each pixel."""
    seg = np.asarray(segs, dtype=np.float64)
    W, H = 97, 61
    im = Image.new("RGB", (W, H), (0, 0, 0))
    d = ImageDraw.Draw(im)
    for i, s in enumerate(seg):
        d.line(tuple(s), fill=(1 + (i & 0x7F), (i >> 7) & 0xFF, 9), width=w)
    got = draw.raster_segments(seg[:, 0], seg[:, 1], seg[:, 2], seg[:, 3], W, H, w)
    a = np.asarray(im).astype(np.int64)
    want = np.where(a[..., 2] == 9, (a[..., 0] - 1) + (a[..., 1] << 7), -1)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("color_by", ["node", "path"])
@pytest.mark.parametrize("line_width", [2, 3, 6])
def test_draw_png_wide_equals_odgi_tpu(inputs, pair, line_width, color_by, tmp_path):
    """draw_png(line_width > 1) pixel for pixel and byte for byte against
    odgi_tpu's PIL picture, on the .lay the draw commands read."""
    gj, gt = pair
    name = "inv" if gj.num_nodes == inputs["inv"]["g"].num_nodes else "drb1"
    coords = ot.load_layout(inputs[name]["paths"]["lay"])
    j_path, t_path = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    j_draw.draw_png(gj, coords, j_path, width=400, line_width=line_width, color_by=color_by)
    draw.draw_png(gt, coords, t_path, width=400, line_width=line_width, color_by=color_by)
    want = np.asarray(Image.open(j_path).convert("RGB"))
    got = png.read(t_path)
    assert np.array_equal(got, want)
    assert got.shape[1] == 400 and (got != 255).any()
    with open(j_path, "rb") as f, open(t_path, "rb") as g:
        assert g.read() == f.read()


def load_font_tool():
    spec = importlib.util.spec_from_file_location("font_table", os.path.join(REPO, "tools", "font_table.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_font_table_rebuilds_from_pil():
    """tools/font_table.py rebuilds the vendored table from PIL exactly, its
    source equal to font.py's block; characters outside it draw as the
    missing box."""
    tool = load_font_tool()
    table, missing = tool.build_table()
    assert sorted(table) == sorted(font.GLYPHS)
    for cp, (raster, adv) in table.items():
        assert font.glyph(chr(cp))[0] == adv
        assert np.array_equal(font.glyph(chr(cp))[1], raster), hex(cp)
    assert font.MISSING == (missing[1], tool.encode(missing[0]))
    with open(os.path.join(REPO, "odgi_tpu_torch", "algorithms", "font.py")) as f:
        assert tool.source(table, missing) in f.read()
    pil = ImageFont.load_default()
    for ch in "\x01\x7f\xe9中\U0001f600":
        assert tool.glyph(pil, ch)[1] == missing[1]
        assert np.array_equal(tool.glyph(pil, ch)[0], missing[0])


ALPHABET = "".join(chr(c) for c in range(32, 127)) + "\xa9…ﬁ\xe9中\x01"


def pil_text(text):
    tmp = Image.new("L", (8 * max(len(text), 1) + 4, 16), 0)
    ImageDraw.Draw(tmp).text((0, 0), text, fill=255, font=ImageFont.load_default())
    return np.asarray(tmp) > 0


@PROPS
@given(st.text(alphabet=ALPHABET, max_size=40))
def test_text_raster_equals_pil(text):
    assert np.array_equal(font.text_raster(text), pil_text(text))
    assert np.array_equal(viz._text_mask(text, 8), j_viz._text_mask(text, 8))


def test_text_raster_wide_glyphs_clip():
    for text in ("W" * 40, "@" * 33, "", " ", "jjj", "HG00438#1#JAHBCB010000001.1"):
        assert np.array_equal(font.text_raster(text), pil_text(text))


def test_modules_import_without_pil():
    """viz, draw, the PNG writer and the command line import and render
    with PIL blocked."""
    import subprocess

    code = (
        "import sys\n"
        "sys.modules['PIL'] = None\n"
        "import numpy as np\n"
        "from odgi_tpu_torch.cli import main\n"
        "from odgi_tpu_torch.algorithms import viz, draw\n"
        "from odgi_tpu_torch.io import png\n"
        "assert png.encode(np.zeros((2, 3, 3), np.uint8)).startswith(png.SIGNATURE)\n"
        "assert viz._text_mask('HG1#1', 8).any()\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
