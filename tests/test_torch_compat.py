"""The port's ``import odgi`` / ``import odgi_ffi`` surface
(``odgi_tpu_torch.compat``) against odgi_tpu's, on the CPU.

Each scenario is written once, as a function of the package's ``odgi``
module, and run on both; every return value (handles, step handles,
edges, sequences, counts), every iteration order and every raised error
goes into a transcript, and the two transcripts must be equal.  So must
the ``serialize`` bytes and the ``to_gfa`` text.  The scenarios are the
conformance cases of tests/test_handle_conformance.py (the ten-node graph,
divide / combine, orientation, paths) written again to compare the two
packages, scripted sessions on in-repo graphs, and hypothesis sequences of
mutations.  Then every one of the 48 ``odgi_ffi`` functions."""

import contextlib
import io
import os

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from odgi_tpu.compat import odgi as j_odgi
from odgi_tpu.compat import odgi_ffi as j_ffi
from odgi_tpu.io.gfa import write_gfa as j_write_gfa
from odgi_tpu.io.og import save_graph as j_save_graph
from odgi_tpu.io.og_compat import save_og as j_save_og

from odgi_tpu_torch import version as t_version
from odgi_tpu_torch.compat import odgi as t_odgi
from odgi_tpu_torch.compat import odgi_ffi as t_ffi
from odgi_tpu_torch.convert import graph_to_arrays

from test_torch_render import inv_graph, synth_graph

MODS = {"j": j_odgi, "t": t_odgi}
KW = {"j": {}, "t": {"device": "cpu"}}
PROPS = settings(derandomize=True, deadline=None, max_examples=60,
                 suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])


def norm(v):
    """A value as plain data, step handles and edges included, with its type."""
    if isinstance(v, (j_odgi.step_handle, t_odgi.step_handle)):
        return ("step", v.path_idx, v.rank, v._kind)
    if isinstance(v, (j_odgi.edge, t_odgi.edge)):
        return ("edge", v.first(), v.second())
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, [norm(x) for x in v])
    if isinstance(v, dict):
        return ("dict", [(norm(k), norm(x)) for k, x in v.items()])
    return (type(v).__name__, v)


class Log:
    """A transcript: `rec` notes a value and returns it; `call` notes a
    call's value or the error it raised."""

    def __init__(self):
        self.items = []

    def rec(self, v):
        self.items.append(norm(v))
        return v

    def call(self, fn, *args):
        try:
            return self.rec(fn(*args))
        except (KeyError, ValueError, IndexError, TypeError, AssertionError) as exc:
            self.items.append(("raise", type(exc).__name__, str(exc)))
            return None


def transcripts(scenario, *args):
    out = {}
    for tag, mod in MODS.items():
        log = Log()
        scenario(mod, log, *args)
        out[tag] = log.items
    assert out["t"] == out["j"]
    assert out["t"], "an empty transcript compares nothing"
    return out["t"]


def to_gfa_text(g) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        g.to_gfa()
    return buf.getvalue()


def handles_of(g):
    out = []
    g.for_each_handle(lambda h: out.append(h))
    return out


def snapshot(g, log: Log) -> None:
    """Everything the public API says about the graph, in iteration order."""
    log.rec([g.get_node_count(), g.min_node_id(), g.max_node_id(), g.get_path_count()])
    for h in handles_of(g):
        for x in (h, g.flip(h)):
            log.rec([x, g.get_id(x), g.get_is_reverse(x), g.forward(x), g.get_sequence(x),
                     g.get_length(x), g.get_degree(x, False), g.get_degree(x, True),
                     g.get_step_count(x)])
            for left in (False, True):
                seen = []
                log.rec(g.follow_edges(x, left, lambda y: seen.append(y)))
                log.rec(seen)
            log.rec(g.steps_of_handle(x, True))
    edges = []
    g.for_each_edge(lambda e: edges.append(e))
    log.rec(edges)
    paths = []
    g.for_each_path_handle(lambda p: paths.append(p))
    for p in paths:
        log.rec([g.get_path_name(p), g.get_is_circular(p), g.is_empty(p),
                 g.get_step_count_of_path(p), g.has_path(g.get_path_name(p))])
        steps = []
        g.for_each_step_in_path(p, lambda s: steps.append(s))
        for s in steps:
            log.rec([s, g.get_handle_of_step(s), g.get_path(s), g.has_next_step(s),
                     g.has_previous_step(s), g.get_next_step(s), g.get_previous_step(s),
                     g.get_ordinal_rank_of_step(s), s.path_id(), s.is_reverse(),
                     s.prev_id(), s.prev_rank(), s.next_id(), s.next_rank()])
        if steps:
            log.rec([g.path_begin(p), g.path_back(p), g.path_end(p), g.path_front_end(p),
                     g.is_path_end(g.path_end(p)), g.is_path_front_end(g.path_front_end(p))])


def finish(g, log: Log, tmp: str, tag: str) -> None:
    """The snapshot, the GFA text and the serialized bytes."""
    snapshot(g, log)
    log.call(to_gfa_text, g)
    path = os.path.join(tmp, f"{tag}.og")
    if log.call(g.serialize, path) is None and os.path.exists(path):
        with open(path, "rb") as f:
            log.rec(f.read())
        os.remove(path)


# ---------------------------------------------------------------------------
# The conformance scenarios (tests/test_handle_conformance.py), on both
# ---------------------------------------------------------------------------

SEQS = ["CGA", "TTGG", "CCGT", "C", "GT", "GATAA", "CGG", "ACA", "GCCG", "ATATAAC"]


def ten_node(mod, log):
    g = mod.graph()
    n = [log.rec(g.create_handle(s)) for s in SEQS]
    g.create_edge(g.flip(n[1]), g.flip(n[0]))
    for a, b in [(1, 2), (2, 3), (2, 4), (3, 5), (4, 5), (5, 6),
                 (5, 8), (6, 7), (6, 8), (7, 9), (8, 9)]:
        g.create_edge(n[a], n[b])
    return g, n


def scen_ten_node(mod, log, tmp):
    g, n = ten_node(mod, log)
    for a in n + [g.flip(h) for h in n]:
        for b in n + [g.flip(h) for h in n]:
            if log.rec(g.has_edge(a, b)):
                log.rec(g.edge_handle(a, b))
    # iteratees that stop early
    seen = []
    log.rec(g.for_each_handle(lambda h: seen.append(h) or len(seen) < 3))
    log.rec(seen)
    seen = []
    log.rec(g.follow_edges(n[5], False, lambda h: seen.append(h) or False))
    log.rec(seen)
    seen = []
    log.rec(g.for_each_edge(lambda e: seen.append(e) or len(seen) < 4))
    log.rec(seen)
    log.rec([g.has_node(i) for i in range(0, 13)])
    log.call(g.create_handle, "A", 3)   # an id in use
    log.rec(g.create_handle("GGGG", 40))
    log.rec(g.create_handle("T"))        # the next id after 40
    finish(g, log, tmp, "ten")


def pathy(mod, log):
    g, n = ten_node(mod, log)
    p1 = g.create_path_handle("path1")
    for i in (0, 1, 2, 3, 5, 6, 7, 9):
        log.rec(g.append_step(p1, n[i]))
    p2 = g.create_path_handle("path2", True)
    for i in (9, 8, 6, 5, 4, 2):
        log.rec(g.append_step(p2, g.flip(n[i])))
    p3 = g.create_path_handle("empty")
    return g, n, (p1, p2, p3)


def scen_paths(mod, log, tmp):
    g, n, (p1, p2, p3) = pathy(mod, log)
    log.call(g.create_path_handle, "path1")
    log.rec([g.get_path_handle("path2"), g.has_path("nope")])
    for p in (p1, p2):
        s = g.path_begin(p)
        walk = []
        for _ in range(12):   # past the end on the circular path
            walk.append(s)
            if not g.has_next_step(s):
                break
            s = g.get_next_step(s)
        log.rec(walk)
        s = g.path_back(p)
        for _ in range(3):
            s = log.rec(g.get_previous_step(s))
    log.rec(g.get_next_step(g.path_back(p1)))
    log.rec(g.get_previous_step(g.path_begin(p1)))
    for h in n:
        log.rec(g.steps_of_handle(h))
        log.rec(g.steps_of_handle(g.flip(h), True))
        seen = []
        log.rec(g.for_each_step_on_handle(h, lambda s: seen.append(s)))
        log.rec(seen)
    snapshot(g, log)
    # the path rewrites
    log.rec(g.prepend_step(p3, n[4]))
    log.rec(g.insert_step(g.path_begin(p3), g.flip(n[7])))
    log.rec(g.set_step(g.path_begin(p3), n[8]))
    log.rec(g.rewrite_segment(g.get_next_step(g.path_begin(p1)),
                              g.get_next_step(g.get_next_step(g.get_next_step(g.path_begin(p1)))),
                              [n[4], g.flip(n[3])]))
    g.set_circularity(p1, True)
    snapshot(g, log)
    g.destroy_path(p2)
    log.rec([g.get_path_count(), g.get_path_handle("empty")])
    finish(g, log, tmp, "paths")
    g.clear_paths()
    snapshot(g, log)
    g.clear()
    snapshot(g, log)


def scen_divide(mod, log, tmp):
    g = mod.graph()
    h = g.create_handle("GATTACA")
    before, after = g.create_handle("TTT"), g.create_handle("CCC")
    g.create_edge(before, h)
    g.create_edge(h, after)
    g.create_edge(g.flip(h), before)        # a reversing edge into the start
    p = g.create_path_handle("p")
    for x in (before, h, after):
        g.append_step(p, x)
    q = g.create_path_handle("q")
    for x in (g.flip(after), g.flip(h)):
        g.append_step(q, x)
    parts = log.rec(g.divide_handle(h, [2, 5]))
    snapshot(g, log)
    log.rec(g.divide_handle(g.flip(parts[2]), 1))
    snapshot(g, log)
    r = g.create_handle("GATTACA")
    log.rec(g.divide_handle(g.flip(r), [1, 3]))
    finish(g, log, tmp, "divide")


def scen_combine(mod, log, tmp):
    g = mod.graph()
    h = g.create_handle("GATTACA")
    left, right = g.create_handle("AC"), g.create_handle("GG")
    g.create_edge(left, h)
    g.create_edge(h, right)
    p = g.create_path_handle("p")
    for x in (left, h, right):
        g.append_step(p, x)
    q = g.create_path_handle("q")
    for x in (g.flip(right), g.flip(h), g.flip(left)):
        g.append_step(q, x)
    parts = log.rec(g.divide_handle(h, [3]))
    snapshot(g, log)
    log.rec(g.combine_handles(parts))
    snapshot(g, log)
    log.rec(g.combine_handles([left] + handles_of(g)[-1:]))
    finish(g, log, tmp, "combine")


def scen_orientation(mod, log, tmp):
    g, n, (p1, p2, _) = pathy(mod, log)
    for i in (2, 5, 9):
        log.rec(g.apply_orientation(g.flip(n[i])))
        snapshot(g, log)
    log.rec(g.apply_orientation(n[3]))     # forward: unchanged
    finish(g, log, tmp, "orient")


def scen_destroy(mod, log, tmp):
    g, n, _ = pathy(mod, log)
    g.destroy_edge(n[5], n[6])
    g.destroy_edge(n[0], n[0])              # absent: no error
    g.destroy_handle(n[8])
    snapshot(g, log)
    log.call(g.get_sequence, n[8])
    finish(g, log, tmp, "destroy")


def scen_ordering(mod, log, tmp):
    g, n, _ = pathy(mod, log)
    order = [n[i] for i in (3, 1, 9, 0, 2, 8, 7, 4, 6, 5)]
    g.apply_ordering(order)
    snapshot(g, log)
    g.create_handle("AAAA", 30)
    g.optimize()
    finish(g, log, tmp, "order")


SCENARIOS = [scen_ten_node, scen_paths, scen_divide, scen_combine, scen_orientation,
             scen_destroy, scen_ordering]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[5:])
def test_conformance_scenarios(scenario, tmp_path):
    transcripts(scenario, str(tmp_path))


def test_public_surface_equal():
    """The same public methods on both graph classes and step handles, and
    the same 48 odgi_ffi functions."""
    for a, b in ((j_odgi.graph, t_odgi.graph), (j_odgi.step_handle, t_odgi.step_handle),
                 (j_odgi.edge, t_odgi.edge)):
        assert ({n for n in dir(b) if not n.startswith("_")}
                == {n for n in dir(a) if not n.startswith("_")})
    assert sorted(t_ffi.__all__) == sorted(j_ffi.__all__) and len(t_ffi.__all__) == 48


# ---------------------------------------------------------------------------
# Scripted sessions on loaded graphs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def graph_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("compat")
    out = {}
    for name, gj in (("inv", inv_graph(nodes=30, paths=4)), ("drb1_cut", synth_graph(3_000, 400, 600))):
        for ext, save in (("gfa", j_write_gfa), ("og", j_save_og), ("otg", j_save_graph)):
            save(gj, str(d / f"{name}.{ext}"))
            out[f"{name}.{ext}"] = str(d / f"{name}.{ext}")
    out["dir"] = str(d)
    return out


def load(mod, path):
    tag = "t" if mod is t_odgi else "j"
    g = mod.graph(**KW[tag])
    g.load(path)
    return g


@pytest.mark.parametrize("src", ["inv.gfa", "inv.og", "inv.otg", "drb1_cut.otg"])
def test_loaded_session(graph_files, src, tmp_path):
    """load, iterate, mutate (create_handle, create_edge, divide_handle,
    combine_handles, apply_orientation, rewrite_segment, destroy_*),
    serialize and to_gfa; the frozen graphs field for field."""

    def session(mod, log, tmp):
        g = load(mod, graph_files[src])
        log.rec(sorted(vars(g.freeze()).keys()))
        hs = handles_of(g)
        log.rec(hs[:50])
        new = log.rec(g.create_handle("ACGTTGCA"))
        g.create_edge(hs[0], new)
        g.create_edge(new, g.flip(hs[1]))
        log.rec(g.divide_handle(new, [3, 5]))
        long = [h for h in handles_of(g) if g.get_length(h) > 1][:3]
        for h in long:
            log.rec(g.divide_handle(g.flip(h), 1))
        p = g.get_path_handle(g.get_path_name(0))
        s0 = g.path_begin(p)
        s1 = g.get_next_step(g.get_next_step(s0))
        log.rec(g.combine_handles([g.get_handle_of_step(s0), g.get_handle_of_step(g.get_next_step(s0))]))
        log.rec(g.apply_orientation(g.flip(hs[4])))
        log.rec(g.rewrite_segment(g.path_begin(p), s1, [hs[2], g.flip(hs[3])]))
        g.destroy_edge(hs[5], hs[6])
        g.destroy_handle(hs[7])
        g.destroy_path(g.get_path_count() - 1)
        finish(g, log, tmp, "session")
        log.call(lambda: {k: v.tolist() if isinstance(v, np.ndarray) else v
                          for k, v in graph_to_arrays(g.freeze()).items()})

    transcripts(session, str(tmp_path))


def test_load_takes_the_device_rule(graph_files):
    """graph() loads on the card by default: without one it raises, as
    every entry point of the port does; device="cpu" loads on the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_odgi.graph().load(graph_files["inv.otg"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_ffi.odgi_load_graph(graph_files["inv.otg"])
    g = t_odgi.graph(device="cpu")
    g.load(graph_files["inv.gfa"])
    assert g.get_node_count() == 30


# ---------------------------------------------------------------------------
# Hypothesis: sequences of mutations
# ---------------------------------------------------------------------------

OPS = ("create_handle", "create_edge", "destroy_edge", "destroy_handle", "create_path",
       "append_step", "prepend_step", "insert_step", "set_step", "rewrite_segment",
       "divide_handle", "combine_handles", "apply_orientation", "apply_ordering",
       "optimize", "set_circularity", "destroy_path", "clear_paths")

op_seq = st.lists(st.tuples(st.sampled_from(OPS), st.lists(st.integers(0, 2**16), min_size=4,
                                                           max_size=4)),
                  min_size=1, max_size=25)


def play(mod, log, ops, tmp):
    """Run `ops` on a small seeded graph; each op picks its arguments from
    the graph's state by its four integers."""
    g = mod.graph()
    for i, s in enumerate(["ACG", "T", "GGAT", "CC", "A"]):
        g.create_handle(s)
    g.create_edge(g.get_handle(1), g.get_handle(2))
    g.create_edge(g.get_handle(2), g.get_handle(3, True))
    p = g.create_path_handle("x")
    g.append_step(p, g.get_handle(1))
    g.append_step(p, g.get_handle(2))
    for name, (a, b, c, d) in ops:
        hs = handles_of(g)
        paths = []
        g.for_each_path_handle(lambda q: paths.append(q))
        pick = lambda k: (hs[k % len(hs)] | (k >> 8 & 1)) if hs else 0  # noqa: E731
        path = paths[a % len(paths)] if paths else None
        steps = []
        if path is not None:
            g.for_each_step_in_path(path, lambda s: steps.append(s))
        step = steps[b % len(steps)] if steps else None
        log.rec(name)
        if name == "create_handle":
            seq = "".join("ACGT"[(a >> (2 * k)) & 3] for k in range(1 + b % 6))
            log.call(g.create_handle, seq, *([c % 12 + 1] if d % 3 == 0 else []))
        elif name in ("create_edge", "destroy_edge") and hs:
            log.call(getattr(g, name), pick(a), pick(b))
        elif name in ("destroy_handle", "apply_orientation") and hs:
            log.call(getattr(g, name), pick(a))
        elif name == "create_path":
            log.call(g.create_path_handle, f"p{b % 4}", bool(c & 1))
        elif name in ("append_step", "prepend_step") and path is not None and hs:
            log.call(getattr(g, name), path, pick(c))
        elif name in ("insert_step", "set_step") and step is not None and hs:
            log.call(getattr(g, name), step, pick(c))
        elif name == "rewrite_segment" and step is not None:
            end = steps[min(len(steps) - 1, b % len(steps) + c % 3)]
            log.call(g.rewrite_segment, step, end, [pick(d), pick(d >> 4)][: 1 + a % 2] if hs else [])
        elif name == "divide_handle" and hs:
            h = pick(a)
            n = g.get_length(h)
            if n > 1:
                cuts = sorted({1 + b % (n - 1), 1 + c % (n - 1)})[: 1 + d % 2]
                log.call(g.divide_handle, h, cuts)
        elif name == "combine_handles" and len(steps) > 1:
            k = b % (len(steps) - 1)
            log.call(g.combine_handles, [g.get_handle_of_step(s) for s in steps[k:k + 2]])
        elif name == "apply_ordering" and hs:
            order = [hs[i] for i in np.random.default_rng(a).permutation(len(hs))]
            log.call(g.apply_ordering, order)
        elif name == "optimize":
            log.call(g.optimize)
        elif name == "set_circularity" and path is not None:
            log.call(g.set_circularity, path, bool(b & 1))
        elif name == "destroy_path" and path is not None:
            log.call(g.destroy_path, path)
        elif name == "clear_paths":
            log.call(g.clear_paths)
        log.call(snapshot, g, log)
    log.call(finish, g, log, tmp, "ops")


@PROPS
@given(op_seq)
def test_mutation_sequences(tmp_path_factory, ops):
    transcripts(play, ops, str(tmp_path_factory.mktemp("ops")))


# ---------------------------------------------------------------------------
# odgi_ffi: all 48 functions
# ---------------------------------------------------------------------------


def ffi_walk(ffi, log, path, kw):
    """Every odgi_ffi function on a loaded graph, in the order of the
    reference's test/python/odgi_ffi.md walkthrough, then the rest."""
    log.rec([ffi.odgi_long_long_size(), ffi.odgi_handle_i_size(), ffi.odgi_step_handle_i_size()])
    g = ffi.odgi_load_graph(path, **kw)
    log.rec([ffi.odgi_get_node_count(g), ffi.odgi_max_node_id(g), ffi.odgi_min_node_id(g),
             ffi.odgi_get_path_count(g)])
    paths = []
    ffi.odgi_for_each_path_handle(g, lambda p: paths.append(p))
    log.rec(paths)
    hs = []
    log.rec(ffi.odgi_for_each_handle(g, lambda h: hs.append(h)))
    log.rec(hs)
    for h in hs[:40]:
        for x in (h, h ^ 1):
            log.rec([ffi.odgi_has_node(g, ffi.odgi_get_id(g, x)), ffi.odgi_get_sequence(g, x),
                     ffi.odgi_get_id(g, x), ffi.odgi_get_is_reverse(g, x),
                     ffi.odgi_get_length(g, x), ffi.odgi_get_step_count(g, x)])
            for left in (False, True):
                seen = []
                log.rec(ffi.odgi_follow_edges(g, x, left, lambda y: seen.append(y)))
                log.rec(seen)
                for y in seen:
                    log.rec(ffi.odgi_has_edge(g, x, y) if not left else ffi.odgi_has_edge(g, y, x))
            seen = []
            log.rec(ffi.odgi_for_each_step_on_handle(g, x, lambda s: seen.append(s)))
            log.rec(seen)
    e = g.edge_handle(hs[0], hs[1])
    log.rec([ffi.odgi_edge_first_handle(g, e), ffi.odgi_edge_second_handle(g, e)])
    for p in paths:
        name = ffi.odgi_get_path_name(g, p)
        log.rec([name, ffi.odgi_has_path(g, name), ffi.odgi_path_is_empty(g, p),
                 ffi.odgi_get_path_handle(g, name)])
        b, back = ffi.odgi_path_begin(g, p), ffi.odgi_path_back(g, p)
        end, front = ffi.odgi_path_end(g, p), ffi.odgi_path_front_end(g, p)
        log.rec([b, back, end, front, ffi.odgi_is_path_end(g, end),
                 ffi.odgi_is_path_front_end(g, front), ffi.odgi_is_path_end(g, b),
                 ffi.odgi_step_eq(g, b, ffi.odgi_path_begin(g, p)), ffi.odgi_step_eq(g, b, back)])
        steps = []
        ffi.odgi_for_each_step_in_path(g, p, lambda s: steps.append(s))
        for s in steps[:60]:
            log.rec([ffi.odgi_get_handle_of_step(g, s), ffi.odgi_get_path(g, s),
                     ffi.odgi_get_path_handle_of_step(g, s), ffi.odgi_step_path_id(g, s),
                     ffi.odgi_step_is_reverse(g, s), ffi.odgi_step_prev_id(g, s),
                     ffi.odgi_step_prev_rank(g, s), ffi.odgi_step_next_id(g, s),
                     ffi.odgi_step_next_rank(g, s), ffi.odgi_has_next_step(g, s),
                     ffi.odgi_has_previous_step(g, s), ffi.odgi_get_next_step(g, s),
                     ffi.odgi_get_previous_step(g, s)])
    ffi.odgi_free_graph(g)
    log.rec(ffi.odgi_get_node_count(g))


@pytest.mark.parametrize("src", ["inv.og", "inv.gfa", "drb1_cut.otg"])
def test_ffi_walkthrough(graph_files, src):
    out = {}
    for tag, ffi in (("j", j_ffi), ("t", t_ffi)):
        log = Log()
        ffi_walk(ffi, log, graph_files[src], KW[tag])
        out[tag] = log.items
    assert out["t"] == out["j"] and len(out["t"]) > 100


def test_ffi_covers_every_function(graph_files):
    """ffi_walk calls each of the 48 functions."""
    called = set()

    class Spy:
        def __getattr__(self, name):
            called.add(name)
            return getattr(t_ffi, name)

    ffi_walk(Spy(), Log(), graph_files["inv.og"], KW["t"])
    assert called == set(t_ffi.__all__) - {"odgi_version"}


def test_ffi_version_is_the_ports():
    assert t_ffi.odgi_version() == t_version.get_version()
    assert t_ffi.odgi_version() != j_ffi.odgi_version()
