"""A new cell, configuration, graph source, traffic mix, job kind and
per-layer metric are new files and entries: copied into a temporary tree,
the harness picks them up with no file edited.  A name with no file stops
the run with the path it looked for, and every graph a cell or a source
makes passes the one check of a graph's fields."""

import json
import shutil

import numpy as np
import pytest

from portbench import graphgen, graphs, harness, jobs
from portbench.tests.helpers import SEED, TINY, run_tiny

KIND = '''"""A layout job whose input is a file that prepare writes, as a command
line's input is."""
import numpy as np

from portbench.jobs import LayoutJob


class JOB(LayoutJob):
    def __init__(self, traffic):
        super().__init__(traffic)
        self.log, self.workdir = traffic["log"], None

    def _say(self, line):
        with open(self.log, "a") as fh:
            fh.write(line + "\\n")

    def prepare(self, g, workdir):
        from odgi_tpu_torch.convert import graph_to_arrays

        self.workdir = workdir
        np.savez(workdir / "x.npz", **graph_to_arrays(g))
        self._say(f"prepare {workdir}")

    def run(self, g, seed, device):
        from odgi_tpu_torch.convert import graph_from_arrays

        with np.load(self.workdir / "x.npz") as z:
            f = {k: z[k] for k in z.files}
        self._say(f"run {len(f['step_handle'])}")
        return super().run(graph_from_arrays(f), seed, device)
'''

RING = '''"""H haplotypes around a ring of N 1-bp nodes: each starts at a node drawn
from the seed and walks forward all the way round, back to its start."""
import numpy as np

TINY = dict(haplotypes=4, nodes=400)


def graph_arrays(config, seed):
    H, N = int(config["haplotypes"]), int(config["nodes"])
    start = np.random.default_rng(seed).integers(0, N, H)
    node = ((start[:, None] + np.arange(N + 1)) % N).reshape(-1)
    ring = np.arange(N, dtype=np.int64)
    return dict(
        node_len=np.ones(N, np.int64), seq_offset=np.arange(N + 1, dtype=np.int64),
        seq=np.full(N, ord("C"), np.uint8), node_id=ring + 1,
        edge_from=ring << 1, edge_to=((ring + 1) % N) << 1,
        path_names=tuple(f"r{i}" for i in range(H)), path_circular=np.zeros(H, bool),
        path_offset=np.arange(H + 1, dtype=np.int64) * (N + 1),
        step_handle=node.astype(np.int64) << 1,
        step_pos=np.tile(np.arange(N + 1, dtype=np.int64), H))
'''


def _tree(tmp_path):
    """The benchmark copied under `tmp_path`: (its directory, BENCHMARK.json
    as a dict, every copied file's bytes)."""
    shutil.copytree(harness.HERE, tmp_path / "portbench")
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    return tmp_path / "portbench", bench, before


def _unchanged(tmp_path, before):
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data, rel


def test_new_files_are_picked_up(tmp_path):
    d, bench, before = _tree(tmp_path)
    (d / "configs" / "tiny-bubble.json").write_text(json.dumps(
        dict(name="tiny-bubble", haplotypes=3, nodes=800)))
    (d / "traffic" / "layout-again.json").write_text(json.dumps({"job": "layout"}))
    (d / "limits" / "tiny-bubble.layout-again.json").write_text(
        json.dumps({"coord_gap": {"limit": 1e-9}}))
    (d / "metrics" / "jobs_in_window.py").write_text(
        "SPANS = {'init_layout': 'odgi_tpu_torch.algorithms.layout:init_layout'}\n"
        "def read(run):\n"
        "    return float(len(run.spans.per_job(run.jobs, 'init_layout')))\n")
    bench["configs"].append(dict(name="tiny-bubble", source="https://example.org/tiny",
                                 file="portbench/configs/tiny-bubble.json", reduced=[],
                                 why="test"))
    bench["workloads"].append(dict(name="tiny-bubble.layout-again", config="tiny-bubble",
                                   traffic="layout-again", chips=1, why="test"))
    bench["end_to_end"][0]["workloads"].append("tiny-bubble.layout-again")
    # No "workloads" key: reported in every cell that reports layout_s.
    # Its dotted name is read by the reader of its base name.
    bench["per_layer"].append(dict(name="jobs_in_window.layout", unit="jobs", better="higher",
                                   source="program_span", layer="test", moves="layout_s"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cfg = json.loads((d / "configs" / "tiny-bubble.json").read_text())
    res, _, _ = run_tiny("tiny-bubble.layout-again", False, root=tmp_path, config=cfg)
    assert res["correct"] and set(res["metrics"]) == {"layout_s", "setup_s"}
    res, _, _ = run_tiny("tiny-bubble.layout-again", True, root=tmp_path, config=cfg)
    assert res["metrics"]["jobs_in_window.layout"]["value"] >= 1
    for cell in ("tiny-bubble.layout-again", "chrom-90hap.layout"):
        names = {m["name"] for m in harness.load_cell(tmp_path, cell)["per_layer"]}
        assert "jobs_in_window.layout" in names
    sort = harness.load_cell(tmp_path, "chrom-90hap.sort-Ygs")["per_layer"]
    assert "jobs_in_window.layout" not in {m["name"] for m in sort}
    _unchanged(tmp_path, before)


def test_new_kind_and_graph_source_are_picked_up(tmp_path):
    d, bench, before = _tree(tmp_path)
    log = tmp_path / "events.log"
    (d / "kinds").mkdir(exist_ok=True)
    (d / "kinds" / "layout-prepared.py").write_text(KIND)
    (d / "graphs" / "ring.py").write_text(RING)
    # The "tiny" keys are laid over the file's: the graph source stays.
    (d / "configs" / "tiny-ring.json").write_text(json.dumps(
        dict(name="tiny-ring", graph="ring", haplotypes=90, nodes=100000,
             tiny=dict(haplotypes=4, nodes=400))))
    (d / "traffic" / "layout-prepared.json").write_text(json.dumps(
        {"job": "layout-prepared", "init_mode": "d", "log": str(log)}))
    (d / "limits" / "tiny-ring.layout-prepared.json").write_text(
        json.dumps({"coord_gap": {"limit": 1e-9}}))
    bench["configs"].append(dict(name="tiny-ring", source="https://example.org/ring",
                                 file="portbench/configs/tiny-ring.json", reduced=[],
                                 why="test"))
    bench["workloads"].append(dict(name="tiny-ring.layout-prepared", config="tiny-ring",
                                   traffic="layout-prepared", chips=1, why="test"))
    bench["end_to_end"][0]["workloads"].append("tiny-ring.layout-prepared")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    res, _, _ = run_tiny("tiny-ring.layout-prepared", False, root=tmp_path)
    assert res["correct"] and set(res["metrics"]) == {"layout_s", "setup_s"}
    events = log.read_text().splitlines()
    # prepare once, before the warm-up job; every job read the prepared
    # file of the ring's 4 x 401 steps (past 1,024: the strata path, which
    # the reference follows); the directory gone after the check
    assert events[0].startswith("prepare ") and len(events) >= 3
    assert events[1:] == ["run 1604"] * (len(events) - 1)
    assert not (tmp_path / events[0].split(" ", 1)[1]).exists()
    f = harness.graph_fields(dict(graph="ring", haplotypes=4, nodes=400), SEED, d / "graphs")
    graphs.check_fields(f)
    assert len(f["step_handle"]) == 1604
    _unchanged(tmp_path, before)


def test_unknown_kind_or_graph_names_its_file(tmp_path):
    with pytest.raises(SystemExit, match=r"kinds/no-such-kind\.py is missing"):
        jobs.make({"job": "no-such-kind"})
    with pytest.raises(SystemExit, match=r"graphs/no-such-graph\.py is missing"):
        harness.graph_fields(dict(graph="no-such-graph", haplotypes=2, nodes=10), 1)
    assert type(jobs.make({"job": "layout", "init_mode": "d"})) is jobs.LayoutJob
    assert type(jobs.make({"job": "sort", "pipeline": "Ygs"})) is jobs.SortJob


@pytest.mark.parametrize("cell", sorted(TINY))
def test_tiny_graph_is_laid_over_its_configuration(cell):
    """A cell's tiny keys over its file make a sound graph; the built-in
    cells' files hold graphgen's defaults besides, so theirs is graphgen's
    graph of the tiny keys alone."""
    c = harness.load_cell(harness.ROOT, cell)
    f = harness.graph_fields({**c["config"], **TINY[cell]}, SEED)
    graphs.check_fields(f)
    if "graph" not in c["config"]:
        ref = graphgen.graph_arrays(TINY[cell], SEED)
        assert f.keys() == ref.keys()
        for k in ref:
            assert np.array_equal(np.asarray(f[k]), np.asarray(ref[k])), k


SOURCES = sorted(p.stem for p in (harness.HERE / "graphs").glob("[!_]*.py"))


@pytest.mark.parametrize("source", SOURCES)
def test_every_graph_source_gives_sound_fields(source):
    tiny = harness.load_file(harness.HERE / "graphs" / f"{source}.py", "graph source").TINY
    a = harness.graph_fields(dict(tiny, graph=source), SEED)
    graphs.check_fields(a)
    b = harness.graph_fields(dict(tiny, graph=source), SEED)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def _handle_out_of_range(f):
    f["step_handle"][7] = 2 * len(f["node_len"])


def _step_pos_broken(f):
    f["step_pos"][f["path_offset"][1] + 3] += 1


def _edge_twice(f):
    f["edge_from"][1], f["edge_to"][1] = f["edge_from"][0], f["edge_to"][0]


def _edge_end_out_of_range(f):
    f["edge_to"][2] = -1


@pytest.mark.parametrize("fault", [_handle_out_of_range, _step_pos_broken, _edge_twice,
                                   _edge_end_out_of_range])
def test_check_fields_refuses_a_broken_graph(fault):
    f = graphgen.graph_arrays(dict(haplotypes=3, nodes=200), 5)
    graphs.check_fields(f)
    f = {k: v.copy() if isinstance(v, np.ndarray) else v for k, v in f.items()}
    fault(f)
    with pytest.raises(ValueError):
        graphs.check_fields(f)
