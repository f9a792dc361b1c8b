"""Every cell runs end to end on the CPU at a tiny size, through the
program's plain paths, and prints a last line that parses."""

import json

import pytest

from portbench import harness
from portbench.tests.helpers import TINY, run_tiny

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_on_the_cpu(cell, trace):
    res, out, err = run_tiny(cell, trace)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0
    c = harness.load_cell(harness.ROOT, cell)
    names = {m["name"] for m in (c["per_layer"] if trace else c["end_to_end"])}
    if trace:
        # on the CPU only the span readers find something to read
        assert set(res["metrics"]) <= names and res["metrics"]
    else:
        assert set(res["metrics"]) == names
    for check, v in res["checks"].items():
        assert f"check {check} {v['value']!r} limit {v['limit']!r}" in err.splitlines()[-len(res["checks"]):]


def test_every_cell_has_its_files():
    for w in BENCH["workloads"]:
        c = harness.load_cell(harness.ROOT, w["name"])
        assert c["limits"] and c["traffic"]["job"]
        for m in c["per_layer"]:
            assert harness.load_reader(c["metric_dir"], m["name"]).read
    assert sorted(TINY) == sorted(w["name"] for w in BENCH["workloads"])


def test_each_per_layer_metric_lists_the_cells_of_what_it_moves():
    e2e = {m["name"]: set(m.get("workloads", [w["name"] for w in BENCH["workloads"]]))
           for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= e2e[m["moves"]]


def test_job_seeds_differ_and_repeat():
    a = [harness.job_seed(2**40 + 3, k) for k in range(50)]
    assert len(set(a)) == 50 and a == [harness.job_seed(2**40 + 3, k) for k in range(50)]
    assert all(0 < s < 2**31 for s in a)
