"""A new cell, configuration, traffic mix and per-layer metric are new
files and entries: copied into a temporary tree, the harness picks them up
with no file edited."""

import json
import shutil

from portbench import harness
from portbench.tests.helpers import run_tiny


def test_new_files_are_picked_up(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "portbench")
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    d = tmp_path / "portbench"
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
    sort = harness.load_cell(tmp_path, "locus-90hap.sort-Ygs")["per_layer"]
    assert "jobs_in_window.layout" not in {m["name"] for m in sort}
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data, rel
