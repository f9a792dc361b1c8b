"""What the benchmark loads: no module of JAX or of the JAX package in a run,
and nothing of the program in the reference, the generator and the graph
sources (``graphs/``).  Top-level names are compared whole: odgi_tpu_torch
begins with odgi_tpu."""

import json
import subprocess
import sys

from portbench import harness

RUN = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.tests.helpers import run_tiny
res, _, _ = run_tiny({cell!r}, {trace})
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import graphgen, graphs, harness, plan, reference, count
f = graphgen.graph_arrays(dict(haplotypes=6, nodes=1000), 3)
reference.layout(f, 5, "cpu")
reference.sort_ygs(f, 5, "cpu")
for p in sorted((harness.HERE / "graphs").glob("[!_]*.py")):
    tiny = harness.load_file(p, "graph source").TINY
    graphs.check_fields(harness.graph_fields(dict(tiny, graph=p.stem), 3))
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=1800, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    for cell, trace in (("chrom-90hap.sort-Ygs", True), ("chrom-90hap.layout", False)):
        mods = _modules(RUN.format(root=str(harness.ROOT), cell=cell, trace=trace))
        assert "odgi_tpu_torch" in mods
        assert not mods & set(harness.FORBIDDEN), mods & set(harness.FORBIDDEN)


def test_reference_and_generator_load_nothing_of_the_program():
    mods = _modules(REFERENCE.format(root=str(harness.ROOT)))
    assert "portbench" in mods
    assert "odgi_tpu_torch" not in mods and not mods & set(harness.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "odgi_tpu_torch_x", sys)
    assert "odgi_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "odgi_tpu.core", sys)
    assert "odgi_tpu" in harness.forbidden_modules()
