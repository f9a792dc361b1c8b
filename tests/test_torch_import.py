"""odgi_tpu_torch stands alone: it imports neither JAX nor odgi_tpu, nor
PIL (its pictures are written by io/png.py and algorithms/font.py)."""

import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "odgi_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_every_module_imports_with_jax_and_odgi_tpu_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['odgi_tpu'] = None\n"
        "sys.modules['PIL'] = None\n"
        "import odgi_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(odgi_tpu_torch.__path__, "
        "'odgi_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'jax' not in sys.modules or sys.modules['jax'] is None\n"
        "print(len(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_odgi_tpu_import(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "odgi_tpu", "PIL"), f"{path}: imports {name}"


def test_parallel_imports_neither_jax_nor_odgi_tpu():
    """What a spawned rank of the sharded run imports (its worker's module)
    pulls in neither jax nor odgi_tpu."""
    code = (
        "import sys\n"
        "from odgi_tpu_torch.parallel.sharded_strata import run_rank\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'odgi_tpu'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_sampler_rank_imports_neither_jax_nor_odgi_tpu():
    """The same for the batched sampler's worker (parallel/sharded.py)."""
    code = (
        "import sys\n"
        "from odgi_tpu_torch.parallel.sharded import run_rank\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'odgi_tpu'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


NEW_HOST_MODULES = ["core.index", "algorithms.position", "algorithms.liftover",
                    "algorithms.path_jaccard", "algorithms.untangle", "algorithms.extract",
                    "algorithms.analytics", "algorithms.tips", "algorithms.bin_cmd",
                    "algorithms.paths_cmd", "cli.commands2", "cli.commands3"]


def test_position_and_analytics_modules_import_neither_jax_nor_odgi_tpu():
    """The positions, indexes and analytics (and the handlers that reach
    them, which `server` runs in its own process) pull in neither jax,
    odgi_tpu nor PIL."""
    code = (
        "import sys, importlib\n"
        f"for m in {NEW_HOST_MODULES!r}:\n"
        "    importlib.import_module('odgi_tpu_torch.' + m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'odgi_tpu', 'PIL'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
