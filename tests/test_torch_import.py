"""odgi_tpu_torch stands alone: it imports neither JAX nor odgi_tpu, nor
PIL (its pictures are written by io/png.py and algorithms/font.py).  It has
a counterpart of every module and public name of odgi_tpu, and
ops/kernels.py binds every C entry of its CUDA sources, each with the
parameter types the source declares."""

import ast
import ctypes
import pathlib
import re
import subprocess
import sys

import pytest

from odgi_tpu_torch.ops import kernels

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


# ---------------------------------------------------------------------------
# Completeness: every module and public name of odgi_tpu has a counterpart
# ---------------------------------------------------------------------------

JAX_PKG, PORT = REPO / "odgi_tpu", REPO / "odgi_tpu_torch"

# odgi_tpu module or module:name -> what stands for it in the port: a file
# ("csrc/x.cu", "ops/x.py") or a name in a module ("ops/x.py:name")
COUNTERPARTS = {
    "ops/pallas_sgd.py": ("ops/strata_sgd.py:path_sgd_1d_strata", "ops/strata_sgd.py:path_sgd_2d_strata",
                          "ops/strata_plan.py", "ops/strata_levels.py", "ops/kernels.py",
                          "csrc/strata_sgd.cu", "csrc/strata_levels.cu"),
    "ops/pallas_sgd_xl.py": ("csrc/strata_levels.cu", "ops/strata_route.py"),
    "ops/pallas_sgd_xxl.py": ("ops/strata_xxl.py:build_schedule", "csrc/strata_blocked.cu"),
    "parallel/sharded_pallas.py": ("parallel/sharded_strata.py:path_sgd_2d_strata_sharded",),
    "ops/sgd.py:SgdData": ("ops/batched_sgd.py:SgdData",),
    "ops/sgd.py:sgd_1d_run": ("ops/batched_sgd.py:sgd_run",),
    "ops/sgd.py:sgd_2d_run": ("ops/batched_sgd.py:sgd_run",),
    "ops/sgd.py:sgd_1d_iteration": ("ops/batched_sgd.py:sgd_iteration",),
    "ops/sgd.py:sgd_2d_iteration": ("ops/batched_sgd.py:sgd_iteration",),
    "ops/scatter.py:scatter_mean_apply": ("ops/scatter.py:mean_apply",),
    "ops/scatter.py:LANE": ("ops/strata_plan.py:LANE",),
    "cli/commands3.py:cmd_version": ("cli/main.py:cmd_version",),
}

# odgi_tpu module, module:name or module:Class.member -> why the port has
# no counterpart
NO_COUNTERPART = {
    "utils/env.py": "JAX's persistent compilation cache; the port builds its kernels once "
                    "into odgi_tpu_torch/_build/ (ops/kernels.py)",
    "ops/scatter.py:factored_gather": "a one-hot matmul gather for the TPU's MXU; on the card "
                                      "a gather is plain indexing, table[idx]",
    "ops/sgd.py:SgdConfig.mxu_coords": "the TPU's one-hot matmul form of the coordinate "
                                       "scatter and gather; the card indexes directly",
    "ops/sgd.py:SgdConfig.mxu_tables": "the same for the step-table gather",
    "ops/sgd.py:SgdConfig.pallas": "odgi_tpu's switch off its Pallas kernels; each port run "
                                   "takes the route odgi_tpu takes with them on",
    "ops/sgd.py:SgdConfig.rng_impl": "jax.random's generator; the batched path draws from "
                                     "a torch.Generator (ops/batched_sgd.py)",
}


def public_names(path: pathlib.Path) -> set:
    """Top-level functions, classes and assigned names not starting with
    "_" (and, in a package's __init__.py, the names it imports)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out.update(n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name))
        elif path.name == "__init__.py" and isinstance(node, ast.ImportFrom):
            out.update(a.asname or a.name for a in node.names)
    return {n for n in out if not n.startswith("_")}


def public_members(path: pathlib.Path) -> set:
    """"Class.member" for the public methods and class-level fields of each
    public top-level class."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for cls in tree.body:
        if not isinstance(cls, ast.ClassDef) or cls.name.startswith("_"):
            continue
        for node in cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names = [node.name]
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                names = [t.id for t in targets if isinstance(t, ast.Name)]
            else:
                continue
            out.update(f"{cls.name}.{n}" for n in names if not n.startswith("_"))
    return out


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def target_exists(target: str) -> bool:
    path, _, name = target.partition(":")
    f = PORT / path
    return f.is_file() and (not name or name in public_names(f))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_port_has_every_module_and_name(module):
    """The port's module of the same path holds every public name of
    odgi_tpu's, and each of its classes every public method and field of
    odgi_tpu's class, or the table names what stands for it, or why
    nothing does."""
    if module in COUNTERPARTS or module in NO_COUNTERPART:
        return
    ours = PORT / module
    assert ours.is_file(), f"odgi_tpu/{module} has no counterpart in the port"
    listed = lambda n: f"{module}:{n}" in COUNTERPARTS or f"{module}:{n}" in NO_COUNTERPART  # noqa: E731
    missing = [n for n in sorted(public_names(JAX_PKG / module) - public_names(ours))
               if not listed(n)]
    missing += [m for m in sorted(public_members(JAX_PKG / module) - public_members(ours))
                if not listed(m) and not listed(m.split(".")[0])]
    assert not missing, f"odgi_tpu/{module}: {missing} have no counterpart in the port"


@pytest.mark.parametrize("key", sorted(COUNTERPARTS) + sorted(NO_COUNTERPART))
def test_completeness_table_is_current(key):
    """Each entry names something odgi_tpu has and the port lacks under the
    same name, and each counterpart it names exists."""
    module, _, name = key.partition(":")
    assert (JAX_PKG / module).is_file()
    if name:
        names = public_members if "." in name else public_names
        assert name in names(JAX_PKG / module)
        assert name not in names(PORT / module) if (PORT / module).is_file() else True
    else:
        assert not (PORT / module).is_file()
    for target in COUNTERPARTS.get(key, ()):
        assert target_exists(target), f"{key} -> {target}"
    assert COUNTERPARTS.get(key) or NO_COUNTERPART.get(key)


# ---------------------------------------------------------------------------
# The CUDA sources' C entries against ops/kernels.py's binding tables
# ---------------------------------------------------------------------------

C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "long long": ctypes.c_longlong,
           "unsigned": ctypes.c_uint}
BOUND = {**kernels.SIGNATURES, **{n: args for n, (args, _) in kernels.QUERIES.items()}}


def c_entries() -> dict:
    """name -> ctypes types of the parameters of every function defined in
    an extern "C" block of odgi_tpu_torch/csrc/*.cu."""
    out = {}
    for src in kernels.sources():
        for block in re.findall(r'extern "C" \{(.*?)\}  // extern "C"', src.read_text(), re.S):
            for name, params in re.findall(r"^int (\w+)\(([^)]*)\)\s*\{", block, re.M):
                assert name not in out, f"{name} is defined twice"
                types = [" ".join(p.replace("const ", "").split()[:-1]) for p in params.split(",")]
                out[name] = [C_TYPES[t] for t in types]
    return out


@pytest.mark.parametrize("name", sorted(BOUND))
def test_bound_entry_has_the_sources_parameters(name):
    assert c_entries().get(name) == BOUND[name]


def test_every_c_entry_is_bound():
    assert sorted(c_entries()) == sorted(BOUND)
