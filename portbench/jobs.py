"""The benchmark's job kinds: what a traffic file's "job" names.

A job runs the program once from a host ``GraphTensors`` and a PG-SGD seed
to a host result, as a user's command would.  Each kind also names the
end-to-end metric its window reports, runs the plain reference of the same
job, and compares the two.  Every compared number is a gap that a sound
run reads as 0 or nearly; ``limits/<cell>.json`` holds each one's limit.
Each kind also gives the sampled stress of a result, a yardstick of
quality that does not depend on the plan or the schedule; it is reported
beside the check for the program and the reference, and decides nothing.

A kind is a class built from the traffic file's parameters with
``metric`` (the end-to-end metric's name), ``one_d``, ``install()`` /
``uninstall()`` (around the jobs of a run), ``run(g, seed, device)``,
``keep(out)`` (the host arrays the check reads), ``reference(f, seed,
device, acc_dtype)``, ``compare(got, ref)`` (gap name to number) and
``quality(f, kept)``; optionally ``prepare(g, workdir)``, called once in
set-up before the warm-up job to write the run's input files (a command
line's ``.og``) into a temporary directory, outside the timed jobs.  The
two built-in kinds are below; any other name is the class ``JOB`` of
``kinds/<name>.py``, so a new kind is a new file.

- ``layout``: ``layout_graph(g, derive_config_2d(g, seed=s), seed=s)``,
  the packed (2N, 2) coordinates; ``coord_gap`` is the largest coordinate
  difference over the reference's extent.
- ``sort``: ``sort_pipeline(g, "Ygs", sgd_overrides={"seed": s})``, the
  sorted graph; ``graph_mismatch`` counts the step handles, edges and
  sequence bytes that differ from the reference's sorted graph, and
  ``x_gap`` is the largest difference of the Y pass's 1D positions over
  their extent.  The positions are kept as the program hands them to
  ``order_from_x``: the order alone does not move when the sums lose
  precision (see PERF.md), so only the positions can show that.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

FAR = 1e30   # the gap of an answer of the wrong shape or with a non-finite value


def sampled_stress(f: dict, coords: np.ndarray, one_d: bool, pairs: int = 1 << 20) -> float:
    """The layout's stress over a fixed sample of step pairs of one path:
    the mean of ((|c_i - c_j| - d) / d)**2, d the pair's distance in bp
    along the path.  A step's point is the endpoint it enters by (2D) or
    its node's position (1D).  A yardstick of quality that no plan or
    schedule fixes: it is reported, not compared."""
    rng = np.random.default_rng(12345)
    off = f["path_offset"].astype(np.int64)
    i = rng.integers(0, off[-1], pairs)
    path = np.searchsorted(off, i, side="right") - 1
    j = off[path] + (rng.random(pairs) * (off[path + 1] - off[path])).astype(np.int64)
    d = np.abs(f["step_pos"][i] - f["step_pos"][j]).astype(np.float64)
    keep = d > 0
    h = f["step_handle"].astype(np.int64)
    c = np.asarray(coords, np.float64)
    if one_d:
        far = np.abs(c[h[i] >> 1] - c[h[j] >> 1])
    else:
        far = np.hypot(*(c[h[i]] - c[h[j]]).T)
    return float(np.mean(((far[keep] - d[keep]) / d[keep]) ** 2))


def _gap(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape or not np.isfinite(a).all():
        return FAR
    return float(np.abs(a - b).max() / max(float(np.ptp(b, axis=0).max()), 1e-300))


class LayoutJob:
    metric = "layout_s"
    one_d = False

    def __init__(self, traffic: dict):
        self.init_mode = traffic.get("init_mode", "d")
        if self.init_mode != "d":
            raise ValueError("the layout reference starts from init mode 'd' only")

    def install(self) -> None:
        pass

    def uninstall(self) -> None:
        pass

    def run(self, g, seed: int, device):
        from odgi_tpu_torch.algorithms.layout import layout_graph
        from odgi_tpu_torch.ops.sgd import derive_config_2d

        return layout_graph(g, derive_config_2d(g, seed=seed), seed=seed,
                            init_mode=self.init_mode, device=device)

    def keep(self, out) -> dict:
        return {"coords": np.asarray(out)}

    def reference(self, f: dict, seed: int, device, acc_dtype) -> dict:
        from . import reference

        return {"coords": reference.layout(f, seed, device, acc_dtype)}

    def compare(self, got: dict, ref: dict) -> dict:
        return {"coord_gap": _gap(got["coords"], ref["coords"])}

    def quality(self, f: dict, kept: dict) -> float:
        return sampled_stress(f, kept["coords"], False)


class SortJob:
    metric = "sort_s"
    one_d = True
    GRAPH = ("step_handle", "edge_from", "edge_to", "seq", "node_len")

    def __init__(self, traffic: dict):
        self.pipeline = traffic["pipeline"]
        if self.pipeline != "Ygs":
            raise ValueError("the sort reference runs the pipeline 'Ygs' only")
        self.last_x = None
        self._orig = None

    def install(self) -> None:
        """Keep the positions the Y pass orders by (a reference, no copy)."""
        from odgi_tpu_torch.algorithms import path_sgd_sort

        orig = self._orig = path_sgd_sort.order_from_x

        def order_from_x(g, X):
            self.last_x = X
            return orig(g, X)

        path_sgd_sort.order_from_x = order_from_x

    def uninstall(self) -> None:
        from odgi_tpu_torch.algorithms import path_sgd_sort

        if self._orig is not None:
            path_sgd_sort.order_from_x = self._orig
            self._orig = None

    def run(self, g, seed: int, device):
        from odgi_tpu_torch.algorithms.path_sgd_sort import sort_pipeline

        return sort_pipeline(g, self.pipeline, sgd_overrides={"seed": seed}, device=device)

    def keep(self, out) -> dict:
        kept = {k: np.asarray(getattr(out, k)) for k in self.GRAPH}
        kept["x"] = np.asarray(self.last_x)
        return kept

    def reference(self, f: dict, seed: int, device, acc_dtype) -> dict:
        from . import reference

        return reference.sort_ygs(f, seed, device, acc_dtype)

    def compare(self, got: dict, ref: dict) -> dict:
        bad = 0
        for k in self.GRAPH:
            a, b = np.asarray(got[k]), np.asarray(ref[k])
            bad += int((a != b).sum()) if a.shape == b.shape else max(a.size, b.size)
        return {"graph_mismatch": float(bad), "x_gap": _gap(got["x"], ref["x"])}

    def quality(self, f: dict, kept: dict) -> float:
        return sampled_stress(f, kept["x"], True)


KINDS = {"layout": LayoutJob, "sort": SortJob}


def make(traffic: dict, kind_dir: Path = Path(__file__).resolve().parent / "kinds"):
    """The job of a traffic file: a built-in kind, else ``kinds/<job>.py``'s ``JOB``."""
    kind = traffic["job"]
    if kind in KINDS:
        return KINDS[kind](traffic)
    from .harness import load_file

    return load_file(Path(kind_dir) / f"{kind}.py", "job kind").JOB(traffic)
