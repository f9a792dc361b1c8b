#!/usr/bin/env python3
"""odgi_tpu's outputs of chip_smoke.py's phase 11, as digests.

Runs every command of `chip_smoke.RENDER_CMDS` through `odgi_tpu.cli` on
the smoke graph as chip_smoke.py generates it (1,500,000 steps over 10,000
nodes; its .otg and a .lay of its init_layout coordinates), and prints
`chip_smoke.render_digest` of each printout and written file as the
`RENDER_DIGESTS` dict that chip_smoke.py holds, so that the card's machine
(without JAX) can check that the port renders and edits as odgi_tpu does
on a host with PIL.  A PNG is digested by its pixels there; the digests of
the PNG files' bytes (the local zlib's deflate) follow as
`RENDER_PNG_BYTES`, which chip_smoke.py reports beside the card's, without
a gate.

    python tools/render_digests.py      # about a minute on one CPU core

Needs odgi_tpu and Pillow, and writes only into a temporary directory.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from odgi_tpu.algorithms.layout import init_layout  # noqa: E402
from odgi_tpu.cli import main as j_cli  # noqa: E402
from odgi_tpu.io.lay import save_layout  # noqa: E402
from odgi_tpu.io.og import load_graph, save_graph  # noqa: E402
from odgi_tpu_torch.convert import graph_to_arrays  # noqa: E402
from odgi_tpu.core.graph import GraphTensors  # noqa: E402


def on_odgi_tpu(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = j_cli.main(argv)
    if rc != 0:
        raise SystemExit(f"{' '.join(argv)}: exit {rc}: {err.getvalue()}")
    return out.getvalue(), err.getvalue()


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        gfa, smoke = os.path.join(tmp, "smoke.gfa"), os.path.join(tmp, "smoke.otg")
        cs.write_smoke_gfa(gfa, cs.SMOKE_STEPS, cs.SMOKE_NODES, cs.SMOKE_PATH_STEPS)
        on_odgi_tpu(["build", "-g", gfa, "-o", smoke])
        lay = os.path.join(tmp, "init.lay")
        save_layout(init_layout(load_graph(smoke), "d"), lay)
        small = os.path.join(tmp, "small.otg")
        save_graph(GraphTensors(**graph_to_arrays(cs.shuffled_graph(*cs.SMALL))), small)
        d = os.path.join(tmp, "out")
        os.makedirs(d)
        names = dict(g=smoke, lay=lay, small=small, d=d, **cs.render_side_files(tmp))
        digests, png_bytes = {}, {}
        for key, run in cs.render_run(names, on_odgi_tpu).items():
            digests[key] = {"stdout": cs.render_digest(run["stdout"].encode()),
                            **{f: cs.render_digest(b) for f, b in run["files"].items()}}
            png_bytes.update({f: hashlib.sha256(b).hexdigest()[:16]
                              for f, b in run["files"].items() if f.endswith(".png")})
            print(f"{key}: {run['wall_s']:.3f} s", file=sys.stderr)
    print("RENDER_DIGESTS = " + json.dumps(digests, indent=4))
    print("RENDER_PNG_BYTES = " + json.dumps(png_bytes, indent=4))
    return 0


if __name__ == "__main__":
    sys.exit(main())
