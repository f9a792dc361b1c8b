#!/usr/bin/env python3
"""odgi_tpu's outputs of chip_smoke.py's phase 12, as digests.

Runs every command of `chip_smoke.POSITION_CMDS` through `odgi_tpu.cli` on
the graphs chip_smoke.py generates (the smoke graph's .otg, a .lay of its
init_layout coordinates, phase 11's BED ranges, and the DRB1-scale graph
as .otg), and prints `chip_smoke.position_digests` of each command as the
`POSITION_DIGESTS` dict that chip_smoke.py holds, then `python -m
odgi_tpu.cli server`'s replies to `SERVER_QUERIES` from the smoke .xpt as
`SERVER_REPLIES`, so that the card's machine (without JAX) can check that
the port answers as odgi_tpu does.  Each command's wall here goes to
stderr.

    python tools/position_digests.py      # about 45 s on one CPU core

Needs odgi_tpu, and writes only into a temporary directory.
"""

from __future__ import annotations

import contextlib
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
from odgi_tpu.io.og import load_graph  # noqa: E402


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
        save_layout(init_layout(load_graph(smoke), "d"), os.path.join(tmp, "init.lay"))
        cs.render_side_files(tmp)
        names = cs.position_names(tmp, cs.shuffled_graph(*cs.DRB1))
        digests = {}
        for key, res in cs.render_run(names, on_odgi_tpu, cs.POSITION_CMDS).items():
            digests[key] = cs.position_digests(res)
            print(f"{key}: {res['wall_s']:.3f} s, {len(res['stdout'])} bytes printed",
                  file=sys.stderr)
        server = cs.serve_and_ask("odgi_tpu.cli", os.path.join(names["d"], "smoke.xpt"),
                                  cs.SERVER_QUERIES, env=dict(os.environ, JAX_PLATFORMS="cpu"))
        if server["rc"] != 0:
            raise SystemExit(f"odgi_tpu's server: exit {server['rc']}")
    print("POSITION_DIGESTS = " + json.dumps(digests, indent=4))
    print("SERVER_REPLIES = " + json.dumps(server["replies"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
