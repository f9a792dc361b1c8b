#!/usr/bin/env python3
"""odgi_tpu's outputs of chip_smoke.py's phase 13, as digests.

Runs every command of `chip_smoke.LIBRARY_CMDS` (layout0) through
`odgi_tpu.cli`, and `chip_smoke.library_session` with odgi_tpu's
`compat.odgi`, `compat.odgi_ffi`, `algorithms.vg_algos` and
`algorithms.mondriaan`, on the graphs chip_smoke.py generates (the
DRB1-scale graph and the 1,000-step graph, as .otg), and prints the
digests as the `LIBRARY_DIGESTS` dict that chip_smoke.py holds, so that
the card's machine (without JAX) can check that the port answers as
odgi_tpu does.  Each command's and each part's wall here goes to stderr.

    python tools/library_digests.py      # about 15 s on one CPU core

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
from odgi_tpu.algorithms import mondriaan, vg_algos  # noqa: E402
from odgi_tpu.cli import main as j_cli  # noqa: E402
from odgi_tpu.compat import odgi, odgi_ffi  # noqa: E402
from odgi_tpu_torch.io import og as og_io  # noqa: E402


def on_odgi_tpu(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = j_cli.main(argv)
    if rc != 0:
        raise SystemExit(f"{' '.join(argv)}: exit {rc}: {err.getvalue()}")
    return out.getvalue(), err.getvalue()


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        names = cs.library_names(tmp)
        og_io.save_graph(cs.shuffled_graph(*cs.DRB1), names["drb"])
        og_io.save_graph(cs.shuffled_graph(*cs.SMALL), names["small"])
        digests = {}
        for key, res in cs.render_run(names, on_odgi_tpu, cs.LIBRARY_CMDS).items():
            digests[key] = cs.position_digests(res)
            print(f"{key}: {res['wall_s']:.3f} s, {len(res['stdout'])} bytes printed",
                  file=sys.stderr)
        sess = cs.library_session(odgi, odgi_ffi, vg_algos, mondriaan, names["drb"],
                                  names["d"], {})
        digests.update(sess["digests"])
        print(f"library_session walls: {sess['walls_s']}", file=sys.stderr)
    print("LIBRARY_DIGESTS = " + json.dumps(digests, indent=4))
    return 0


if __name__ == "__main__":
    sys.exit(main())
