#!/usr/bin/env python3
"""Smoke run of odgi_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one line or more:
  1. device: the card's name, the device count, nvidia-smi's name and
     power limit;
  2. build: compile every csrc/*.cu (one nvcc each, all at once) and print
     ptxas's registers, shared memory and spills per kernel and the leveled
     kernels' clusters;
  3. the resident kernels against their plain PyTorch versions on the card,
     group by group over an iter_max=2 plan of the smoke graph (1D and 2D),
     with the stated tolerances; the leveled chunk kernels equal the chain
     kernels strata_chunks_2d / _1d, and strata_merge_sum equals the
     ascending-order loop merge_sum_ordered_plain, bit for bit;
  4. the smoke path at the default schedules through the entry points:
     synthetic GFA (1,500,000 steps = 30 paths x 50,000 steps over 10,000
     nodes) -> parse_gfa -> sort_pipeline("Ygs") -> layout_graph ->
     save_layout/load_layout (.lay) -> sum_of_path_node_distances, with the
     quality and plan gates (the resident route); the Y sort and the layout
     again with their chunk phases forced onto the chain kernels give the
     same order and coordinates, bit for bit;
 4b. options, on the smoke graph of phase 4: the leveled kernels' tracking
     instances against the untracked kernels (bit-equal drift, timed in
     turns) and the plain versions (bit-equal Delta_max) on the first
     groups of the full plans; the Y sort and the layout in turns with and
     without -j; both with a delta of 1e-30 (order and coordinates
     bit-equal to phase 4's) and with one picked from that run's own
     Delta_max values (stopping at the predicted iteration, bit-equal to
     the untracked state run group by group up to it); a Y sort with path
     0 pinned (-H; the batched path: pinned positions unchanged bit for
     bit, nt-distance below its start); a layout with 30 .lay snapshots
     (-u; batched), also timed without them; a layout of every other path
     (-f; resident, bit-equal to the same run on the kept graph); Y and
     the layout of a 1,000-step graph (batched); and one batched 2D batch
     timed and its CUDA kernels counted with torch.profiler;
 4c. the command line (odgi_tpu_torch.cli.main, device None) on phase 4's
     GFA: the native parser against the Python one (equal graphs, both
     timed) and a timed .otg round trip; then build (one .og, its write
     timed; the native parser) and build .otg -> validate (its problems
     counted against numpy) -> sort -p Ygs --metrics --profile -> layout
     --profile -> stats -S -s and stats -s -c through .otg, each
     command's wall and its graph reads and writes timed:
     the sorted graph bit-equal to phase 4's sort_pipeline("Ygs"), the
     .lay bytes equal to phase 4's, the printed nt-distance and stress
     equal to phase 4's to the printed digit, the --metrics line, each
     trace's kernels and program spans (a trace without a kernel, or
     without the program's strata.build and strata.run spans, fails) and
     the event-sum idle shares; then layout
     --metrics on the 1,000-step graph (batched: one record an iteration);
  5. on short plans (a few hundred chunks a group) of the XL and the
     1M-node graphs, on their own routes: the leveled kernels against the
     chain kernels (bit for bit) and the plain versions, the blocked sum
     against the CSR sum (bit for bit) and its plain version, and the
     broadcast against its plain version (bit for bit, beside the times of
     the designs it replaced);
  6. the XL path: 5,000,000 steps (100 paths x 50,000 over 10,000 nodes)
     -> sort_pipeline("Ygs") -> layout_graph -> .lay -> stats, on the "xl"
     route in 1D and 2D; the layout forced onto the "resident" route with
     the chain kernel gives the same coordinates, bit for bit; then the
     leveled 1D and 2D kernels against the chain kernels on the first
     groups of the full plans;
  7. the 1M-node path (tools/bigscale_bench.py --shuffle --quality):
     10,000,000 steps (10 paths over 1,000,000 nodes) -> sort_pipeline("Y")
     and layout_graph on the "xxl" route, gated on BIGSCALE_r05.json's start
     values and quality, then sort_pipeline("gs") and a .lay round trip;
     then, on the first groups of the full 1D and 2D plans, the leveled
     kernels against the chain kernels, and the blocked sum against
     the CSR sum (bit-equal) and one index_add_, each timed;
  8. the sharded path (odgi_tpu_torch.parallel.sharded_strata), after the XL
     path: the sorted smoke and XL graphs at 4 devices simulated on the
     card, default 2D schedule, each gated at most 5% above its graph's
     single-device stress from phases 4 and 6; on the smoke graph 1 device
     simulated equals, bit for bit, the same run in a one-rank NCCL process
     group, and lies within 1e-4 of the scale of path_sgd_2d on the
     resident route; each graph's stacked plan's first group of its last
     device goes through the kernels against their plain versions.
  9. the multi-device batched sampler (odgi_tpu_torch.parallel.sharded),
     after phase 7: on the smoke graph of phase 4 at 4 devices simulated
     ("iteration" consensus, default schedules), sharded_sort_order (gated
     on nt-distance below its start, printed beside phase 4's strata Y)
     and sharded_layout of the sorted graph (gated at most 5% above the
     stress of phase 4b's single-device batched -u layout, whose wall
     without snapshots it prints beside its own): each wall, batch rounds,
     rounds/s, valid pairs/s over the wall (the pairs counted in an
     untimed replay of the run's sampling), and the CUDA events of one
     round and their device ms (torch.profiler over a run of 3 rounds, cut
     at each round's one scatter: two readings of a round, which stand
     only where they hold the same events name by name; else they print
     as null).  Then on
     a DRB1-scale graph (12 paths, 35,064 steps over 4,955 nodes, from
     synth_graph), 1D and 2D: "batch" consensus at 4 devices against the
     batched path's own update of one batch of 4 B pairs on the same
     words; one device simulated against a one-rank NCCL group (one
     iteration of two rounds); the local accumulators on the card against
     the CPU; each within 1e-6 of its scale;
 10. the rest of the command line (odgi_tpu_torch.cli.main, device None),
     on phase 4c's smoke .otg: sort -p with each code n f r b z w c d e l
     and the chain Ygsbw, each sorted graph bit-equal to sort_pipeline on
     the CPU in this run (the chain's Y through the entry point on the
     card; counted, the resident 1D kernels); stats --is-acyclic,
     --count-walks, --shortest-cycle and paths -L, -l, -f, -H, each
     printout equal to the CPU's; each command's wall.  sort -p l and
     stats --shortest-cycle run on the 1,000-step graph instead: on the
     smoke graph each took more than 200 s of a CPU (a BFS and a term loop
     a node in Python; a Dijkstra from every node), past the 60 s these
     phases allow a command.  Then sort -Y -u on the 1,000-step graph:
     100 .og snapshots, the last equal to the result.
 11. the pictures and the edits (odgi_tpu_torch.cli.main, device None),
     after phase 10, on phase 4c's smoke .otg as generated and a .lay of
     its init_layout coordinates: depth, degree, viz in each colour mode,
     draw -p -s (and -C path -b), unchop, normalize, flip, prune, explode,
     squeeze, flatten, groom, crush, break, unitig, inject, cover, priv,
     procbed, and unchop then chop -c 4 on a graph of multi-base nodes
     and bubbles (bubble_graph; unchop merges nothing on the smoke graph),
     each command's wall: every printout and written file equal to
     odgi_tpu's on Pillow 12.1.0 (RENDER_DIGESTS, from
     tools/render_digests.py; a PNG by its pixels, as the card's zlib may
     differ); the viz and draw PNGs decode to the arrays the API renders;
     viz and draw of phase 4c's sorted graph and layout, which no digest
     holds, card against CPU; no kernel launches.  And after phase 7,
     render_viz of the 1M-node graph after Ygs and draw_png of its layout
     through the API, each timed, each PNG decoding to the array rendered.
 12. positions, subgraphs, path indexes and analytics
     (odgi_tpu_torch.cli.main, device None), after phase 11: pathindex,
     stepindex, panpos (from the .xpt and from the graph), position (-p,
     -b, -g -I), extract (-r -c, and -b -s -K into three .og), overlap,
     matrix, similarity, tension (of phase 11's .lay), heaps, pav and bin
     on phase 4c's smoke .otg; untangle (with its cut points), untangle
     -p, tips -v and kmers -e -D on phase 9's DRB1-scale graph (on the
     smoke graph odgi_tpu's untangle and tips take 12-16 s of a CPU, and
     kmers' walks grow without bound); each command's wall, every
     printout, stderr and written file equal to odgi_tpu's
     (POSITION_DIGESTS, from tools/position_digests.py); then `python -m
     odgi_tpu_torch.cli server` from the smoke .xpt in a subprocess, its
     replies to /hi, percent-encoded path names, 1-based positions and
     /stop equal to odgi_tpu's (SERVER_REPLIES); no kernel launches.
 13. the library surface, after phase 12: layout0 -p 16 on the DRB1-scale
     .otg and layout0 (all pairs) on the 1,000-step graph through the
     command line (device None), and on the DRB1-scale graph a scripted
     `import odgi` session (load, iterate, create / divide / combine /
     orient / rewrite / destroy, serialize, to_gfa), the `import odgi_ffi`
     walkthrough, vg_algos over a fixed set of handles and mondriaan_sort
     at 2 and 8 parts, every printout, file and transcript equal to
     odgi_tpu's (LIBRARY_DIGESTS, from tools/library_digests.py); then a
     user's script on the card: odgi.graph() (device None) loads phase
     4c's smoke .otg, freeze(), sort_pipeline("Ygs") on the card (counted:
     the resident 1D kernels) bit-equal to phase 4's sorted graph, and
     apply_ordering with its order, whose frozen graph holds phase 4's
     nodes in rank order (up to groom's flips); the chain's walls; then
     `python -m odgi_tpu_torch.cli test -- PORT_TEST_ARGS` in a subprocess,
     and the same with jax made unimportable (the card's machine has jax):
     each exits 0 with at least one card test passed, the second naming
     the files that import odgi_tpu as left out, the first none where jax
     is installed; the phase's wall on its own line.
Every path runs with the launch counts set to 0 just before it and read
just after; every SPIN_EVERY-th launch of a kernel on it is queued behind a
spin kernel, so that its time holds the kernel alone; each prints the
conflict levels of its 1D and 2D plans (depth, chunks a level, the
leveled kernels' tiles a group, predecessors a chunk) and the host seconds
that built the schedule (host_s.levels_1d / levels_2d).  Wherever the
leveled kernels are held against the chain kernels (phases 3, 5, 6, 7 and
8), both are timed on the same group.  The line before the card line is
one JSON object with every kernel's launches, error, times and bound (the
chain kernels, off the main path, with the times of their comparison
launches); the last line is the ok/device object.  Any failed phase exits
non-zero and prints no ok line.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import glob
import hashlib
import importlib.util
import io
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request
import zlib

import numpy as np
import torch

import odgi_tpu_torch as ot
from odgi_tpu_torch import native
from odgi_tpu_torch.algorithms import (draw, groom, layout, mondriaan, path_sgd_sort,
                                      topological, vg_algos, viz)
from odgi_tpu_torch.cli import main as cli_main
from odgi_tpu_torch.cli.commands3 import imports_odgi_tpu
from odgi_tpu_torch.compat import odgi as odgi_compat
from odgi_tpu_torch.compat import odgi_ffi
from odgi_tpu_torch.convert import FIELDS
from odgi_tpu_torch.io import gfa as gfa_io
from odgi_tpu_torch.io import og as og_io
from odgi_tpu_torch.io import png
from odgi_tpu_torch.ops import (batched_sgd, kernels, sgd, strata_levels, strata_plan,
                                strata_route, strata_sgd, strata_xxl)
from odgi_tpu_torch.ops.sgd import derive_config_1d, derive_config_2d
from odgi_tpu_torch.parallel import sharded, sharded_strata

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
F64_OPS_PER_S = 34e12       # H100 SXM f64 outside the tensor cores

# Calibration of the smoke gates: odgi_tpu's CPU twins on this exact graph,
# through the same pipeline (GFA write + parse, twin 1D, groom, topological
# order, init_layout("d"), twin 2D).
TWIN = dict(nt_before=1556.97, nt_after=0.6777, stress_before=97.73,
            stress_after=1.5394)
PLAN_GATES = {"1d": dict(cpi=456, total_valid=149_597_691),
              "2d": dict(cpi=4560, total_valid=451_020_875)}
PLANE_ROWS = 12_288
NT_AFTER_MAX = 0.75
STRESS_AFTER_MAX = 1.62      # the twin's 1.5394 plus 5%
CHUNK_TOL = 1e-6             # max |drift delta| / scale, chunk phases
MERGE_TOL = 1e-12            # max |delta| / scale, f64 merges
LAY_TOL = 1e-9               # .lay round trip, relative to the scale

SMOKE_STEPS, SMOKE_NODES, SMOKE_PATH_STEPS = 1_500_000, 10_000, 50_000
XL_STEPS, XL_NODES, XL_PATH_STEPS = 5_000_000, 10_000, 50_000
BIG_STEPS, BIG_NODES, BIG_PATH_STEPS = 10_000_000, 1_000_000, 1_000_000
# BIGSCALE_r05.json (odgi_tpu on a TPU v5e, the same graph and start):
# only the quality numbers carry over.
BIGSCALE = dict(nt_before=649_736.0405, nt_after=1.4836,
                stress_before=324_911.5038, stress_after=1.2882)
START_RTOL = 1e-6
BIG_NT_AFTER_MAX = 1.558       # BIGSCALE's 1.4836 plus 5%
BIG_STRESS_AFTER_MAX = 1.353   # BIGSCALE's 1.2882 plus 5%
SHARDED_DEVICES = 4
SHARDED_STRESS_RATIO = 1.05    # a sharded stress at most 5% above the graph's single-device one
SHARDED_ONE_TOL = 1e-4         # one device against path_sgd_2d (resident), of the scale
SAMPLER_DEVICES = 4           # phase 9: simulated devices of the batched sampler
SAMPLER_TOL = 1e-6            # phase 9 checks, of the scale (PERF.md §2's batched bar)
SAMPLER_CHECK_BATCH = 4096    # n x B = 16,384 <= the DRB1-scale graph's steps: one window
DRB1 = (35_064, 4_955, 2_922)  # steps, nodes, steps a path: DRB1-3123's 12 paths and nodes
CLI_CODES = "nfrbzwcdel"      # phase 10: every sort code but Y g s (phases 4 and 4c)
CLI_CHAIN = "Ygsbw"           # phase 10's chain of codes
SLOW_ON_SMOKE = ("l", "--shortest-cycle")  # phase 10 on the 1,000-step graph (see the docstring)
SHORT_TERMS = 1024 * 1024      # short plans: a few hundred chunks a group
BUSY_CYCLES = 2_000_000        # about 1 ms of the card's clock, past any wrapper's host time
SPIN_EVERY = 20                # every 20th launch of a kernel on a counted path runs behind
                               # a spin kernel, so that its events hold the kernel alone

RESIDENT = ("strata_chunks_2d", "strata_chunks_1d", "strata_merge_sum",
            "strata_merge_bcast")
BLOCKED = ("strata_merge_sum_blocked",)
LEVELS_2D, LEVELS_1D = "strata_chunks_2d_levels", "strata_chunks_1d_levels"
LEVELS = {False: LEVELS_2D, True: LEVELS_1D}  # by one_d
# The leveled kernels' tracking instances (delta early stop), counted apart.
TRACK_2D, TRACK_1D = kernels.TRACKED[LEVELS_2D], kernels.TRACKED[LEVELS_1D]
TRACKS = {False: TRACK_2D, True: TRACK_1D}
# The chain kernels: the leveled kernels' reference, off the main path,
# launched only to hold the leveled kernels bit-equal and to time them
# beside them.
CHAINS = {False: "strata_chunks_2d", True: "strata_chunks_1d"}  # by one_d
CHAIN = tuple(CHAINS.values())
ROUTE_KERNELS = {
    "resident": (LEVELS_2D, LEVELS_1D, "strata_merge_sum", "strata_merge_bcast"),
    "xl": (LEVELS_2D, LEVELS_1D, "strata_merge_sum", "strata_merge_bcast"),
    "xxl": (LEVELS_2D, LEVELS_1D, "strata_merge_sum_blocked", "strata_merge_bcast"),
}
SHARDED_KERNELS = (LEVELS_2D, "strata_merge_sum", "strata_merge_bcast")  # once a group each
FULL_GROUPS = 2  # groups of a full plan run on the leveled and the chain kernels
STOP_MARGIN = 1e-3  # an interior delta stop lies this far (relative) below every earlier one
SNAPSHOTS = 30      # -u: one .lay an iteration of the default 2D schedule
SMALL = (1_000, 200, 250)  # steps, nodes, steps a path: under 1,024 steps, the batched path
# Phase 11: the pictures and the edits, on phase 4c's smoke .otg ("{g}") as
# generated and its init_layout coordinates ("{lay}"); "{d}" is the run's
# output directory, "{small}" the 1,000-step graph, "{bub}" bubble_graph's
# GFA (unchop merges nothing on the smoke graph), "{bed}" / "{tgt}" the
# side files of render_side_files.  (key, command, files it writes)
RENDER_CMDS = (
    ("depth_d", "depth -i {g} -d", ()),
    ("depth_ranges", "depth -i {g}", ()),
    ("depth_windows", "depth -i {g} -w 100:0:5:0", ()),
    ("degree_S", "degree -i {g} -S", ()),
    ("degree_d", "degree -i {g} -d --in-out-degree", ()),
    ("viz_path", "viz -i {g} -o {d}/viz_path.png", ("viz_path.png",)),
    ("viz_strand", "viz -i {g} --color-by strand -o {d}/viz_strand.png", ("viz_strand.png",)),
    ("viz_depth", "viz -i {g} -m -o {d}/viz_depth.png", ("viz_depth.png",)),
    ("viz_brewer", "viz -i {g} -m -B Spectral:7 -o {d}/viz_brewer.png", ("viz_brewer.png",)),
    ("viz_gray", "viz -i {g} --color-by gray -o {d}/viz_gray.png", ("viz_gray.png",)),
    ("viz_inversion", "viz -i {g} -z -o {d}/viz_inversion.png", ("viz_inversion.png",)),
    ("viz_uncalled", "viz -i {g} -N -o {d}/viz_uncalled.png", ("viz_uncalled.png",)),
    ("viz_prefix", "viz -i {g} -s # -R -o {d}/viz_prefix.png", ("viz_prefix.png",)),
    ("viz_darkness", "viz -i {g} -d -C -b -o {d}/viz_darkness.png", ("viz_darkness.png",)),
    ("draw", "draw -i {g} -c {lay} -p {d}/draw.png -s {d}/draw.svg", ("draw.png", "draw.svg")),
    ("draw_path", "draw -i {g} -c {lay} -p {d}/draw_path.png -C path -s {d}/draw_bed.svg "
                  "-b {bed}", ("draw_path.png", "draw_bed.svg")),
    ("unchop", "unchop -i {g} -o {d}/unchop.gfa", ("unchop.gfa",)),
    ("unchop_bubbles", "unchop -i {bub} -o {d}/unchop_bubbles.gfa", ("unchop_bubbles.gfa",)),
    ("chop", "chop -i {d}/unchop_bubbles.gfa -c 4 -o {d}/chop.gfa", ("chop.gfa",)),
    ("normalize", "normalize -i {g} -o {d}/normalize.gfa", ("normalize.gfa",)),
    ("flip", "flip -i {g} -o {d}/flip.gfa", ("flip.gfa",)),
    ("prune", "prune -i {g} -d 14 -T -o {d}/prune.gfa", ("prune.gfa",)),
    ("explode", "explode -i {g} -p {d}/explode.", ("explode.0.otg",)),
    ("squeeze", "squeeze -f {g} {small} -o {d}/squeeze.gfa", ("squeeze.gfa",)),
    ("flatten", "flatten -i {g} -n smoke -f {d}/flatten.fa -b {d}/flatten.bed",
     ("flatten.fa", "flatten.bed")),
    ("groom", "groom -i {g} -R {tgt} -o {d}/groom.gfa", ("groom.gfa",)),
    ("crush", "crush -i {g} -o {d}/crush.gfa", ("crush.gfa",)),
    ("break", "break -i {g} -d -c 8 -s 20", ()),
    ("unitig", "unitig -i {g} -f -p 3 --seed 5", ()),
    ("inject", "inject -i {g} -b {bed} -o {d}/inject.gfa", ("inject.gfa",)),
    ("cover", "cover -i {g} -n 1 -o {d}/cover.gfa", ("cover.gfa",)),
    ("priv", "priv -i {g} -c 1 -d 0.1 -b 200 --seed 1 -W -o {d}/priv.gfa", ("priv.gfa",)),
    ("procbed", "procbed -i {d}/prune.gfa -b {bed}", ()),
)
# odgi_tpu's outputs of RENDER_CMDS on a CPU host with Pillow 12.1.0,
# from tools/render_digests.py: render_digest of each printout and file.
RENDER_DIGESTS = {
    "depth_d": {"stdout": "b14f9724b238143a"},
    "depth_ranges": {"stdout": "b9e67b5c0bbcb1c3"},
    "depth_windows": {"stdout": "28ec5f7e500b0432"},
    "degree_S": {"stdout": "633fe49f178542c3"},
    "degree_d": {"stdout": "7c4e8a48b38ce9c6"},
    "viz_path": {"stdout": "e3b0c44298fc1c14", "viz_path.png": "bab5695d55c695eb"},
    "viz_strand": {"stdout": "e3b0c44298fc1c14", "viz_strand.png": "3bf762d97498ca49"},
    "viz_depth": {"stdout": "e3b0c44298fc1c14", "viz_depth.png": "c098e853243baf63"},
    "viz_brewer": {"stdout": "e3b0c44298fc1c14", "viz_brewer.png": "8a881c966831fb2f"},
    "viz_gray": {"stdout": "e3b0c44298fc1c14", "viz_gray.png": "09674e8ef6a294db"},
    "viz_inversion": {"stdout": "e3b0c44298fc1c14", "viz_inversion.png": "2ee2ba770883d1b2"},
    "viz_uncalled": {"stdout": "e3b0c44298fc1c14", "viz_uncalled.png": "e239f59278ae7f69"},
    "viz_prefix": {"stdout": "e3b0c44298fc1c14", "viz_prefix.png": "972b38d9886c865c"},
    "viz_darkness": {"stdout": "e3b0c44298fc1c14", "viz_darkness.png": "2debd251247d61ba"},
    "draw": {"stdout": "e3b0c44298fc1c14", "draw.png": "979a2a456fed6d80", "draw.svg": "0e330f6518f29c1c"},
    "draw_path": {"stdout": "e3b0c44298fc1c14", "draw_path.png": "351847f1ac8a359b", "draw_bed.svg": "66151ced718cadbd"},
    "unchop": {"stdout": "e3b0c44298fc1c14", "unchop.gfa": "d04239e0088b43f1"},
    "unchop_bubbles": {"stdout": "e3b0c44298fc1c14", "unchop_bubbles.gfa": "e668a8581d0a12b6"},
    "chop": {"stdout": "e3b0c44298fc1c14", "chop.gfa": "8be4fb281737b294"},
    "normalize": {"stdout": "e3b0c44298fc1c14", "normalize.gfa": "011f9c278776c94c"},
    "flip": {"stdout": "e3b0c44298fc1c14", "flip.gfa": "d5bc63651308019f"},
    "prune": {"stdout": "e3b0c44298fc1c14", "prune.gfa": "84ae11b8f0e7fc35"},
    "explode": {"stdout": "e3b0c44298fc1c14", "explode.0.otg": "758011d1981fa18d"},
    "squeeze": {"stdout": "e3b0c44298fc1c14", "squeeze.gfa": "a9e2bdb55382a62f"},
    "flatten": {"stdout": "e3b0c44298fc1c14", "flatten.fa": "6877bdc6045ad8e5", "flatten.bed": "b50b4064a88343b0"},
    "groom": {"stdout": "e3b0c44298fc1c14", "groom.gfa": "b8a1074e0e2f6e18"},
    "crush": {"stdout": "e3b0c44298fc1c14", "crush.gfa": "d04239e0088b43f1"},
    "break": {"stdout": "5bf48242b8fe24e5"},
    "unitig": {"stdout": "08b525628cf9cdb1"},
    "inject": {"stdout": "e3b0c44298fc1c14", "inject.gfa": "d94627bf0daa9f22"},
    "cover": {"stdout": "e3b0c44298fc1c14", "cover.gfa": "269746f2127709f3"},
    "priv": {"stdout": "56d45e95fdff1b23", "priv.gfa": "570161abc29b732e"},
    "procbed": {"stdout": "e3b0c44298fc1c14"},
}
# the same PNG files' bytes (sha256, 16 hex digits), deflated by zlib 1.2.13
RENDER_PNG_BYTES = {
    "viz_path.png": "e26c60bf867c12d4",
    "viz_strand.png": "0e004ad6eab75540",
    "viz_depth.png": "5fff2821d4d46269",
    "viz_brewer.png": "01fc2c176f9418dc",
    "viz_gray.png": "b39ad51788fe796a",
    "viz_inversion.png": "4615a232d30858f2",
    "viz_uncalled.png": "1e8c623b8d7c5b42",
    "viz_prefix.png": "93b4274942d29b91",
    "viz_darkness.png": "6c5fc1e532bfa590",
    "draw.png": "41cbfeff2ab4f00e",
    "draw_path.png": "93b4c83ae1b1f4ac",
}
# Phase 12: positions, subgraphs, path indexes and analytics, on phase 4c's
# smoke .otg ("{g}"), phase 11's .lay of its init_layout coordinates
# ("{lay}") and BED ranges ("{bed}"), and on the DRB1-scale graph of phase
# 9 ("{drb}", as .otg) for the commands that take odgi_tpu more than a few
# seconds of a CPU on the smoke graph: untangle and tips (Python loops over
# windows: 12 and 16 s) and kmers (its walks grow exponentially without
# -e/-D).  "{d}" is the output directory.  (key, command, files it writes)
POSITION_CMDS = (
    ("pathindex", "pathindex -i {g} -o {d}/smoke.xpt", ("smoke.xpt",)),
    ("stepindex", "stepindex -i {g} -a 16 -o {d}/smoke.stpidx", ("smoke.stpidx",)),
    ("panpos_xpt", "panpos -i {d}/smoke.xpt -p p0 -v 1000", ()),
    ("panpos_graph", "panpos -i {g} -p p3 -v 12345", ()),
    ("position_p", "position -i {g} -p p3,1000 -r p0", ()),
    ("position_b", "position -i {g} -b {bed} -r p1", ()),
    ("position_g", "position -i {g} -g 17,0,- -I", ()),
    ("extract_r", "extract -i {g} -r p0:100-5000 -c 3 -o {d}/extract_r.gfa", ("extract_r.gfa",)),
    ("extract_s", "extract -i {g} -b {bed} -s -K -o {d}/split.og",
     ("split.p0:100-5000.og", "split.p3:2000-2600.og", "split.p3:40000-40100.og")),
    ("overlap", "overlap -i {g} -b {bed}", ()),
    ("matrix", "matrix -i {g} -w", ()),
    ("similarity", "similarity -i {g}", ()),
    ("tension", "tension -i {g} -c {lay}", ()),
    ("heaps", "heaps -i {g} -S", ()),
    ("pav", "pav -i {g} -b {bed} -M", ()),
    ("bin", "bin -i {g} -w 1000", ()),
    ("untangle", "untangle -i {drb} -q p1 -q p5 -r p0 -d {d}/cuts.txt", ("cuts.txt",)),
    ("untangle_paf", "untangle -i {drb} -r p0 -p", ()),
    ("tips", "tips -i {drb} -r p0 -j -v {d}/tips.tsv", ("tips.tsv",)),
    ("kmers", "kmers -i {drb} -k 6 -e 4 -D 8 -c", ()),
)
# odgi_tpu's outputs of POSITION_CMDS, from tools/position_digests.py:
# render_digest of each printout and file.
POSITION_DIGESTS = {
    "pathindex": {"stdout": "e3b0c44298fc1c14", "stderr": "e3b0c44298fc1c14", "smoke.xpt": "3170ef9bf52d0c71"},
    "stepindex": {"stdout": "e3b0c44298fc1c14", "stderr": "e3b0c44298fc1c14", "smoke.stpidx": "4c01ae6c20b2bd4c"},
    "panpos_xpt": {"stdout": "efbdfd4f9df15ea0", "stderr": "e3b0c44298fc1c14"},
    "panpos_graph": {"stdout": "26253c223a481a3b", "stderr": "e3b0c44298fc1c14"},
    "position_p": {"stdout": "a86ba34fec953b40", "stderr": "e3b0c44298fc1c14"},
    "position_b": {"stdout": "ae73b427a48a98d0", "stderr": "e3b0c44298fc1c14"},
    "position_g": {"stdout": "7a7a31e573488b78", "stderr": "e3b0c44298fc1c14"},
    "extract_r": {"stdout": "e3b0c44298fc1c14", "stderr": "e3b0c44298fc1c14", "extract_r.gfa": "82f5d580ade584e1"},
    "extract_s": {"stdout": "e3b0c44298fc1c14", "stderr": "e3b0c44298fc1c14", "split.p0:100-5000.og": "1aec8e797f089d7f", "split.p3:2000-2600.og": "d07d343c21ead910", "split.p3:40000-40100.og": "84c303c3fd3e5e7a"},
    "overlap": {"stdout": "2c400533aaa52322", "stderr": "e3b0c44298fc1c14"},
    "matrix": {"stdout": "3a487e7595d89a47", "stderr": "e3b0c44298fc1c14"},
    "similarity": {"stdout": "0146fee853e84a16", "stderr": "e3b0c44298fc1c14"},
    "tension": {"stdout": "6dd4efdfb0451554", "stderr": "e3b0c44298fc1c14"},
    "heaps": {"stdout": "405ef993b7fa5a70", "stderr": "e3b0c44298fc1c14"},
    "pav": {"stdout": "7fe483e502bc3450", "stderr": "e3b0c44298fc1c14"},
    "bin": {"stdout": "0bdb4d6afac0789d", "stderr": "e3b0c44298fc1c14"},
    "untangle": {"stdout": "d259f834d9d480f7", "stderr": "e3b0c44298fc1c14", "cuts.txt": "9f3396c9051e9b05"},
    "untangle_paf": {"stdout": "7ee2d4944ddb05ea", "stderr": "e3b0c44298fc1c14"},
    "tips": {"stdout": "2964019dbe9f2383", "stderr": "e3b0c44298fc1c14", "tips.tsv": "e3b0c44298fc1c14"},
    "kmers": {"stdout": "b00ba3796cebc752", "stderr": "e3b0c44298fc1c14"},
}
# `server -i {d}/smoke.xpt`: the queries, and odgi_tpu's replies (its
# PathIndex's answers, from tools/position_digests.py)
SERVER_QUERIES = ("/hi", "/p0/1", "/p3/25000", "/p%311/777", "/p0/999999999", "/nope/1",
                  "/p2/x", "/stop")
SERVER_REPLIES = ("Hello World!", "9226", "315", "8650", "0", "0", "0", "bye")
# Phase 13: layout0 through the command line, on phase 12's DRB1-scale .otg
# ("{drb}") with 16 pivots and on phase 10's 1,000-step graph ("{small}")
# with all pairs (on the smoke graph all pairs is 10^8 iterations of a Python
# loop); (key, command, files it writes)
LIBRARY_CMDS = (
    ("layout0_drb1", "layout0 -i {drb} -p 16 -o {d}/drb1_p16.svg", ("drb1_p16.svg",)),
    ("layout0_small", "layout0 -i {small} -o -", ()),
)
MONDRIAAN_PARTS = (2, 8)
# odgi_tpu's outputs of LIBRARY_CMDS and of library_session on the
# DRB1-scale graph, from tools/library_digests.py: render_digest of each
# printout, file and transcript.
LIBRARY_DIGESTS = {
    "layout0_drb1": {"stdout": "e3b0c44298fc1c14", "stderr": "e3b0c44298fc1c14", "drb1_p16.svg": "7595e18109844f4d"},
    "layout0_small": {"stdout": "584c72b1c80bb634", "stderr": "e3b0c44298fc1c14"},
    "odgi_session": "4ced8c3a4ec77017",
    "odgi_serialize": "b8633696e5b07c71",
    "odgi_to_gfa": "79e1d27c85fc2b82",
    "ffi": "65086d23fb88dbea",
    "vg_algos": "19e3e727f519e9a7",
    "mondriaan_2": "26fb5899a77fa3c4",
    "mondriaan_8": "3cfe77fe64fdf6fc",
    "mondriaan_8_depth": "4d24ded2ebee3552",
}
PORT_TEST_ARGS = ("-m", "cuda", "-k", "bcast_equals_plain and resident")  # phase 13's `test`
REPLACES = {
    "strata_chunks_2d": "odgi_tpu/ops/pallas_sgd.py:1105",
    "strata_chunks_1d": "odgi_tpu/ops/pallas_sgd.py:1158",
    "strata_merge_sum": "odgi_tpu/ops/pallas_sgd.py:922",
    "strata_merge_bcast": "odgi_tpu/ops/pallas_sgd.py:922",
    "strata_merge_sum_blocked": "odgi_tpu/ops/pallas_sgd_xxl.py:212",
    LEVELS_2D: "odgi_tpu/ops/pallas_sgd.py:1105",
    LEVELS_1D: "odgi_tpu/ops/pallas_sgd.py:1158",
    TRACK_2D: "odgi_tpu/ops/pallas_sgd.py:1105",
    TRACK_1D: "odgi_tpu/ops/pallas_sgd.py:1158",
}
ALSO_REPLACES = {
    "strata_merge_sum_blocked": ["odgi_tpu/ops/pallas_sgd_xxl.py:632"],
    LEVELS_2D: ["odgi_tpu/ops/pallas_sgd_xl.py:363", "odgi_tpu/ops/pallas_sgd_xxl.py:212",
                "odgi_tpu/parallel/sharded_pallas.py:60"],
    "strata_merge_sum": ["odgi_tpu/ops/pallas_sgd_xl.py:363", "odgi_tpu/ops/pallas_sgd_xl.py:795",
                         "odgi_tpu/parallel/sharded_pallas.py:60"],
    "strata_merge_bcast": ["odgi_tpu/ops/pallas_sgd_xl.py:363", "odgi_tpu/ops/pallas_sgd_xl.py:795",
                           "odgi_tpu/ops/pallas_sgd_xxl.py:212", "odgi_tpu/ops/pallas_sgd_xxl.py:632",
                           "odgi_tpu/parallel/sharded_pallas.py:60"],
    LEVELS_1D: ["odgi_tpu/ops/pallas_sgd_xl.py:795", "odgi_tpu/ops/pallas_sgd_xxl.py:632"],
}
# The broadcast designs strata_merge_bcast replaced, as this script timed
# them (spin-first launches) on the 1M-node graph's merges before the
# redesign, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6): the blocked
# kernel (a thread block a schedule entry) and the one-thread-a-slot kernel.
REPLACED_BCAST_MS = {"1d": dict(blocked=0.18882, one_thread_a_slot=0.07219),
                     "2d": dict(blocked=0.47560, one_thread_a_slot=0.30608)}
# Kernels with one PyTorch call that computes the same function (an f64
# index_add_), timed as a yardstick only.
LIBRARY = ("strata_merge_sum", "strata_merge_sum_blocked")
SOURCES = {**{n: "odgi_tpu_torch/csrc/strata_sgd.cu" for n in RESIDENT},
           **{n: "odgi_tpu_torch/csrc/strata_blocked.cu" for n in BLOCKED},
           LEVELS_2D: "odgi_tpu_torch/csrc/strata_levels.cu",
           LEVELS_1D: "odgi_tpu_torch/csrc/strata_levels.cu",
           TRACK_2D: "odgi_tpu_torch/csrc/strata_levels.cu",
           TRACK_1D: "odgi_tpu_torch/csrc/strata_levels.cu"}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(tag: str, **kw) -> None:
    print(json.dumps({"phase": tag, **kw}), flush=True)


# ---------------------------------------------------------------------------
# The synthetic graphs (the generator of tools/bigscale_bench.py, as arrays)
# ---------------------------------------------------------------------------


def synth_graph(num_steps: int, num_nodes: int, path_steps: int, seed: int = 11):
    """Deep-coverage synthetic graph: P paths of `path_steps` steps each
    random-walking over `num_nodes` 1 bp nodes with mixed orientations."""
    rng = np.random.default_rng(seed)
    P = -(-num_steps // path_steps)
    S = P * path_steps
    adv = num_nodes / path_steps
    base = int(adv)
    frac = adv - base
    steps = base + (rng.random(S) < frac).astype(np.int64)
    noise = rng.choice([0, 1, -1], size=S, p=[0.95, 0.025, 0.025])
    steps = (steps + noise).reshape(P, path_steps)
    steps[:, 0] = 0
    node = np.clip(np.cumsum(steps, axis=1), 0, num_nodes - 1).reshape(-1)
    orient = rng.integers(0, 2, S)
    step_handle = (node << 1) | orient
    a = step_handle[:-1].copy()
    b = step_handle[1:].copy()
    keep = (np.arange(1, S) % path_steps) != 0
    a, b = a[keep], b[keep]
    e = np.unique(np.stack([np.minimum(a, b), np.maximum(a, b)], 1), axis=0)
    return ot.graph_from_arrays(dict(
        node_len=np.ones(num_nodes, np.int64),
        seq_offset=np.arange(num_nodes + 1, dtype=np.int64),
        seq=np.full(num_nodes, ord("A"), np.uint8),
        node_id=np.arange(1, num_nodes + 1, dtype=np.int64),
        edge_from=e[:, 0], edge_to=e[:, 1],
        path_names=tuple(f"p{i}" for i in range(P)),
        path_circular=np.zeros(P, bool),
        path_offset=np.arange(P + 1, dtype=np.int64) * path_steps,
        step_handle=step_handle,
        step_pos=np.tile(np.arange(path_steps, dtype=np.int64), P),
    ))


def shuffled_graph(steps: int, nodes: int, path_steps: int):
    """`synth_graph` with node ids shuffled by default_rng(5), as
    tools/bigscale_bench.py --shuffle does."""
    g = synth_graph(steps, nodes, path_steps)
    return g.apply_ordering(np.random.default_rng(5).permutation(g.num_nodes))


def write_smoke_gfa(path: str, steps: int, nodes: int, path_steps: int) -> None:
    ot.write_gfa(shuffled_graph(steps, nodes, path_steps), path)


def bubble_graph(nodes: int = 20_000, paths: int = 8, seed: int = 13):
    """A backbone of 1-8 bp nodes that each path walks, skipping about one
    node in twelve (bubbles) and, in every other path, running a block of
    50 nodes backwards (an inversion) every 2,000 nodes: the nodes no path
    skips form the perfect chains unchop merges (phase 11)."""
    rng = np.random.default_rng(seed)
    node_len = rng.integers(1, 9, nodes).astype(np.int64)
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), int(node_len.sum()))
    skippable = rng.random(nodes) < 1 / 6
    walks = []
    for p in range(paths):
        order = np.arange(nodes, dtype=np.int64)
        rev = np.zeros(nodes, dtype=bool)
        if p % 2:
            for b0 in range(1000, nodes - 50, 2000):
                order[b0:b0 + 50] = order[b0:b0 + 50][::-1]
                rev[b0:b0 + 50] = True
        keep = ~(skippable[order] & (rng.random(nodes) < 0.5))
        walks.append((order[keep] << 1) | rev[keep])
    handle = np.concatenate(walks)
    path_offset = np.concatenate([[0], np.cumsum([len(w) for w in walks])]).astype(np.int64)
    last = np.zeros(len(handle), dtype=bool)
    last[path_offset[1:] - 1] = True
    a, b = handle[:-1][~last[:-1]], handle[1:][~last[:-1]]
    fa, fb = b ^ 1, a ^ 1
    flip = (fa < a) | ((fa == a) & (fb < b))   # the canonical side of each edge
    e = np.unique(np.stack([np.where(flip, fa, a), np.where(flip, fb, b)], 1), axis=0)
    lens = node_len[handle >> 1]
    cum = np.cumsum(lens) - lens
    step_path = np.repeat(np.arange(paths), np.diff(path_offset))
    return ot.graph_from_arrays(dict(
        node_len=node_len, seq_offset=np.concatenate([[0], np.cumsum(node_len)]), seq=seq,
        node_id=np.arange(1, nodes + 1, dtype=np.int64), edge_from=e[:, 0], edge_to=e[:, 1],
        path_names=tuple(f"HG{p // 2}#{p % 2 + 1}#chr1" for p in range(paths)),
        path_circular=np.zeros(paths, bool), path_offset=path_offset, step_handle=handle,
        step_pos=cum - cum[path_offset[step_path]]))


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


class Timer:
    """CUDA-event timing of device work (milliseconds)."""

    def __init__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.start.record()

    def stop(self) -> "Timer":
        self.end.record()
        return self

    def ms(self) -> float:
        self.end.synchronize()
        return self.start.elapsed_time(self.end)


def sync_wall(t0: float) -> float:
    torch.cuda.synchronize()
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Bounds: the least bytes each launch must move, over the HBM rate
# ---------------------------------------------------------------------------


def touched_slots(od: np.ndarray, g0: int, cgs: int) -> int:
    """Distinct step slots the chunks g0..g0+cgs-1 read or write: the union
    of their A windows [128*o, 128*o+4096) and B windows (shifted by D)."""
    o = od[g0:g0 + cgs, 0].astype(np.int64) * strata_plan.LANE
    d = od[g0:g0 + cgs, 1].astype(np.int64)
    lo = np.sort(np.concatenate([o, o + d]))
    hi = lo + strata_plan.CHUNK
    run_hi = np.maximum.accumulate(hi)
    gaps = np.maximum(lo[1:] - run_hi[:-1], 0)
    return int(run_hi[-1] - lo[0] - gaps.sum())


def chunk_bounds(p: dict, one_d: bool) -> list:
    """Per group.  Bytes: per touched slot, the i32 planes read (2D: pos,
    pos_end, path; 1D: pos, path), the f32 base read, the f32 drift read and
    written; plus 12 bytes a chunk (its o and D and a schedule word).
    Operations: about 25 f32 operations per pair."""
    od = np.stack([p["o_blk"], p["d_arr"]], axis=1)
    per_slot = 20 if one_d else 60
    out = []
    for gid in range(p["groups"]):
        n = touched_slots(od, gid * p["cgs"], p["cgs"])
        out.append(dict(bytes=n * per_slot + 12 * p["cgs"],
                        ops=25 * p["cgs"] * strata_plan.CHUNK, ops_rate=F32_OPS_PER_S))
    return out


def merge_sum_bound(g, one_d: bool) -> dict:
    """Drift of every real slot and every plane, the CSR, 1/R, the node
    coordinates read and written and the update written; one f64 add per
    slot and plane."""
    S = g.num_steps
    nc, planes = (1, 1) if one_d else (2, 4)
    E = g.num_nodes if one_d else 2 * g.num_nodes
    nbytes = S * planes * 4 + S * 4 + (E + 1) * 4 + E * 8 + nc * E * 8 * 3
    return dict(bytes=nbytes, ops=S * planes + 2 * nc * E, ops_rate=F64_OPS_PER_S)


def merge_bcast_bound(g, L: int, one_d: bool) -> dict:
    """Every slot's endpoint, base read and written, drift written, the
    update table read once."""
    nc, planes = (1, 1) if one_d else (2, 4)
    ecap = g.num_nodes + 1 if one_d else 2 * g.num_nodes + 2
    nbytes = L * 4 + L * planes * 4 * 3 + nc * ecap * 8
    return dict(bytes=nbytes, ops=L * planes, ops_rate=F32_OPS_PER_S)


def bound_ms(b: dict):
    t_bytes = b["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = b["ops"] / b["ops_rate"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def schedule_stats(g, one_d: bool) -> dict:
    """K, node blocks and tile reads per tile of the XXL schedule, with the
    relabel by first visit (what the run uses) and without it."""
    S = g.num_steps
    tiles = -(-S // strata_xxl.TILE)
    g_run, _ = strata_xxl.relabel(g)
    _, K, nb = strata_xxl.build_schedule(g_run, strata_xxl.XXL_BS, one_d)
    _, K_raw, _ = strata_xxl.build_schedule(g, strata_xxl.XXL_BS, one_d)
    planes = 1 if one_d else 4
    return dict(bs=strata_xxl.XXL_BS, K=K, node_blocks=nb, tiles=tiles,
                tile_reads_per_tile=K / tiles, K_without_relabel=K_raw,
                tile_reads_per_tile_without_relabel=K_raw / tiles,
                sched_tile_bytes=K * strata_xxl.TILE * planes * 4)


# ---------------------------------------------------------------------------
# Records: per kernel and per "<path>/<dim>" key
# ---------------------------------------------------------------------------


class Record:
    """Errors, plain and library times of the comparison phases; launch
    times of the counted paths (events; spun: those behind a spin kernel);
    bounds per counted launch; times and bounds of the chain kernels'
    comparison launches (cmp_ms, cmp_bounds)."""

    def __init__(self):
        self.err = {n: {} for n in kernels.NAMES}
        self.plain_ms = {n: {} for n in kernels.NAMES}
        self.library_ms = {n: {} for n in kernels.NAMES}
        self.events = {n: {} for n in kernels.NAMES}
        self.spun = {n: {} for n in kernels.NAMES}
        self.bounds = {n: {} for n in kernels.NAMES}
        self.launches = {n: {} for n in kernels.NAMES}
        self.cmp_ms = {n: {} for n in CHAIN}
        self.cmp_bounds = {n: {} for n in CHAIN}

    def add(self, table: str, name: str, key: str, value) -> None:
        getattr(self, table)[name].setdefault(key, []).append(value)


def run_levels(st, gid: int, drift) -> None:
    """Group `gid` of the state through its leveled kernel, in place on
    `drift`."""
    p = st.plan
    getattr(kernels, LEVELS[st.one_d])(drift, st.base, st.planes, st.od, st.eta, p["cpi"],
                                       st.perm, st.lvl_rows[gid], st.pred_off, st.pred)


def run_chain(st, gid: int, drift) -> None:
    """Group `gid` through the state's chain kernel, in place on `drift`."""
    p = st.plan
    getattr(kernels, CHAINS[st.one_d])(drift, st.base, st.planes, st.od, st.eta, p["cpi"],
                                       gid * p["cgs"], p["cgs"])


def library_merge_sum(st) -> float:
    """One f64 index_add_ over both replica lists: the same consensus sums
    as strata_merge_sum, by a PyTorch call the port never makes."""
    dv = st.drift.to(torch.float64)
    nc = st.coords.shape[0]
    ep = st.mi.ep.to(torch.int64)
    if nc == 1:
        idx, src = ep, dv[0][:, None]
    else:
        idx = torch.cat([ep, ep ^ 1])
        src = torch.cat([dv[0::2].T, dv[1::2].T])
    acc = torch.zeros((st.mi.ecap, nc), dtype=torch.float64, device=dv.device)
    acc.index_add_(0, idx, src)  # warm-up
    acc.zero_()
    return timed(acc.index_add_, 0, idx, src)


def timed(fn, *args) -> float:
    """Device time of fn(*args).  A spin kernel queued first keeps the card
    busy while the host runs the wrapper, so the events time the launches
    alone, as on the main path, where the previous kernel keeps it busy."""
    torch.cuda._sleep(BUSY_CYCLES)
    t = Timer()
    fn(*args)
    return t.stop().ms()


def rel_err(a, b, scale: float) -> float:
    return float((a - b).abs().max()) / scale


# ---------------------------------------------------------------------------
# Phase 3: the resident kernels against their plain versions, group by group
# ---------------------------------------------------------------------------


def level_stats(p: dict, lvl_off: np.ndarray, pred_off: np.ndarray) -> dict:
    """Depth of each group's levels (min, mean, max), chunks a level, the
    tiles a group of the leveled kernel (a chunk is a cluster's tiles),
    predecessors a chunk, and the share of chunks with D < CHUNK (whose
    tiles meet at cluster barriers)."""
    depth = strata_levels.depths(lvl_off)
    clusters, tiles = kernels.levels_clusters(p["data"].one_d)
    return dict(groups=int(p["groups"]), cgs=int(p["cgs"]), depth_min=int(depth.min()),
                depth_mean=float(depth.mean()), depth_max=int(depth.max()),
                chunks_per_level=float(p["cgs"] / depth.mean()), clusters=clusters,
                tiles_per_chunk=tiles, tiles_per_group=int(p["cgs"]) * tiles,
                preds_per_chunk=float(pred_off[-1] / (len(pred_off) - 1)),
                d_below_chunk=float((p["d_arr"] < strata_plan.CHUNK).mean()))


def compare_levels(st, gid: int, rec: Record, key: str, record: bool = True) -> dict:
    """Group `gid` of a state through its leveled kernel and its chain
    kernel on the same inputs: torch.equal drift, or fail.  With `record`
    (groups of a main path's size) the chain's time and bound go to the
    comparison records.  Returns the leveled drift and both times."""
    name, chain = LEVELS[st.one_d], CHAINS[st.one_d]
    d_l, d_c = st.drift.clone(), st.drift.clone()
    l_ms = timed(run_levels, st, gid, d_l)
    c_ms = timed(run_chain, st, gid, d_c)
    if not torch.equal(d_l, d_c):
        fail(f"{name} {key} group {gid}: differs from {chain} "
             f"(max {float((d_l - d_c).abs().max()):.3e})")
    if record:
        rec.add("cmp_ms", chain, key, c_ms)
        rec.add("cmp_bounds", chain, key, chunk_bounds(st.plan, st.one_d)[gid])
    return dict(drift=d_l, levels_ms=l_ms, chain_ms=c_ms,
                levels=int(st.lvl_rows[gid].shape[0] - 1))


def compare_group(st, gid: int, rec: Record, key: str) -> None:
    """Run group `gid` through each kernel and its plain version on the same
    inputs, check them, and continue from the kernel's state.  The chunk
    phase runs on the leveled kernel, which must equal the chain kernel
    strata_chunks_2d / _1d bit for bit."""
    p = st.plan
    args = (st.base, st.planes, st.od, st.eta, p["cpi"], gid * p["cgs"], p["cgs"])
    scale = float(st.base.abs().max()) + 1.0
    name, chain = LEVELS[st.one_d], CHAINS[st.one_d]
    lv = compare_levels(st, gid, rec, key)
    d_k = lv["drift"]
    line = dict(key=key, group=gid, chunk_ms=lv["levels_ms"], chain_chunk_ms=lv["chain_ms"],
                levels=lv["levels"])
    d_p = st.drift.clone()
    plain = strata_sgd.chunks_1d_plain if st.one_d else strata_sgd.chunks_2d_plain
    p_ms = timed(plain, d_p, *args)
    err = float((d_k - d_p).abs().max())
    for n in (name, chain):  # equal drift
        rec.add("err", n, key, err)
        rec.add("plain_ms", n, key, p_ms)
    if not err / scale <= CHUNK_TOL:
        fail(f"{name} group {gid}: max|drift delta|/scale {err / scale:.3e} > {CHUNK_TOL}")

    st.drift = d_k
    s_ms, sp_ms, b_ms, bp_ms = compare_merges(st, gid, rec, key)
    say("kernel_vs_plain", **line, chunk_plain_ms=p_ms, sum_ms=s_ms, sum_plain_ms=sp_ms,
        sum_block_eps=st.mi.block_eps, bcast_ms=b_ms, bcast_plain_ms=bp_ms)


def check_ordered_sum(st, c_k, u_k, label: str) -> None:
    """strata_merge_sum's output against merge_sum_ordered_plain on the
    same inputs: bit-equal, or fail."""
    c_o, u_o = st.coords.clone(), st.upd.clone()
    strata_sgd.merge_sum_ordered_plain(st.drift, st.mi, c_o, u_o)
    if not (torch.equal(c_k, c_o) and torch.equal(u_k, u_o)):
        fail(f"strata_merge_sum {label}: differs from merge_sum_ordered_plain "
             f"(max {float((u_k - u_o).abs().max()):.3e})")


def compare_merges(st, gid: int, rec: Record, key: str):
    """The CSR merges and their plain versions on the same inputs; continues
    from the kernels' state.  Returns the four times."""
    d_k = st.drift
    c_k, u_k = st.coords.clone(), st.upd.clone()
    c_p, u_p = st.coords.clone(), st.upd.clone()
    s_ms = timed(kernels.strata_merge_sum, d_k, st.mi, c_k, u_k)
    sp_ms = timed(strata_sgd.merge_sum_plain, d_k, st.mi, c_p, u_p)
    check_ordered_sum(st, c_k, u_k, f"{key} group {gid}")
    cscale = float(c_p.abs().max()) + 1.0
    err = max(float((c_k - c_p).abs().max()), float((u_k - u_p).abs().max()))
    rec.add("err", "strata_merge_sum", key, err)
    rec.add("plain_ms", "strata_merge_sum", key, sp_ms)
    rec.add("library_ms", "strata_merge_sum", key, library_merge_sum(st))
    if not err / cscale <= MERGE_TOL:
        fail(f"strata_merge_sum {key} group {gid}: max|delta|/scale {err / cscale:.3e} "
             f"> {MERGE_TOL}")

    d_k2, b_k, b_ms, bp_ms = compare_bcast(st, d_k, u_k, rec, key, f"group {gid}")
    st.drift, st.base, st.coords, st.upd = d_k2, b_k, c_k, u_k
    return s_ms, sp_ms, b_ms, bp_ms


def compare_bcast(st, drift, upd, rec: Record, key: str, label: str):
    """strata_merge_bcast and merge_bcast_plain on the state's base and
    `drift` with the update `upd`: the same base bit for bit and a zero
    drift, or fail.  Returns the kernel's drift and base and both times."""
    b_k, b_p = st.base.clone(), st.base.clone()
    d_k, d_p = drift.clone(), drift.clone()
    b_ms = timed(kernels.strata_merge_bcast, d_k, b_k, st.mi, upd)
    bp_ms = timed(strata_sgd.merge_bcast_plain, d_p, b_p, st.mi, upd)
    err = max(float((b_k - b_p).abs().max()), float(d_k.abs().max()))
    rec.add("err", "strata_merge_bcast", key, err)
    rec.add("plain_ms", "strata_merge_bcast", key, bp_ms)
    if not (torch.equal(b_k, b_p) and not d_k.any()):
        fail(f"strata_merge_bcast {key} {label}: differs from merge_bcast_plain "
             f"(max {err:.3e})")
    return d_k, b_k, b_ms, bp_ms


def warm_up(st) -> None:
    """One untimed call of every kernel and plain version of the state's
    route (and of the chain kernels) on copies, so that no timed call pays
    for first-use set-up."""
    p = st.plan
    args = (st.base, st.planes, st.od)
    tail = (st.eta, p["cpi"], 0, 1)
    plain = strata_sgd.chunks_1d_plain if st.one_d else strata_sgd.chunks_2d_plain
    chunks = kernels.strata_chunks_1d if st.one_d else kernels.strata_chunks_2d
    chunks(st.drift.clone(), *args, *tail)
    plain(st.drift.clone(), *args, *tail)
    getattr(kernels, LEVELS[st.one_d])(st.drift.clone(), *args, st.eta, p["cpi"], st.perm,
                                       st.lvl_rows[0][:2], st.pred_off, st.pred)
    for merge in (kernels.strata_merge_sum, strata_sgd.merge_sum_plain):
        merge(st.drift, st.mi, st.coords.clone(), st.upd.clone())
    for bcast in (kernels.strata_merge_bcast, strata_sgd.merge_bcast_plain):
        bcast(st.drift.clone(), st.base.clone(), st.mi, st.upd)
    if st.route == "xxl":
        kernels.strata_merge_sum_blocked(st.drift, st.mi, st.bsch, st.coords.clone(),
                                         st.upd.clone())
    torch.cuda.synchronize()


def phase_kernels(g, dev, rec: Record) -> None:
    st1 = strata_sgd.StrataState.build(
        g, derive_config_1d(g, iter_max=2), g.node_offset.astype(np.float32), True, dev)
    st2 = strata_sgd.StrataState.build(
        g, derive_config_2d(g, iter_max=2), ot.init_layout(g, "d"), False, dev)
    for st, key in ((st1, "smoke/1d"), (st2, "smoke/2d")):
        warm_up(st)
        for gid in range(st.plan["groups"]):
            compare_group(st, gid, rec, key)
        if not bool(torch.isfinite(st.coords).all()):
            fail(f"{key} coordinates not finite after the comparison run")
    torch.cuda.synchronize()
    say("kernels_vs_plain", **{n: dict(max_abs_err=max(x for v in rec.err[n].values()
                                                       for x in v))
                               for n in RESIDENT + (LEVELS_2D, LEVELS_1D)})


# ---------------------------------------------------------------------------
# Phase 5: the leveled, chain and blocked kernels of the XL and XXL routes
# against their plain versions
# ---------------------------------------------------------------------------


def compare_route_group(st, gid: int, rec: Record, key: str) -> None:
    """Group `gid` through the leveled chunk kernel, the chain kernel and
    the plain version on the same inputs; the leveled kernel must equal the
    chain kernel exactly and the plain one within CHUNK_TOL.  On the "xxl"
    route the blocked sum must equal the CSR sum exactly and its plain
    version within MERGE_TOL (the plain version on group 0 only), and the
    CSR sum must equal merge_sum_ordered_plain.  Continues from the
    kernels' state."""
    p = st.plan
    args = (st.base, st.planes, st.od, st.eta, p["cpi"], gid * p["cgs"], p["cgs"])
    scale = float(st.base.abs().max()) + 1.0
    name = LEVELS[st.one_d]
    plain = strata_sgd.chunks_1d_plain if st.one_d else strata_sgd.chunks_2d_plain
    lv = compare_levels(st, gid, rec, key, record=False)
    d_p = st.drift.clone()
    p_ms = timed(plain, d_p, *args)
    err = float((lv["drift"] - d_p).abs().max())
    for n in (name, CHAINS[st.one_d]):  # equal drift
        rec.add("err", n, key, err)
        rec.add("plain_ms", n, key, p_ms)
    if not err / scale <= CHUNK_TOL:
        fail(f"{name} {key} group {gid}: max|drift delta|/scale {err / scale:.3e} > {CHUNK_TOL}")
    line = dict(key=key, group=gid, levels_chunk_ms=lv["levels_ms"],
                chain_chunk_ms=lv["chain_ms"], chunk_plain_ms=p_ms, levels=lv["levels"],
                cgs=p["cgs"])
    st.drift = lv["drift"]

    if st.route != "xxl":  # the XL route merges with the CSR kernels
        ms = compare_merges(st, gid, rec, key)
        say("route_vs_plain", **line, **dict(zip(
            ("sum_ms", "sum_plain_ms", "bcast_ms", "bcast_plain_ms"), ms)))
        return

    c_b, u_b, c_k, u_k = (t.clone() for t in (st.coords, st.upd, st.coords, st.upd))
    line["sum_ms"] = timed(kernels.strata_merge_sum_blocked, st.drift, st.mi, st.bsch, c_b, u_b)
    line["resident_sum_ms"] = timed(kernels.strata_merge_sum, st.drift, st.mi, c_k, u_k)
    line["resident_sum_block_eps"] = st.mi.block_eps
    if not (torch.equal(c_b, c_k) and torch.equal(u_b, u_k)):
        fail(f"strata_merge_sum_blocked {key} group {gid}: differs from strata_merge_sum")
    cscale = float(c_k.abs().max()) + 1.0
    if gid == 0:
        check_ordered_sum(st, c_k, u_k, f"{key} group {gid}")
        c_p, u_p = st.coords.clone(), st.upd.clone()
        sp_ms = timed(strata_sgd.merge_sum_blocked_plain, st.drift, st.mi, st.bsch, c_p, u_p)
        err = max(float((c_b - c_p).abs().max()), float((u_b - u_p).abs().max()))
        rec.add("err", "strata_merge_sum_blocked", key, err)
        rec.add("plain_ms", "strata_merge_sum_blocked", key, sp_ms)
        line["sum_library_ms"] = library_merge_sum(st)
        rec.add("library_ms", "strata_merge_sum_blocked", key, line["sum_library_ms"])
        line["sum_plain_ms"] = sp_ms
        if not err / cscale <= MERGE_TOL:
            fail(f"strata_merge_sum_blocked {key}: max|delta|/scale {err / cscale:.3e} "
                 f"> {MERGE_TOL}")

    d_b, b_b, line["bcast_ms"], line["bcast_plain_ms"] = compare_bcast(
        st, st.drift, u_b, rec, key, f"group {gid}")
    line["replaced_bcast_ms"] = REPLACED_BCAST_MS[key.split("/")[1]]
    st.drift, st.base, st.coords, st.upd = d_b, b_b, c_b, u_b
    say("route_vs_plain", **line)


def phase_route_kernels(g, label: str, route: str, dev, rec: Record) -> None:
    for one_d in (True, False):
        key = f"{label}/{'1d' if one_d else '2d'}"
        if one_d:
            cfg = derive_config_1d(g, iter_max=2, min_term_updates=SHORT_TERMS)
            init = g.node_offset.astype(np.float32)
        else:
            cfg = derive_config_2d(g, iter_max=2, min_term_updates=SHORT_TERMS)
            init = ot.init_layout(g, "d")
        st = strata_sgd.StrataState.build(g, cfg, init, one_d, dev, route)
        warm_up(st)
        for gid in range(st.plan["groups"]):
            compare_route_group(st, gid, rec, key)
        if not bool(torch.isfinite(st.coords).all()):
            fail(f"{key} coordinates not finite after the comparison run")
        del st
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Counted paths: launch counts and per-launch times
# ---------------------------------------------------------------------------


class KernelTimes:
    """Wraps the kernel wrappers the strata runs call with CUDA events, per
    kernel and per 1D/2D shape; the launch counts stay the wrappers' own.
    Where the host paces the card, a launch's events can hold the wrapper's
    host time, so launch i of a kernel and shape with i % SPIN_EVERY ==
    SPIN_EVERY // 2 is queued behind a spin kernel, as `timed` does: its
    events hold the kernel alone (`spun`)."""

    def __init__(self, label: str):
        self.label = label
        self.events = {n: {"1d": [], "2d": []} for n in kernels.NAMES}
        self.spun = {n: {"1d": [], "2d": []} for n in kernels.NAMES}
        self.orig = {n: getattr(kernels, n) for n in kernels.SIGNATURES}

    def install(self) -> None:
        def wrap(wrapper, fn, shape_of):
            def timed_call(*a, **kw):
                # a leveled wrapper given dmax launches its tracking instance
                name = (kernels.TRACKED[wrapper] if kw.get("dmax") is not None
                        else wrapper)
                tag = shape_of(a)
                i = len(self.events[name][tag]) + len(self.spun[name][tag])
                spin = i % SPIN_EVERY == SPIN_EVERY // 2
                if spin:
                    torch.cuda._sleep(BUSY_CYCLES)
                t = Timer()
                fn(*a, **kw)
                (self.spun if spin else self.events)[name][tag].append(t.stop())
            return timed_call

        dim = {
            "strata_chunks_2d": lambda a: "2d",
            "strata_chunks_1d": lambda a: "1d",
            "strata_merge_sum": lambda a: "1d" if a[2].shape[0] == 1 else "2d",
            "strata_merge_bcast": lambda a: "1d" if a[3].shape[0] == 1 else "2d",
            "strata_merge_sum_blocked": lambda a: "1d" if a[3].shape[0] == 1 else "2d",
            LEVELS_2D: lambda a: "2d",
            LEVELS_1D: lambda a: "1d",
        }
        for n in kernels.SIGNATURES:
            setattr(kernels, n, wrap(n, self.orig[n], dim[n]))

    def uninstall(self) -> None:
        for n, fn in self.orig.items():
            setattr(kernels, n, fn)

    def into(self, rec: Record) -> dict:
        """Move the times into `rec` (the spun launches' into rec.spun);
        returns the device seconds per tag."""
        dev_s = {"1d": 0.0, "2d": 0.0}
        for n in kernels.NAMES:
            for tag in ("1d", "2d"):
                ms = [t.ms() for t in self.events[n][tag]]
                spun = [t.ms() for t in self.spun[n][tag]]
                if ms or spun:
                    rec.events[n][f"{self.label}/{tag}"] = ms
                    rec.spun[n][f"{self.label}/{tag}"] = spun
                    dev_s[tag] += (sum(ms) + sum(spun)) / 1e3
        return dev_s


def counted(label: str, rec: Record, fn, levels=("1d", "2d")):
    """Run `fn` with the launch counts set to 0 just before and read just
    after; per-launch times go to `rec`.  The chunk schedules the run
    builds (`levels`: one 1D plan for the sort, one 2D plan for the layout),
    and the host seconds they take, go to out["levels_1d"] /
    out["levels_2d"]."""
    times = KernelTimes(label)
    built = []
    build_schedule = strata_levels.chunk_schedule

    def timed_schedule(p):
        t0 = time.perf_counter()
        sched = build_schedule(p)
        built.append(("1d" if p["data"].one_d else "2d", time.perf_counter() - t0,
                      level_stats(p, sched[1], sched[2])))
        return sched

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times.install()
    strata_levels.chunk_schedule = timed_schedule
    try:
        out = fn()
    finally:
        times.uninstall()
        strata_levels.chunk_schedule = build_schedule
    torch.cuda.synchronize()
    tags = sorted(tag for tag, _, _ in built)
    if tags != sorted(levels):
        fail(f"{label}: level builds {tags}, expected {sorted(levels)}")
    for tag, seconds, stats in built:
        out[f"levels_{tag}"] = dict(seconds=seconds, **stats)
        say("levels", path=label, dim=tag, **out[f"levels_{tag}"])
    out["launches"] = dict(kernels.LAUNCHES)
    out["sgd_device_s"] = times.into(rec)
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    for n, c in out["launches"].items():
        if c:
            rec.launches[n][label] = c
    return out


def check_routes(out: dict, label: str, route: str, routes: dict, groups: dict) -> None:
    """The path took `route` in both dimensions: each of its kernels ran,
    no kernel of another route did, and each leveled kernel ran once a
    merge group of its plan (`groups` by "1d" / "2d")."""
    say("routes", path=label, routes=routes)
    if any(r != route for r in routes.values()):
        fail(f"{label}: routes {routes}, expected {route!r}")
    used = ROUTE_KERNELS[route]
    for n in kernels.NAMES:
        c = out["launches"][n]
        if n in used and c <= 0:
            fail(f"{label}: {n} was not launched on the {route} route")
        if n not in used and c != 0:
            fail(f"{label}: {n} was launched {c} times on the {route} route")
    for tag, n in (("1d", LEVELS_1D), ("2d", LEVELS_2D)):
        if out["launches"][n] != groups[tag]:
            fail(f"{label}: {n} launched {out['launches'][n]} times for {groups[tag]} groups")


def check_plan(g, tag: str, cfg, one_d: bool, host_s: dict) -> dict:
    t0 = time.perf_counter()
    p = strata_plan.plan_run(g, cfg, one_d=one_d)
    host_s[f"plan_run_{tag}"] = time.perf_counter() - t0
    want = PLAN_GATES[tag]
    got = dict(cpi=p["cpi"], total_valid=p["total_valid"])
    rows = p["data"].num_slots // strata_plan.LANE
    say("plan", dim=tag, cpi=p["cpi"], cgs=p["cgs"], groups=p["groups"],
        total_valid=p["total_valid"], rows=rows, twin=want)
    if got != want or rows != PLANE_ROWS:
        fail(f"{tag} plan {got} rows {rows} != twin {want} rows {PLANE_ROWS}")
    return p


def add_rates(out: dict, p1: dict, p2: dict, sort_key: str) -> None:
    dev = out["sgd_device_s"]
    out["valid_pair_updates_per_s_device"] = {
        "1d": p1["total_valid"] / dev["1d"], "2d": p2["total_valid"] / dev["2d"]}
    out["valid_pair_updates_per_s_wall"] = {
        f"1d_{sort_key}": p1["total_valid"] / out[f"{sort_key}_s"],
        "2d_layout": p2["total_valid"] / out["layout_s"]}


def lay_roundtrip(coords: np.ndarray, path: str, dev, out: dict) -> None:
    t0 = time.perf_counter()
    ot.save_layout(coords, path, device=dev)
    back = ot.load_layout(path)
    out["lay_roundtrip_s"] = time.perf_counter() - t0
    scale = float(np.abs(coords).max())
    err = float(np.abs(back - coords).max())
    say("lay_roundtrip", path=os.path.basename(path), max_abs_err=err, scale=scale,
        endpoints=int(coords.shape[0]))
    if back.shape != coords.shape or not err <= LAY_TOL * scale:
        fail(f".lay round trip error {err} > {LAY_TOL} x {scale}")


def add_bounds(rec: Record, label: str, g_1d, p1: dict, g_2d, p2: dict,
               route: str) -> None:
    """Bounds of every launch the path made, per kernel and dimension."""
    merges = ("strata_merge_sum_blocked" if route == "xxl" else "strata_merge_sum",
              "strata_merge_bcast")
    for (g, p, one_d, tag) in ((g_1d, p1, True, "1d"), (g_2d, p2, False, "2d")):
        key = f"{label}/{tag}"
        rec.bounds[LEVELS[one_d]][key] = chunk_bounds(p, one_d)
        rec.bounds[merges[0]][key] = [merge_sum_bound(g, one_d)]
        rec.bounds[merges[1]][key] = [merge_bcast_bound(g, p["data"].num_slots, one_d)]


def run_on_chain(fn, rec: Record, key: str, p: dict, one_d: bool = False):
    """Run `fn` with the chunk phase of `p`'s dimension forced onto the
    chain kernel strata_chunks_2d / _1d (the chunks each group's levels
    cover, in chain order); each chain launch's time and bound go to the
    comparison records under `key`.  `p` is the plan `fn` runs."""
    attr, chain_name = LEVELS[one_d], CHAINS[one_d]
    leveled = getattr(kernels, attr)
    bounds = chunk_bounds(p, one_d)
    launched = []

    def chain(drift, base, planes, od, eta, cpi, perm, lvl_off, pred_off, pred):
        off = lvl_off.cpu()
        g0, n = int(off[0]), int(off[-1] - off[0])
        if n != p["cgs"]:
            fail(f"{key}: a group of {n} chunks, the plan has {p['cgs']}")
        t = Timer()
        getattr(kernels, chain_name)(drift, base, planes, od, eta, cpi, g0, n)
        launched.append((t.stop(), bounds[g0 // n]))

    setattr(kernels, attr, chain)
    try:
        out = fn()
    finally:
        setattr(kernels, attr, leveled)
    if len(launched) != p["groups"]:
        fail(f"{key}: {len(launched)} chain launches for {p['groups']} groups")
    for t, b in launched:
        rec.add("cmp_ms", chain_name, key, t.ms())
        rec.add("cmp_bounds", chain_name, key, b)
    return out


# ---------------------------------------------------------------------------
# Phase 4: the smoke path (resident route)
# ---------------------------------------------------------------------------


def phase_smoke(gfa_path: str, tmp: str, dev, rec: Record) -> tuple:
    host_s = {}
    state = {}

    def run():
        out = {}
        t0 = time.perf_counter()
        g = ot.parse_gfa(gfa_path, device=dev)
        out["parse_s"] = sync_wall(t0)
        out["nt_before"] = ot.sum_of_path_node_distances(g, device=dev).all_nt_space
        p1 = check_plan(g, "1d", derive_config_1d(g), True, host_s)

        t0 = time.perf_counter()
        g2 = ot.sort_pipeline(g, "Ygs", device=dev)
        out["sort_Ygs_s"] = sync_wall(t0)
        out["nt_after"] = ot.sum_of_path_node_distances(g2, device=dev).all_nt_space
        p2 = check_plan(g2, "2d", derive_config_2d(g2), False, host_s)

        c0 = ot.init_layout(g2, "d")
        out["stress_before"] = ot.sum_of_path_node_distances(
            g2, (c0[:, 0], c0[:, 1]), device=dev).all_2d_by_nucleotides
        t0 = time.perf_counter()
        coords = ot.layout_graph(g2, device=dev)
        out["layout_s"] = sync_wall(t0)
        lay_roundtrip(coords, os.path.join(tmp, "smoke.lay"), dev, out)
        t0 = time.perf_counter()
        out["stress_after"] = ot.sum_of_path_node_distances(
            g2, (coords[:, 0], coords[:, 1]), device=dev).all_2d_by_nucleotides
        out["stress_s"] = sync_wall(t0)
        state.update(g=g, g2=g2, p1=p1, p2=p2, coords=coords)
        return out

    out = counted("smoke", rec, run)
    g, g2, p1, p2, coords = (state[k] for k in ("g", "g2", "p1", "p2", "coords"))
    routes = {"1d": strata_route.graph_route(g, derive_config_1d(g), True),
              "2d": strata_route.graph_route(g2, derive_config_2d(g2), False)}
    check_routes(out, "smoke", "resident", routes, {"1d": p1["groups"], "2d": p2["groups"]})
    # Host steps of the sort outside the SGD, timed alone on the sorted
    # graph (the same size as the graph the pipeline grooms and orders).
    for name, fn in (("groom", groom.apply_groom),
                     ("topological_order", topological.topological_order)):
        t0 = time.perf_counter()
        fn(g2)
        host_s[name] = time.perf_counter() - t0
    for tag in ("1d", "2d"):
        host_s[f"levels_{tag}"] = out[f"levels_{tag}"]["seconds"]
    out["host_s"] = host_s
    add_rates(out, p1, p2, "sort_Ygs")
    # the Y sort and the layout with their chunk phases on the chain
    # kernels: the same order and coordinates, bit for bit
    g_lv = ot.sort_pipeline(g, "Y", device=dev)
    t0 = time.perf_counter()
    g_ch = run_on_chain(lambda: ot.sort_pipeline(g, "Y", device=dev), rec, "smoke/1d", p1,
                        one_d=True)
    out["sort_Y_chain_s"] = sync_wall(t0)
    out["sort_Y_chain_equal"] = bool(np.array_equal(g_lv.node_id, g_ch.node_id)
                                     and np.array_equal(g_lv.step_handle, g_ch.step_handle))
    t0 = time.perf_counter()
    chain = run_on_chain(lambda: ot.layout_graph(g2, device=dev), rec, "smoke/2d", p2)
    out["layout_chain_s"] = sync_wall(t0)
    out["chain_equal"] = bool(np.array_equal(chain, coords))
    say("main_path", path="smoke", **out, twin=TWIN)
    if not out["sort_Y_chain_equal"]:
        fail("smoke Y sort differs from the same sort on the chain kernel")
    if not out["chain_equal"]:
        fail(f"smoke layout differs from the chain kernel's (max {np.abs(chain - coords).max()})")

    if not np.isfinite(coords).all():
        fail("layout coordinates not finite")
    if not out["nt_after"] <= NT_AFTER_MAX:
        fail(f"nt-distance after Ygs {out['nt_after']} > {NT_AFTER_MAX}")
    if not out["stress_after"] <= STRESS_AFTER_MAX:
        fail(f"stress after layout {out['stress_after']} > {STRESS_AFTER_MAX}")
    add_bounds(rec, "smoke", g, p1, g2, p2, "resident")
    return out, g2, dict(g=g, g_Y=g_lv, g2=g2, coords=coords, p1=p1, p2=p2)


# ---------------------------------------------------------------------------
# Phase 4b: the PG-SGD options on the smoke graph (delta, -H, -u, -f) and the
# batched path on a graph under 1,024 steps
# ---------------------------------------------------------------------------


def compare_tracked(st, gid: int, rec: Record, key: str) -> dict:
    """Group `gid` through the leveled kernel, its tracking instance and the
    plain version with dmax, on the same inputs: the tracking drift equals
    the untracked kernel's bit for bit, its Delta_max word the plain
    version's bit for bit, and its drift the plain one's within CHUNK_TOL.
    Untracked and tracked launches are timed in turns (u, t, t, u).
    Continues from the tracked state."""
    one_d, p = st.one_d, st.plan
    fn, track = getattr(kernels, LEVELS[one_d]), TRACKS[one_d]
    plain = strata_sgd.chunks_1d_levels_plain if one_d else strata_sgd.chunks_2d_levels_plain
    plain_args = (st.base, st.planes, st.od, st.eta, p["cpi"], st.perm, st.lvl_rows[gid])
    args = plain_args + (st.pred_off, st.pred)
    drifts = [st.drift.clone() for _ in range(5)]
    words = [torch.zeros(1, dtype=torch.float32, device=st.drift.device) for _ in range(3)]
    u_ms = [timed(fn, drifts[0], *args)]
    t_ms = [timed(lambda: fn(drifts[1], *args, dmax=words[0]))]
    t_ms.append(timed(lambda: fn(drifts[2], *args, dmax=words[1])))
    u_ms.append(timed(fn, drifts[3], *args))
    p_ms = timed(lambda: plain(drifts[4], *plain_args, dmax=words[2]))
    for d in drifts[1:4]:
        if not torch.equal(d, drifts[0]):
            fail(f"{track} {key} group {gid}: drift differs from the untracked kernel's")
    for w in words[:2]:
        if not torch.equal(w, words[2]):
            fail(f"{track} {key} group {gid}: Delta_max {float(w)!r} != plain "
                 f"{float(words[2])!r}")
    scale = float(st.base.abs().max()) + 1.0
    err = max(float((drifts[1] - drifts[4]).abs().max()), float((words[0] - words[2]).abs().max()))
    rec.add("err", track, key, err)
    rec.add("plain_ms", track, key, p_ms)
    if not err / scale <= CHUNK_TOL:
        fail(f"{track} {key} group {gid}: max|drift delta|/scale {err / scale:.3e} > {CHUNK_TOL}")
    st.drift = drifts[1]
    kernels.strata_merge_sum(st.drift, st.mi, st.coords, st.upd)
    kernels.strata_merge_bcast(st.drift, st.base, st.mi, st.upd)
    return dict(key=key, group=gid, levels=int(st.lvl_rows[gid].shape[0] - 1),
                untracked_ms=u_ms, tracked_ms=t_ms, plain_ms=p_ms, delta_max=float(words[0]))


def borrow_times(rec: Record, src: str, dst: str) -> None:
    """Plain and library times of path `src` as those of path `dst`: the
    same graph, plans and kernels."""
    for n in kernels.NAMES:
        for table in (rec.plain_ms, rec.library_ms):
            for tag in ("1d", "2d"):
                if f"{src}/{tag}" in table[n]:
                    table[n][f"{dst}/{tag}"] = list(table[n][f"{src}/{tag}"])


def add_track_bounds(rec: Record, label: str, p1: dict, p2: dict) -> None:
    """Bounds of a tracked path: the untracked kernels' (add_bounds) and,
    for the tracking instances, the leveled kernel's plus one f32 word a
    group."""
    for p, one_d, tag in ((p1, True, "1d"), (p2, False, "2d")):
        rec.bounds[TRACKS[one_d]][f"{label}/{tag}"] = [
            dict(b, bytes=b["bytes"] + 4) for b in chunk_bounds(p, one_d)]


def interior_stop(dm: list, lo: int) -> int:
    """The first iteration k >= lo, before the last, whose Delta_max lies
    STOP_MARGIN (relative) below every earlier one's: no f32 noise moves a
    stop there."""
    for k in range(lo, len(dm) - 1):
        if all(dm[k] <= (1 - STOP_MARGIN) * v for v in dm[:k]):
            return k
    fail(f"no interior stop iteration in {dm}")


def by_hand(g, cfg, init, one_d: bool, iterations: int, dev) -> np.ndarray:
    """The untracked resident state of (g, cfg) after `iterations`
    iterations, its merge groups run one by one: X (N,) or (2N, 2) f64."""
    st = strata_sgd.StrataState.build(g, cfg, init, one_d, dev)
    for gid in range(iterations * st.merges_per_iteration()):
        st.run_group(gid)
    return (st.coords[0] if one_d else st.coords.T).cpu().numpy()


def delta_runs(label: str, g, g2, d1: float, d2: float, dev, rec: Record) -> tuple:
    """sort_pipeline("Y") of `g` and layout_graph of `g2` with delta d1 /
    d2, counted: (out, Y-sorted graph, packed coordinates)."""
    state = {}

    def run():
        out = {}
        t0 = time.perf_counter()
        gy = ot.sort_pipeline(g, "Y", sgd_overrides=dict(delta=d1), device=dev)
        out["sort_Y_s"] = sync_wall(t0)
        out["sort"] = dict(sgd.LAST_RUN)
        t0 = time.perf_counter()
        c = ot.layout_graph(g2, derive_config_2d(g2, delta=d2), device=dev)
        out["layout_s"] = sync_wall(t0)
        out["layout"] = dict(sgd.LAST_RUN)
        state.update(gy=gy, c=c)
        return out

    out = counted(label, rec, run)
    for what in ("sort", "layout"):
        if out[what]["route"] != "resident":
            fail(f"{label} {what}: route {out[what]['route']}, expected resident")
    return out, state["gy"], state["c"]


def check_delta_launches(out: dict, label: str, groups: dict) -> None:
    """A tracked path launched the tracking instances once a group it ran
    and never the untracked leveled kernels."""
    for one_d, tag in ((True, "1d"), (False, "2d")):
        want = groups[tag]
        if out["launches"][TRACKS[one_d]] != want or out["launches"][LEVELS[one_d]] != 0:
            fail(f"{label}: {TRACKS[one_d]} {out['launches'][TRACKS[one_d]]} / "
                 f"{LEVELS[one_d]} {out['launches'][LEVELS[one_d]]} launches for {want} groups")


def same_graph(a, b) -> bool:
    return bool(np.array_equal(a.node_id, b.node_id)
                and np.array_equal(a.step_handle, b.step_handle))


def same_fields(a, b) -> bool:
    """Every field of two graphs equal, dtypes included."""
    return all(a.path_names == b.path_names if k == "path_names" else
               getattr(a, k).dtype == getattr(b, k).dtype
               and np.array_equal(getattr(a, k), getattr(b, k)) for k in FIELDS)


def batch_profile(g, dev) -> dict:
    """One 2D batch of the batched path on `g` at its default batch:
    device ms behind a spin kernel, and the CUDA events of a batch
    (``repeat_events`` over three batches; None where its readings
    disagree)."""
    cfg = derive_config_2d(g)
    data = batched_sgd.SgdData.build(g, cfg.theta, cfg.space, cfg.space_max,
                                     cfg.space_quantization_step, device=dev)
    x = torch.as_tensor(ot.init_layout(g, "d").astype(np.float32), device=dev)
    gen = batched_sgd.make_generator(cfg, dev)
    eta = torch.tensor(np.float32(10.0), device=dev)

    def one_batch():
        pairs, _ = batched_sgd.sample_pairs(batched_sgd.draw_words(gen, cfg.batch_size, dev), 0,
                                            data, cfg, False)
        return batched_sgd.update_2d(x, pairs, eta)

    one_batch()
    ms = [timed(one_batch) for _ in range(5)]
    prof = repeat_events(lambda: [one_batch() for _ in range(3)], 3)
    return dict(batch_size=cfg.batch_size, batch_ms=sum(ms) / len(ms), batch_ms_all=ms,
                kernels_per_batch=prof["kernels"], batch_events=prof)


def phase_options(smoke: dict, sm: dict, tmp: str, dev, rec: Record) -> dict:
    g, g_Y, g2, coords4, p1, p2 = (sm[k] for k in ("g", "g_Y", "g2", "coords", "p1", "p2"))
    cfg1, cfg2 = derive_config_1d(g), derive_config_2d(g2)
    groups = {"1d": p1["groups"], "2d": p2["groups"]}

    # the tracking instances against the untracked kernels and their
    # plain versions on the first groups of the smoke plans
    for one_d, gr, cfg, init in ((True, g, cfg1, g.node_offset.astype(np.float32)),
                                 (False, g2, cfg2, ot.init_layout(g2, "d"))):
        st = strata_sgd.StrataState.build(gr, cfg, init, one_d, dev)
        warm_up(st)
        getattr(kernels, LEVELS[one_d])(st.drift.clone(), st.base, st.planes, st.od, st.eta,
                                        st.plan["cpi"], st.perm, st.lvl_rows[0][:2],
                                        st.pred_off, st.pred, dmax=st.dmax[:1].clone())
        for gid in range(FULL_GROUPS):
            say("tracked_vs_untracked",
                **compare_tracked(st, gid, rec, f"smoke/{'1d' if one_d else '2d'}"))
        del st

    # walls with and without the per-iteration host read (uncounted), in
    # turns: untracked, tracked, tracked, untracked
    walls = {"sort_Y": {"untracked": [], "tracked": []},
             "layout": {"untracked": [], "tracked": []}}
    for kind in ("untracked", "tracked", "tracked", "untracked"):
        d = 1e-30 if kind == "tracked" else 0.0
        t0 = time.perf_counter()
        ot.sort_pipeline(g, "Y", sgd_overrides=dict(delta=d), device=dev)
        walls["sort_Y"][kind].append(sync_wall(t0))
        t0 = time.perf_counter()
        ot.layout_graph(g2, derive_config_2d(g2, delta=d), device=dev)
        walls["layout"][kind].append(sync_wall(t0))
    say("delta_walls", **walls)

    # delta 1e-30: never stops; the phase-4 order and coordinates
    out, gy, c = delta_runs("opt-tiny", g, g2, 1e-30, 1e-30, dev, rec)
    check_delta_launches(out, "opt-tiny", groups)
    dm1, dm2 = out["sort"]["delta_max"], out["layout"]["delta_max"]
    out["equal_to_phase4"] = dict(sort_Y=same_graph(gy, g_Y),
                                  layout=bool(np.array_equal(c, coords4)))
    say("main_path", path="opt-tiny", **out)
    if len(dm1) != cfg1.iter_max or len(dm2) != cfg2.iter_max:
        fail(f"opt-tiny: {len(dm1)} / {len(dm2)} iterations, expected all")
    if not all(out["equal_to_phase4"].values()):
        fail(f"opt-tiny: differs from the untracked runs of phase 4 {out['equal_to_phase4']}")
    add_bounds(rec, "opt-tiny", g, p1, g2, p2, "resident")
    add_track_bounds(rec, "opt-tiny", p1, p2)
    borrow_times(rec, "smoke", "opt-tiny")

    # an interior delta from the recorded values: the predicted stop, and
    # the untracked state after that iteration, run group by group
    k1, k2 = interior_stop(dm1, cfg1.iter_max // 2), interior_stop(dm2, cfg2.iter_max // 2)
    d1, d2 = dm1[k1] * (1 + STOP_MARGIN / 5), dm2[k2] * (1 + STOP_MARGIN / 5)
    out, gy, c = delta_runs("opt-stop", g, g2, d1, d2, dev, rec)
    mpi1, mpi2 = p1["cpi"] // p1["cgs"], p2["cpi"] // p2["cgs"]
    check_delta_launches(out, "opt-stop", {"1d": (k1 + 1) * mpi1, "2d": (k2 + 1) * mpi2})
    x_hand = by_hand(g, cfg1, g.node_offset.astype(np.float32), True, k1 + 1, dev)
    c_hand = by_hand(g2, cfg2, ot.init_layout(g2, "d"), False, k2 + 1, dev)
    out["predicted"] = dict(sort=dict(iteration=k1 + 1, delta=d1),
                            layout=dict(iteration=k2 + 1, delta=d2))
    out["equal_to_by_hand"] = dict(
        sort_Y=same_graph(gy, g.apply_ordering(path_sgd_sort.order_from_x(g, x_hand),
                                               compact_ids=True)),
        layout=bool(np.array_equal(c, layout.pack_components(g2, c_hand))))
    out["nt_after_Y"] = ot.sum_of_path_node_distances(gy, device=dev).all_nt_space
    out["stress_after"] = ot.sum_of_path_node_distances(
        g2, (c[:, 0], c[:, 1]), device=dev).all_2d_by_nucleotides
    say("main_path", path="opt-stop", **out)
    if (out["sort"]["iterations"], out["layout"]["iterations"]) != (k1 + 1, k2 + 1):
        fail(f"opt-stop: stopped after {out['sort']['iterations']} / "
             f"{out['layout']['iterations']} iterations, predicted {k1 + 1} / {k2 + 1}")
    if out["sort"]["delta_max"] != dm1[:k1 + 1] or out["layout"]["delta_max"] != dm2[:k2 + 1]:
        fail("opt-stop: Delta_max values differ from the 1e-30 run's")
    if not all(out["equal_to_by_hand"].values()):
        fail(f"opt-stop: differs from the state run by hand {out['equal_to_by_hand']}")
    add_bounds(rec, "opt-stop", g, p1, g2, p2, "resident")
    add_track_bounds(rec, "opt-stop", p1, p2)
    borrow_times(rec, "smoke", "opt-stop")

    # -H: pin path 0's nodes (the batched path)
    state = {}

    def run_pin():
        orig = path_sgd_sort.path_sgd_1d

        def capture(*a, **kw):
            state["x"] = orig(*a, **kw)
            return state["x"]

        path_sgd_sort.path_sgd_1d = capture
        try:
            t0 = time.perf_counter()
            state["gp"] = ot.sort_pipeline(g, "Y", target_paths=[0], device=dev)
            out = dict(sort_Y_s=sync_wall(t0), sort=dict(sgd.LAST_RUN))
        finally:
            path_sgd_sort.path_sgd_1d = orig
        return out

    out = counted("opt-pin", rec, run_pin, levels=())
    pin = path_sgd_sort.target_pin_mask(g, [0])
    x, x0 = state["x"].cpu().numpy(), g.node_offset.astype(np.float32).astype(np.float64)
    out.update(pinned=int(pin.sum()), nodes=g.num_nodes, nt_before=smoke["nt_before"],
               nt_after=ot.sum_of_path_node_distances(state["gp"], device=dev).all_nt_space,
               pinned_unchanged=bool(np.array_equal(x[pin], x0[pin])),
               free_moved=bool((x[~pin] != x0[~pin]).any()),
               batches=out["sort"]["iterations"] * cfg1.num_batches)
    out["wall_ms_per_batch"] = out["sort_Y_s"] * 1e3 / out["batches"]
    say("main_path", path="opt-pin", **out)
    if out["sort"]["route"] != "batched" or any(out["launches"].values()):
        fail(f"opt-pin: route {out['sort']['route']}, launches {out['launches']}")
    if not (out["pinned_unchanged"] and out["free_moved"]):
        fail("opt-pin: pinned positions moved or no free node moved")
    if not out["nt_after"] < out["nt_before"]:
        fail(f"opt-pin: nt-distance {out['nt_after']} not below its start {out['nt_before']}")

    # -u: a .lay snapshot an iteration (the batched path)
    snap_s = []

    def snapshot(it, coords):
        t0 = time.perf_counter()
        ot.save_layout(coords, os.path.join(tmp, f"snap{it + 1}.lay"), device=dev)
        snap_s.append(time.perf_counter() - t0)

    def run_snap():
        t0 = time.perf_counter()
        c = ot.layout_graph(g2, snapshot_cb=snapshot, device=dev)
        state["c"] = c
        return dict(layout_s=sync_wall(t0), layout=dict(sgd.LAST_RUN))

    out = counted("opt-snap", rec, run_snap, levels=())
    files = sorted(f for f in os.listdir(tmp) if f.startswith("snap") and f.endswith(".lay"))
    last = ot.load_layout(os.path.join(tmp, f"snap{cfg2.iter_max}.lay"))
    c = state["c"]
    scale = float(np.abs(c).max())
    c0 = ot.init_layout(g2, "d")
    out.update(snapshots=len(files), snapshot_s=sum(snap_s),
               last_snapshot_err=float(np.abs(layout.pack_components(g2, last) - c).max()),
               scale=scale, stress_before=smoke["stress_before"],
               stress_after=ot.sum_of_path_node_distances(
                   g2, (c[:, 0], c[:, 1]), device=dev).all_2d_by_nucleotides,
               batches=out["layout"]["iterations"] * cfg2.num_batches)
    out["wall_ms_per_batch"] = (out["layout_s"] - out["snapshot_s"]) * 1e3 / out["batches"]
    # the same batched layout without the snapshots' host reads (uncounted)
    t0 = time.perf_counter()
    batched_sgd.path_sgd_2d_batched(g2, c0, cfg2, device=dev)
    out["without_snapshots_s"] = sync_wall(t0)
    snap = dict(snap_stress=out["stress_after"], snap_without_snapshots_s=out["without_snapshots_s"])
    say("main_path", path="opt-snap", **out)
    if out["layout"]["route"] != "batched" or any(out["launches"].values()):
        fail(f"opt-snap: route {out['layout']['route']}, launches {out['launches']}")
    if len(files) != SNAPSHOTS or len(snap_s) != SNAPSHOTS:
        fail(f"opt-snap: {len(files)} .lay snapshots, expected {SNAPSHOTS}")
    if not (np.isfinite(c).all() and out["last_snapshot_err"] <= LAY_TOL * scale):
        fail(f"opt-snap: last snapshot {out['last_snapshot_err']} off the result")
    if not out["stress_after"] < out["stress_before"]:
        fail(f"opt-snap: stress {out['stress_after']} not below {out['stress_before']}")

    # -f: a layout of half the paths (the resident route on the kept graph)
    use = list(range(0, g2.num_paths, 2))
    kept = g2.keep_paths(use)

    def run_subset():
        t0 = time.perf_counter()
        state["c"] = ot.layout_graph(g2, use_paths=use, device=dev)
        return dict(layout_s=sync_wall(t0), layout=dict(sgd.LAST_RUN))

    out = counted("opt-subset", rec, run_subset, levels=("2d",))
    p_sub = strata_plan.plan_run(kept, cfg2, one_d=False)
    c = state["c"]
    direct = layout.pack_components(g2, strata_sgd.path_sgd_2d_strata(
        kept, ot.init_layout(g2, "d"), cfg2, dev).cpu().numpy())
    out.update(paths=len(use), steps=kept.num_steps, groups=p_sub["groups"],
               equal_to_kept_graph_run=bool(np.array_equal(c, direct)),
               stress_kept_after=ot.sum_of_path_node_distances(
                   kept, (c[:, 0], c[:, 1]), device=dev).all_2d_by_nucleotides,
               stress_kept_before=ot.sum_of_path_node_distances(
                   kept, (c0[:, 0], c0[:, 1]), device=dev).all_2d_by_nucleotides)
    say("main_path", path="opt-subset", **out)
    if out["layout"]["route"] != "resident" or out["launches"][LEVELS_2D] != p_sub["groups"]:
        fail(f"opt-subset: route {out['layout']['route']}, launches {out['launches']}")
    if not out["equal_to_kept_graph_run"]:
        fail("opt-subset: differs from the same run on the kept paths' graph")
    if not out["stress_kept_after"] < out["stress_kept_before"]:
        fail(f"opt-subset: stress on the kept paths {out['stress_kept_after']} not below "
             f"{out['stress_kept_before']}")
    st = strata_sgd.StrataState.build(kept, cfg2, c0, False, dev)
    warm_up(st)
    compare_group(st, 0, rec, "opt-subset/2d")
    del st
    rec.bounds[LEVELS_2D]["opt-subset/2d"] = chunk_bounds(p_sub, False)
    rec.bounds["strata_merge_sum"]["opt-subset/2d"] = [merge_sum_bound(kept, False)]
    rec.bounds["strata_merge_bcast"]["opt-subset/2d"] = [
        merge_bcast_bound(kept, p_sub["data"].num_slots, False)]

    # a graph under 1,024 steps: the batched path in 1D and 2D
    gs = shuffled_graph(*SMALL)

    def run_small():
        out = dict(nt_before=ot.sum_of_path_node_distances(gs, device=dev).all_nt_space)
        t0 = time.perf_counter()
        gsy = ot.sort_pipeline(gs, "Y", device=dev)
        out["sort_Y_s"] = sync_wall(t0)
        out["sort"] = dict(sgd.LAST_RUN)
        out["nt_after"] = ot.sum_of_path_node_distances(gsy, device=dev).all_nt_space
        c0s = ot.init_layout(gsy, "d")
        out["stress_before"] = ot.sum_of_path_node_distances(
            gsy, (c0s[:, 0], c0s[:, 1]), device=dev).all_2d_by_nucleotides
        t0 = time.perf_counter()
        cs = ot.layout_graph(gsy, device=dev)
        out["layout_s"] = sync_wall(t0)
        out["layout"] = dict(sgd.LAST_RUN)
        out["stress_after"] = ot.sum_of_path_node_distances(
            gsy, (cs[:, 0], cs[:, 1]), device=dev).all_2d_by_nucleotides
        out["finite"] = bool(np.isfinite(cs).all())
        return out

    out = counted("opt-small", rec, run_small, levels=())
    out.update(steps=gs.num_steps, nodes=gs.num_nodes,
               batches=dict(sort=out["sort"]["iterations"] * derive_config_1d(gs).num_batches,
                            layout=out["layout"]["iterations"] * derive_config_2d(gs).num_batches))
    say("main_path", path="opt-small", **out)
    if (out["sort"]["route"], out["layout"]["route"]) != ("batched", "batched") \
            or any(out["launches"].values()):
        fail(f"opt-small: routes {out['sort']['route']} / {out['layout']['route']}")
    if not (out["finite"] and out["nt_after"] < out["nt_before"]
            and out["stress_after"] < out["stress_before"]):
        fail(f"opt-small: quality did not improve {out}")

    say("batched_batch", graph="smoke-sorted", **batch_profile(g2, dev))
    return snap


# ---------------------------------------------------------------------------
# Phase 4c: the command line on the smoke graph
# ---------------------------------------------------------------------------


class CliIO:
    """Times the graph reads and writes and the PG-SGD runs the command
    line makes (wrapping the names its module calls) and keeps each graph
    by path: the graphs a save was given and those a load returned."""

    NAMES = ("parse_gfa", "save_og", "load_og", "save_graph", "load_graph",
             "sort_pipeline", "layout_graph")

    def __init__(self):
        self.seconds = {n: [] for n in self.NAMES}
        self.saved, self.loaded = {}, {}
        self.orig = {n: getattr(cli_main, n) for n in self.NAMES}

    def __enter__(self):
        def wrap(name, fn):
            def call(*a, **kw):
                t0 = time.perf_counter()
                g = fn(*a, **kw)
                self.seconds[name].append(sync_wall(t0))
                if name.startswith("save_"):
                    self.saved[a[1]] = a[0]
                elif name.startswith("load_"):
                    self.loaded[a[0]] = g
                return g
            return call

        for n, fn in self.orig.items():
            setattr(cli_main, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(cli_main, n, fn)


def cli(argv: list, walls: dict, rc_want: int = 0) -> tuple:
    """One command through odgi_tpu_torch.cli.main on the card (device
    None, as `python -m odgi_tpu_torch.cli` runs it); its wall goes to
    `walls`.  Returns its stdout and stderr; fails unless it exits with
    `rc_want`."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main.main(argv)
    walls.setdefault(argv[0], []).append(sync_wall(t0))
    if rc != rc_want:
        fail(f"cli {' '.join(argv)}: exit {rc}: {err.getvalue()[-2000:]}")
    return out.getvalue(), err.getvalue()


def missing_edges(g) -> int:
    """Consecutive step pairs that no edge joins, in either direction of
    the bidirected edge: what `validate` must report, counted with numpy."""
    n2 = 2 * g.num_nodes
    is_last = np.zeros(g.num_steps, dtype=bool)
    is_last[g.path_offset[1:] - 1] = True
    a = g.step_handle[:-1][~is_last[:-1]]
    b = g.step_handle[1:][~is_last[:-1]]
    edges = np.concatenate([g.edge_from * n2 + g.edge_to,
                            (g.edge_to ^ 1) * n2 + (g.edge_from ^ 1)])
    return int((~np.isin(a * n2 + b, edges)).sum())


def trace_spans(trace_dir: str) -> dict:
    """From the torch.profiler trace in `trace_dir`: its CUDA kernels (the
    spin kernels KernelTimes queues counted apart) and the program's spans
    by name (``utils/metrics.py``).  A trace without a kernel, or without
    the program's ``strata.build`` and ``strata.run``, fails."""
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(files) != 1:
        fail(f"{trace_dir}: {len(files)} traces")
    with open(files[0]) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    kern = [e for e in events if e.get("cat") == "kernel"]
    spin = sum("spin" in e.get("name", "").lower() for e in kern)
    if len(kern) == spin:
        fail(f"{trace_dir}: the --profile trace holds no CUDA kernel")
    spans = collections.Counter(e["name"] for e in events if e.get("cat") == "user_annotation")
    missing = [n for n in ("strata.build", "strata.run") if not spans[n]]
    if missing:
        fail(f"{trace_dir}: the --profile trace lacks the program's spans {missing}")
    return dict(trace_bytes=os.path.getsize(files[0]), events=len(events),
                kernels=len(kern) - spin, spin_kernels=spin, spans=dict(spans))


def read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def stats_all_paths(text: str, column: int) -> str:
    """Column `column` of the all_paths row that `stats` printed."""
    rows = [ln.split("\t") for ln in text.splitlines() if ln.startswith("all_paths\t")]
    if len(rows) != 1:
        fail(f"stats printed {len(rows)} all_paths rows:\n{text}")
    return rows[0][column]


def phase_cli(gfa_path: str, tmp: str, smoke: dict, sm: dict, dev, rec: Record) -> None:
    """build -> validate -> sort -p Ygs (--metrics, --profile) -> layout
    (--profile) -> stats -S -s and stats -s -c through the command line,
    on phase 4's GFA: the native parser, and the order, coordinates and
    printed stats of phase 4; then layout --metrics on the small graph."""
    g4, coords4, p1, p2 = sm["g2"], sm["coords"], sm["p1"], sm["p2"]
    out = {}
    # the two parsers on the same file, and the .otg container
    t0 = time.perf_counter()
    g_nat = ot.parse_gfa(gfa_path, device=dev)
    out["parse_native_s"] = time.perf_counter() - t0
    out["parser"] = gfa_io.LAST_PARSER["name"]
    if out["parser"] != "native":
        fail(f"cli: the native GFA parser did not run: {native.build_error()}")
    with open(gfa_path, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    g_py = ot.parse_gfa(data, device=dev)
    out["parse_python_s"] = time.perf_counter() - t0
    out["native_equals_python"] = same_fields(g_nat, g_py)
    otg = os.path.join(tmp, "smoke.otg")
    t0 = time.perf_counter()
    og_io.save_graph(g_nat, otg)
    out["otg_write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = og_io.load_graph(otg)
    out["otg_read_s"] = time.perf_counter() - t0
    out["otg_bytes"] = os.path.getsize(otg)
    out["otg_equal"] = same_fields(back, g_nat)
    del g_py, back
    if not (out["native_equals_python"] and out["otg_equal"]):
        fail(f"cli: native parse == Python {out['native_equals_python']}, "
             f".otg round trip {out['otg_equal']}")

    # One .og of the smoke graph, its write timed: a read takes minutes on
    # the card's host (a Python loop a path position; PERF.md §5), so the
    # chain runs through .otg.
    f = {k: os.path.join(tmp, f"cli.{k}") for k in ("og", "otg", "lay", "jsonl")}
    f.update(sorted=os.path.join(tmp, "cli-sorted.otg"),
             trace_sort=os.path.join(tmp, "trace-sort"),
             trace_layout=os.path.join(tmp, "trace-layout"))
    walls, printed = {}, {}
    with CliIO() as gio:
        def run():
            gfa_io.LAST_PARSER["name"] = None
            cli(["build", "-g", gfa_path, "-o", f["og"]], walls)
            parser = gfa_io.LAST_PARSER["name"]
            cli(["build", "-g", gfa_path, "-o", f["otg"]], walls)
            # the generator stores each edge as (min, max) of its handles, so
            # some path steps lack their edge: validate reports each one
            missing = missing_edges(sm["g"])
            _, problems = cli(["validate", "-i", f["otg"]], walls, 1 if missing else 0)
            cli(["sort", "-i", f["otg"], "-o", f["sorted"], "-p", "Ygs",
                 "--metrics", f["jsonl"], "--profile", f["trace_sort"]], walls)
            cli(["layout", "-i", f["sorted"], "-o", f["lay"], "--profile", f["trace_layout"]],
                walls)
            printed["S_s"] = cli(["stats", "-i", f["sorted"], "-S", "-s"], walls)[0]
            printed["s_c"] = cli(["stats", "-i", f["sorted"], "-s", "-c", f["lay"]], walls)[0]
            return dict(build_parser=parser, validate_problems=len(problems.splitlines()),
                        missing_edges=missing)

        out.update(counted("cli", rec, run))
    routes = {"1d": strata_route.graph_route(sm["g"], derive_config_1d(sm["g"]), True),
              "2d": strata_route.graph_route(g4, derive_config_2d(g4), False)}
    check_routes(out, "cli", "resident", routes, {"1d": p1["groups"], "2d": p2["groups"]})
    out["walls_s"] = walls
    out["timed_s"] = gio.seconds
    out["file_bytes"] = {k: os.path.getsize(f[k]) for k in ("og", "otg", "sorted", "lay")}
    sorted_g = gio.saved.get(f["sorted"])
    out["sorted_equal_phase4"] = sorted_g is not None and same_graph(sorted_g, g4)
    out["sorted_reads_back"] = same_graph(gio.loaded[f["sorted"]], g4)
    with open(f["lay"], "rb") as a, open(os.path.join(tmp, "smoke.lay"), "rb") as b:
        out["lay_bytes_equal_phase4"] = a.read() == b.read()
    lay = ot.load_layout(f["lay"])
    out["lay_max_abs_err_phase4"] = float(np.abs(lay - coords4).max())
    out["nt_printed"] = stats_all_paths(printed["S_s"], 2)
    out["stress_printed"] = stats_all_paths(printed["s_c"], 2)
    want = {"nt": f"{smoke['nt_after']:.6g}", "stress": f"{smoke['stress_after']:.6g}"}
    out["metrics"] = read_jsonl(f["jsonl"])
    out["trace"] = {k: trace_spans(f[f"trace_{k}"]) for k in ("sort", "layout")}
    dev_s = smoke["sgd_device_s"]
    sgd_walls = dict(sort=gio.seconds["sort_pipeline"][0], layout=gio.seconds["layout_graph"][0])
    out["idle_share_event_sums"] = dict(
        phase4=dict(sort=1 - dev_s["1d"] / smoke["sort_Ygs_s"],
                    layout=1 - dev_s["2d"] / smoke["layout_s"]),
        cli_profiled=dict(sort=1 - out["sgd_device_s"]["1d"] / sgd_walls["sort"],
                          layout=1 - out["sgd_device_s"]["2d"] / sgd_walls["layout"]))
    out["phase4_walls_s"] = dict(sort_Ygs=smoke["sort_Ygs_s"], layout=smoke["layout_s"],
                                 parse=smoke["parse_s"])
    say("main_path", path="cli", **out, printed=printed, phase4_printed=want)
    if out["build_parser"] != "native":
        fail(f"cli build: parser {out['build_parser']}, expected native")
    if out["validate_problems"] != out["missing_edges"]:
        fail(f"cli validate: {out['validate_problems']} problems, "
             f"{out['missing_edges']} steps without their edge")
    if not (out["sorted_equal_phase4"] and out["sorted_reads_back"]):
        fail("cli sort: the sorted graph differs from phase 4's sort_pipeline('Ygs')")
    if not out["lay_bytes_equal_phase4"]:
        fail(f"cli layout: .lay differs from phase 4's (max {out['lay_max_abs_err_phase4']})")
    if (out["nt_printed"], out["stress_printed"]) != (want["nt"], want["stress"]):
        fail(f"cli stats printed nt {out['nt_printed']} stress {out['stress_printed']}, "
             f"phase 4 {want}")
    expect = [dict(kind="sort1d_summary", pipeline="Ygs", nodes=g4.num_nodes,
                   steps=g4.num_steps)]
    if [{k: v for k, v in r.items() if k != "wall_s"} for r in out["metrics"]] != expect:
        fail(f"cli sort --metrics: {out['metrics']}, expected {expect} (and wall_s)")
    add_bounds(rec, "cli", sm["g"], p1, g4, p2, "resident")
    borrow_times(rec, "smoke", "cli")

    # layout --metrics on the small graph: a per-iteration callback, the
    # batched path (no strata kernel)
    gs_path, ms_path = os.path.join(tmp, "small.gfa"), os.path.join(tmp, "small.jsonl")
    small = shuffled_graph(*SMALL)
    ot.write_gfa(small, gs_path)
    walls = {}

    def run_small():
        cli(["layout", "-i", gs_path, "-o", os.path.join(tmp, "small.lay"), "--metrics",
             ms_path], walls)
        return dict(route=sgd.LAST_RUN["route"])

    out = counted("cli-small", rec, run_small, levels=())
    out["walls_s"] = walls
    out["metrics"] = read_jsonl(ms_path)
    say("main_path", path="cli-small", **out)
    iters = derive_config_2d(small).iter_max
    kinds = [(r["kind"], r.get("iter"), "delta_max" in r) for r in out["metrics"]]
    expect = ([("layout2d", 0, False)] + [("layout2d", i, True) for i in range(1, iters)]
              + [("layout2d_summary", None, False)])
    if out["route"] != "batched" or any(out["launches"].values()):
        fail(f"cli-small: route {out['route']}, launches {out['launches']}")
    if kinds != expect or out["metrics"][-1].get("iter_max") != iters:
        fail(f"cli-small layout --metrics: {out['metrics']}")


# ---------------------------------------------------------------------------
# Phase 6: the XL path
# ---------------------------------------------------------------------------


def phase_xl(g, tmp: str, dev, rec: Record) -> tuple:
    state = {}

    def run():
        out = {}
        out["nt_before"] = ot.sum_of_path_node_distances(g, device=dev).all_nt_space
        t0 = time.perf_counter()
        g2 = ot.sort_pipeline(g, "Ygs", device=dev)
        out["sort_Ygs_s"] = sync_wall(t0)
        out["nt_after"] = ot.sum_of_path_node_distances(g2, device=dev).all_nt_space
        c0 = ot.init_layout(g2, "d")
        out["stress_before"] = ot.sum_of_path_node_distances(
            g2, (c0[:, 0], c0[:, 1]), device=dev).all_2d_by_nucleotides
        t0 = time.perf_counter()
        coords = ot.layout_graph(g2, device=dev)
        out["layout_s"] = sync_wall(t0)
        lay_roundtrip(coords, os.path.join(tmp, "xl.lay"), dev, out)
        out["stress_after"] = ot.sum_of_path_node_distances(
            g2, (coords[:, 0], coords[:, 1]), device=dev).all_2d_by_nucleotides
        state.update(g2=g2, c0=c0, coords=coords)
        return out

    out = counted("xl", rec, run)
    g2, c0, coords = state["g2"], state["c0"], state["coords"]
    cfg1, cfg2 = derive_config_1d(g), derive_config_2d(g2)
    routes = {"1d": strata_route.graph_route(g, cfg1, True),
              "2d": strata_route.graph_route(g2, cfg2, False)}
    p1 = strata_plan.plan_run(g, cfg1, one_d=True)
    p2 = strata_plan.plan_run(g2, cfg2, one_d=False)
    check_routes(out, "xl", "xl", routes, {"1d": p1["groups"], "2d": p2["groups"]})
    add_rates(out, p1, p2, "sort_Ygs")
    out["plan"] = {tag: dict(cpi=p["cpi"], cgs=p["cgs"], groups=p["groups"],
                             total_valid=p["total_valid"], slots=p["data"].num_slots)
                   for tag, p in (("1d", p1), ("2d", p2))}

    out["host_s"] = {f"levels_{tag}": out[f"levels_{tag}"]["seconds"] for tag in ("1d", "2d")}
    # the same layout on the resident route with the chain kernel: the same
    # coordinates, bit for bit
    t0 = time.perf_counter()
    res = run_on_chain(lambda: strata_sgd.path_sgd_2d_strata(g2, c0, cfg2, dev, route="resident"),
                       rec, "xl/2d", p2)
    out["layout_resident_sgd_s"] = sync_wall(t0)
    res = layout.pack_components(g2, res.cpu().numpy())
    out["resident_equal"] = bool(np.array_equal(res, coords))
    say("main_path", path="xl", **out)
    if not out["resident_equal"]:
        fail(f"xl layout differs from the resident route (max {np.abs(res - coords).max()})")
    if not np.isfinite(coords).all():
        fail("xl layout coordinates not finite")
    if not (out["nt_after"] < out["nt_before"] and out["stress_after"] < out["stress_before"]):
        fail(f"xl quality did not improve: {out}")
    add_bounds(rec, "xl", g, p1, g2, p2, "xl")
    full_groups(g, cfg1, g.node_offset.astype(np.float32), True, "xl", "xl/1d", dev, rec)
    full_groups(g2, cfg2, c0, False, "xl", "xl/2d", dev, rec)
    return out, g2


# ---------------------------------------------------------------------------
# Phase 8: the sharded path (parallel/sharded_strata.py)
# ---------------------------------------------------------------------------


class CallTimes:
    """CUDA-event time of every call of `module.name` while installed (a
    function the sharded run looks up in its module on each call)."""

    def __init__(self, module, name: str):
        self.module, self.name, self.orig = module, name, getattr(module, name)
        self.events = []

    def __enter__(self) -> "CallTimes":
        def timed_call(*a):
            t = Timer()
            r = self.orig(*a)
            self.events.append(t.stop())
            return r

        setattr(self.module, self.name, timed_call)
        return self

    def __exit__(self, *exc) -> None:
        setattr(self.module, self.name, self.orig)

    def ms(self) -> list:
        return [t.ms() for t in self.events]


def nccl_one_rank(fn):
    """fn() inside a one-rank NCCL process group on this card (a store on a
    free localhost port), destroyed after."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=300))
    try:
        return fn()
    finally:
        torch.distributed.destroy_process_group()


def stress_of(g, coords: np.ndarray, dev) -> float:
    return ot.sum_of_path_node_distances(
        g, (coords[:, 0], coords[:, 1]), device=dev).all_2d_by_nucleotides


def phase_sharded(label: str, g, single_stress: float, dev, rec: Record,
                  one_device: bool = False) -> dict:
    """The sorted graph `g` of path `label` through
    path_sgd_2d_strata_sharded at SHARDED_DEVICES devices, simulated, from
    init_layout(g, "d") at the default 2D schedule, counted under
    "sharded-<label>": wall, kernel time, consensus (fold) and replica
    restart time per iteration, stress against `single_stress` (the same
    graph's single-device layout).  Then the stacked plan's first group of
    the last device through the kernels and their plain versions.  With
    `one_device`: one device simulated against a one-rank NCCL group (bit
    for bit) and against path_sgd_2d on the resident route."""
    key = f"sharded-{label}"
    cfg = derive_config_2d(g)
    c0 = ot.init_layout(g, "d")
    n = SHARDED_DEVICES
    t0 = time.perf_counter()
    sp = sharded_strata.stacked_plan(g, cfg, n)
    host_s = dict(stacked_plan=time.perf_counter() - t0)
    state = {}

    def run():
        with CallTimes(sharded_strata, "fold_consensus") as fold, \
                CallTimes(sharded_strata, "restart_replica") as restart:
            t0 = time.perf_counter()
            coords = sharded_strata.path_sgd_2d_strata_sharded(g, c0, cfg, n_dev=n, device=dev)
            out = dict(wall_s=sync_wall(t0))
        state["coords"] = coords.cpu().numpy()
        out["consensus_ms_per_iter"] = sum(fold.ms()) / cfg.iter_max
        out["restart_ms_per_iter"] = sum(restart.ms()) / cfg.iter_max
        return out

    out = counted(key, rec, run, levels=("2d",))
    coords = state["coords"]
    for nm in kernels.NAMES:
        want = sp["groups"] if nm in SHARDED_KERNELS else 0
        if out["launches"][nm] != want:
            fail(f"{key}: {nm} launched {out['launches'][nm]} times, expected {want}")
    t0 = time.perf_counter()
    valid = strata_plan._count_valid(g, sp["o_blk"], sp["d_arr"])
    host_s["count_valid"] = time.perf_counter() - t0
    kernels_s = out["sgd_device_s"]["2d"]
    out.update(
        devices=n, kernels_s=kernels_s, idle=1.0 - kernels_s / out["wall_s"],
        host_s=dict(host_s, levels_2d=out["levels_2d"]["seconds"]),
        plan=dict(cpi=sp["cpi"], cgs=sp["cgs"], groups=sp["groups"],
                  groups_per_device=sp["groups"] // n, total_valid=valid),
        valid_pair_updates_per_s_device=valid / kernels_s,
        valid_pair_updates_per_s_wall=valid / out["wall_s"],
        stress_before=stress_of(g, c0, dev), stress_after=stress_of(g, coords, dev),
        single_device_stress=single_stress)
    out["stress_ratio"] = out["stress_after"] / single_stress
    rec.bounds[LEVELS_2D][f"{key}/2d"] = chunk_bounds(sp, False)
    rec.bounds["strata_merge_sum"][f"{key}/2d"] = [merge_sum_bound(g, False)]
    rec.bounds["strata_merge_bcast"][f"{key}/2d"] = [
        merge_bcast_bound(g, sp["data"].num_slots, False)]

    if one_device:
        with CallTimes(sharded_strata, "gather_changes") as gather:
            t0 = time.perf_counter()
            nccl = nccl_one_rank(
                lambda: sharded_strata.path_sgd_2d_strata_sharded(g, c0, cfg, device=dev))
            out["one_rank_nccl_s"] = sync_wall(t0)
        # the first all_gather also sets up the NCCL communicator
        first, *rest = gather.ms()
        out["nccl_all_gather_first_ms"] = first
        out["nccl_all_gather_ms_per_iter"] = sum(rest) / len(rest)
        t0 = time.perf_counter()
        sim1 = sharded_strata.path_sgd_2d_strata_sharded(g, c0, cfg, n_dev=1, device=dev)
        out["one_device_s"] = sync_wall(t0)
        single = strata_sgd.path_sgd_2d_strata(g, c0, cfg, dev, route="resident")
        out["one_rank_nccl_equal"] = bool(torch.equal(nccl, sim1))
        out["one_device_vs_single_err"] = rel_err(sim1, single, float(single.abs().max()) + 1.0)
        out["one_device_stress"] = stress_of(g, sim1.cpu().numpy(), dev)
        out["one_device_finite"] = bool(torch.isfinite(sim1).all() and torch.isfinite(nccl).all())

    # the last device's first group of the stacked plan (its chunks' global
    # indices past 2147 x n) through the kernels and their plain versions
    st = strata_sgd.StrataState.build(g, cfg, c0, False, dev, "resident", plan=sp)
    warm_up(st)
    compare_group(st, (n - 1) * (sp["groups"] // n), rec, f"{key}/2d")
    del st
    torch.cuda.synchronize()
    say("main_path", path=key, **out)

    if not np.isfinite(coords).all():
        fail(f"{key}: coordinates not finite")
    if not out["stress_after"] <= SHARDED_STRESS_RATIO * single_stress:
        fail(f"{key}: stress {out['stress_after']} > {SHARDED_STRESS_RATIO} x the single "
             f"device's {single_stress}")
    if one_device:
        if not out["one_rank_nccl_equal"]:
            fail(f"{key}: the one-rank NCCL run differs from the one-device simulation")
        if not out["one_device_finite"]:
            fail(f"{key}: one-device coordinates not finite")
        if not out["one_device_vs_single_err"] <= SHARDED_ONE_TOL:
            fail(f"{key}: one device {out['one_device_vs_single_err']:.3e} of the scale from "
                 f"path_sgd_2d (resident) > {SHARDED_ONE_TOL}")
    return out


# ---------------------------------------------------------------------------
# Phase 9: the multi-device batched sampler
# ---------------------------------------------------------------------------


def device_events(fn) -> list:
    """The CUDA device events fn() gives rise to, as torch.profiler
    records them (memcpy and memset included), in the order they ran.  The
    queue is drained before the window opens, so no earlier work falls
    into it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if getattr(e, "device_type", None) is not None
           and e.device_type.name == "CUDA"]
    return sorted(evs, key=lambda e: e.time_range.start)


def sampler_run(g, cfg, one_d: bool, num_batches: int, n_dev=None, consensus="iteration",
                words=None, dev=None):
    """One run of the sampler on `g` from its default start."""
    x0 = g.node_offset if one_d else ot.init_layout(g, "d")
    return sharded.sharded_positions(g, x0, cfg, one_d, n_dev, consensus, dev, words,
                                     num_batches)


def repeat_events(fn, reps: int) -> dict:
    """The CUDA events of one repeat of the work fn() does `reps` times in
    one profiled window, each repeat launching one scatter (``index_add_``,
    an ``indexFunc`` kernel): the events after one scatter up to and
    including the next are one repeat, so the window gives reps - 1
    readings.  They stand only where they hold the same events name by
    name; else the profiler lost or added records inside the window, the
    counts are None and every reading is printed by name.  (Differences
    of separately profiled windows do not hold: each window loses a
    varying number of its first events.)"""
    evs = device_events(fn)
    cuts = [k for k, e in enumerate(evs) if "indexFunc" in e.name]
    spans = [evs[cuts[k] + 1:cuts[k + 1] + 1] for k in range(len(cuts) - 1)]
    reads = [collections.Counter(e.name[:60] for e in r) for r in spans]
    agree = len(cuts) == reps and all(r == reads[0] for r in reads)
    out = dict(events_agree=agree, scatters_traced=len(cuts),
               events=dict(reads[-1]) if reads else None)
    if not agree:
        out["events_readings"] = [dict(r) for r in reads]
    out["kernels"] = len(spans[0]) if agree else None
    out["device_ms"] = (sum(e.time_range.elapsed_us() for r in spans for e in r)
                        / (1e3 * len(spans)) if agree else None)
    return out


def round_profile(g, cfg, one_d: bool, dev) -> dict:
    """The CUDA events of one batch round at SAMPLER_DEVICES simulated
    devices and their summed device ms: ``repeat_events`` of a run of one
    iteration of 3 rounds, after a warm-up run on the same tables."""
    cfg1 = dataclasses.replace(cfg, iter_max=1)
    make = sharded.make_sharded_sgd_1d if one_d else sharded.make_sharded_sgd_2d
    data = batched_sgd.SgdData.build(g, cfg.theta, cfg.space, cfg.space_max,
                                     cfg.space_quantization_step, device=dev)
    x = torch.as_tensor((g.node_offset if one_d else ot.init_layout(g, "d")).astype(np.float32),
                        device=dev)
    etas = torch.tensor([np.float32(cfg.eta_max)], device=dev)
    run = make(cfg1, 3, n_dev=SAMPLER_DEVICES)
    run(x, etas, data)
    prof = repeat_events(lambda: run(x, etas, data), 3)
    out = {f"round_{k}": v for k, v in prof.items() if k.startswith(("events", "scatters"))}
    out.update(kernels_per_round=prof["kernels"], device_ms_per_round=prof["device_ms"])
    return out


def valid_pairs(g, cfg, one_d: bool, dev) -> int:
    """The valid pairs of the run `sharded_positions` makes of `g` at
    SAMPLER_DEVICES simulated devices with its own generators: a replay of
    its rounds' sampling and pair updates (``pair_acc_*``, whose valid
    lanes are the counted ones) against a zero table, without the timing
    window.  The pairs depend on the words and the tables only, not on
    the coordinates."""
    n, B = SAMPLER_DEVICES, cfg.batch_size
    data = batched_sgd.SgdData.build(g, cfg.theta, cfg.space, cfg.space_max,
                                     cfg.space_quantization_step, device=dev)
    words = sharded.generator_words(cfg, range(n), dev)
    starts = torch.as_tensor(sharded.batch_starts(cfg, cfg.num_batches, n, range(n),
                                                  data.num_steps, data.tab_a.shape[1]),
                             device=dev)
    acc_fn = batched_sgd.pair_acc_1d if one_d else batched_sgd.pair_acc_2d
    table = torch.zeros((g.num_nodes if one_d else 2 * g.num_nodes, 1 if one_d else 2),
                        dtype=torch.float32, device=dev)
    lanes = torch.arange(B, device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for it in range(cfg.iter_max):
        cooling = it > cfg.first_cooling_iteration if one_d else it >= cfg.first_cooling_iteration
        for b in range(cfg.num_batches):
            w = torch.stack([words(it, b, d) for d in range(n)], dim=1)
            pairs, _ = batched_sgd.pairs_from_cols(data.tab_a[:, starts[it, b][:, None] + lanes],
                                                   w, data, cfg, cooling)
            total += acc_fn(table, pairs, 1.0)[2].sum()
    return int(total)


def phase_sampler(ins: dict, dev) -> dict:
    """The sampler through sharded_sort_order and sharded_layout on the
    smoke graph at SAMPLER_DEVICES simulated devices ("iteration"
    consensus, default schedules), then the DRB1-scale checks."""
    g, g2, n = ins["g"], ins["g2"], SAMPLER_DEVICES
    out = {}
    cfg1, cfg2 = derive_config_1d(g), derive_config_2d(g2)
    t0 = time.perf_counter()
    order = sharded.sharded_sort_order(g, n_dev=n, device=dev)
    wall = sync_wall(t0)
    rounds, valid = cfg1.iter_max * cfg1.num_batches, valid_pairs(g, cfg1, True, dev)
    out["sort"] = dict(
        wall_s=wall, rounds=rounds, rounds_per_s=rounds / wall, batch_size=cfg1.batch_size,
        valid_pairs=valid, valid_pairs_per_s_wall=valid / wall,
        nt_before=ins["nt_before"],
        nt_after=ot.sum_of_path_node_distances(g.apply_ordering(order, compact_ids=True),
                                               device=dev).all_nt_space,
        nt_after_Y_strata=ins["nt_after_Y"], **round_profile(g, cfg1, True, dev))
    t0 = time.perf_counter()
    coords = sharded.sharded_layout(g2, n_dev=n, device=dev)
    wall = sync_wall(t0)
    rounds, valid = cfg2.iter_max * cfg2.num_batches, valid_pairs(g2, cfg2, False, dev)
    c0 = ot.init_layout(g2, "d")
    out["layout"] = dict(
        wall_s=wall, rounds=rounds, rounds_per_s=rounds / wall, batch_size=cfg2.batch_size,
        valid_pairs=valid, valid_pairs_per_s_wall=valid / wall,
        stress_before=stress_of(g2, c0, dev), stress_after=stress_of(g2, coords, dev),
        single_device_batched_stress=ins["snap_stress"],
        single_device_batched_s=ins["snap_without_snapshots_s"],
        **round_profile(g2, cfg2, False, dev))
    for k in ("sort", "layout"):
        # the share of the wall the card is busy, from the profiled rounds
        o, ms = out[k], out[k]["device_ms_per_round"]
        o["device_busy_share"] = None if ms is None else ms * o["rounds"] / (1e3 * o["wall_s"])
    out["layout"]["stress_ratio"] = out["layout"]["stress_after"] / ins["snap_stress"]
    out["layout"]["wall_over_single_device"] = wall / ins["snap_without_snapshots_s"]
    say("main_path", path="sampler-smoke", devices=n, consensus="iteration", **out)
    if sorted(order.tolist()) != list(range(g.num_nodes)):
        fail("sampler-smoke: the sort order is not a permutation of the nodes")
    if not out["sort"]["nt_after"] < out["sort"]["nt_before"]:
        fail(f"sampler-smoke: nt-distance {out['sort']['nt_after']} not below its start "
             f"{out['sort']['nt_before']}")
    if not np.isfinite(coords).all():
        fail("sampler-smoke: coordinates not finite")
    if not out["layout"]["stress_after"] <= SHARDED_STRESS_RATIO * ins["snap_stress"]:
        fail(f"sampler-smoke: stress {out['layout']['stress_after']} > {SHARDED_STRESS_RATIO} "
             f"x the single-device batched layout's {ins['snap_stress']}")
    out["drb1"] = sampler_checks(dev)
    return out


def sampler_checks(dev) -> dict:
    """On the DRB1-scale graph, 1D and 2D: "batch" consensus at
    SAMPLER_DEVICES devices against the batched path's own update of one
    batch of n B pairs on the same words; one device simulated against a
    one-rank NCCL group; the first batch's local accumulators on the card
    against the CPU on the same words.  Each within SAMPLER_TOL of its
    scale, for one iteration of one or two rounds: past a few rounds the
    order in which the card's index_add_ adds, amplified where two 2D
    endpoints coincide, parts any two runs."""
    gd, n = shuffled_graph(*DRB1), SAMPLER_DEVICES
    out = dict(steps=gd.num_steps, nodes=gd.num_nodes, paths=gd.num_paths)
    for one_d in (True, False):
        tag = "1d" if one_d else "2d"
        derive = derive_config_1d if one_d else derive_config_2d
        cfg = derive(gd, iter_max=1, batch_size=SAMPLER_CHECK_BATCH)
        B = cfg.batch_size
        data = batched_sgd.SgdData.build(gd, cfg.theta, cfg.space, cfg.space_max,
                                         cfg.space_quantization_step, device=dev)
        x0 = torch.as_tensor((gd.node_offset if one_d else ot.init_layout(gd, "d"))
                             .astype(np.float32), device=dev)
        draw = sharded.generator_words(cfg, range(n), dev)
        words = [draw(0, 0, d) for d in range(n)]
        got = sampler_run(gd, cfg, one_d, 1, n, "batch", lambda it, b, d: words[d], dev)
        cooling = 0 > cfg.first_cooling_iteration if one_d else 0 >= cfg.first_cooling_iteration
        eta = torch.tensor(np.float32(sgd.sgd_schedule(
            1.0 / cfg.eta_max, 1.0, 1, cfg.iter_with_max_learning_rate, cfg.eps)[0]), device=dev)
        pairs, _ = batched_sgd.sample_pairs(torch.cat(words, dim=1), 0, data,
                                            dataclasses.replace(cfg, batch_size=n * B), cooling)
        want, _ = (batched_sgd.update_1d if one_d else batched_sgd.update_2d)(x0, pairs, eta)
        scale = float(want.abs().max())
        res = dict(batch_size=B, batch_vs_big_batch_err=rel_err(got, want, scale))

        sim = sampler_run(gd, cfg, one_d, 2, 1, dev=dev)
        nccl = nccl_one_rank(lambda: sampler_run(gd, cfg, one_d, 2, dev=dev))
        res["one_rank_nccl_err"] = rel_err(nccl, sim, float(sim.abs().max()))

        w = batched_sgd.draw_words(torch.Generator().manual_seed(7), B, "cpu")
        data_cpu = batched_sgd.SgdData.build(gd, cfg.theta, cfg.space, cfg.space_max,
                                             cfg.space_quantization_step, device="cpu")
        acc = sharded.local_acc_1d if one_d else sharded.local_acc_2d
        a_card = acc(x0, w.to(dev), 0, data, cfg, eta, cooling).cpu()
        a_cpu = acc(x0.cpu(), w, 0, data_cpu, cfg, eta.cpu(), cooling)
        res["local_acc_counts_equal"] = bool(torch.equal(a_card[:, -1], a_cpu[:, -1]))
        res["local_acc_err"] = rel_err(a_card, a_cpu, float(a_cpu[:, :-1].abs().max()))
        out[tag] = res
    say("sampler_checks", graph="drb1-scale", **out)
    for tag in ("1d", "2d"):
        r = out[tag]
        for k in ("batch_vs_big_batch_err", "one_rank_nccl_err", "local_acc_err"):
            if not r[k] <= SAMPLER_TOL:
                fail(f"sampler {tag}: {k} {r[k]:.3e} > {SAMPLER_TOL}")
        if not r["local_acc_counts_equal"]:
            fail(f"sampler {tag}: the card's pair counts differ from the CPU's")
    return out


# ---------------------------------------------------------------------------
# Phase 10: the rest of the command line
# ---------------------------------------------------------------------------


def cli_cpu(argv: list) -> str:
    """The stdout of one command on the CPU."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = cli_main.main(argv, device="cpu")
    if rc != 0:
        fail(f"cli on the CPU {' '.join(argv)}: exit {rc}")
    return out.getvalue()


def phase_cli_rest(tmp: str, dev, rec: Record) -> dict:
    """Every sort code, a chain of codes, stats --is-acyclic /
    --count-walks / --shortest-cycle and paths -L -l -f -H through the
    command line on the card (device None), on phase 4c's smoke .otg, those
    in SLOW_ON_SMOKE on the 1,000-step graph: each sorted graph bit-equal
    to sort_pipeline on the CPU in this run (the chain's Y through the
    entry point on the card), each printout equal to the CPU's; then
    sort -Y -u on the 1,000-step graph.  Counted: the chain's Y runs the
    resident 1D kernels."""
    smoke, small = os.path.join(tmp, "smoke.otg"), os.path.join(tmp, "small.otg")
    og_io.save_graph(shuffled_graph(*SMALL), small)
    g_smoke = og_io.load_graph(smoke)
    chain_want = ot.sort_pipeline(ot.sort_pipeline(g_smoke, CLI_CHAIN[0], device=dev),
                                  CLI_CHAIN[1:], device="cpu")
    src_of = lambda what: small if what in SLOW_ON_SMOKE else smoke

    def run():
        walls, out = {}, dict(sort={}, stats={}, paths={})
        for code in list(CLI_CODES) + [CLI_CHAIN]:
            src, dst = src_of(code), os.path.join(tmp, f"sort_{code}.otg")
            cli(["sort", "-i", src, "-o", dst, "-p", code], walls)
            want = chain_want if code == CLI_CHAIN else \
                ot.sort_pipeline(og_io.load_graph(src), code, device="cpu")
            out["sort"][code] = dict(graph="small" if src == small else "smoke",
                                     wall_s=walls["sort"][-1],
                                     equal_to_cpu=same_fields(og_io.load_graph(dst), want))
        for flag in ("--is-acyclic", "--count-walks", "--shortest-cycle"):
            argv = ["stats", "-i", src_of(flag), flag]
            printed, _ = cli(argv, walls)
            out["stats"][flag] = dict(graph="small" if argv[2] == small else "smoke",
                                      wall_s=walls["stats"][-1], printed=printed.strip(),
                                      equal_to_cpu=printed == cli_cpu(argv))
        for flag in ("-L", "-l", "-f", "-H"):
            argv = ["paths", "-i", smoke, flag]
            printed, _ = cli(argv, walls)
            out["paths"][flag] = dict(wall_s=walls["paths"][-1], bytes=len(printed),
                                      equal_to_cpu=printed == cli_cpu(argv))
        prefix, res = os.path.join(tmp, "usnap"), os.path.join(tmp, "sort_u.og")
        cli(["sort", "-i", small, "-o", res, "-Y", "-u", prefix], walls)
        iters = derive_config_1d(og_io.load_graph(small)).iter_max
        snaps = [f for f in os.listdir(tmp) if re.fullmatch(r"usnap\d+", f)]
        with open(f"{prefix}{iters}", "rb") as a, open(res, "rb") as b:
            last_equal = a.read() == b.read()
        out["sort_u"] = dict(graph="small", wall_s=walls["sort"][-1], snapshots=len(snaps),
                             iterations=iters, last_equals_result=last_equal)
        return out

    out = counted("cli-rest", rec, run, levels=("1d",))
    p1 = strata_plan.plan_run(g_smoke, derive_config_1d(g_smoke), one_d=True)
    key = "cli-rest/1d"
    rec.bounds[LEVELS_1D][key] = chunk_bounds(p1, True)
    rec.bounds["strata_merge_sum"][key] = [merge_sum_bound(g_smoke, True)]
    rec.bounds["strata_merge_bcast"][key] = [merge_bcast_bound(g_smoke, p1["data"].num_slots,
                                                               True)]
    borrow_times(rec, "smoke", "cli-rest")
    say("main_path", path="cli-rest", **out)
    bad = [f"{k} {w}" for k in ("sort", "stats", "paths") for w, v in out[k].items()
           if not v["equal_to_cpu"]]
    if bad:
        fail(f"cli-rest: differs from the CPU: {bad}")
    su = out["sort_u"]
    if su["snapshots"] != su["iterations"] or not su["last_equals_result"]:
        fail(f"cli-rest: sort -u wrote {su['snapshots']} snapshots of {su['iterations']}, "
             f"the last equal to the result: {su['last_equals_result']}")
    for n in kernels.NAMES:
        want = p1["groups"] if n in (LEVELS_1D, "strata_merge_sum", "strata_merge_bcast") else 0
        if out["launches"][n] != want:
            fail(f"cli-rest: {n} launched {out['launches'][n]} times, expected {want} (the "
                 f"chain's Y on the resident route)")
    return out


# ---------------------------------------------------------------------------
# Phase 7: the 1M-node path
# ---------------------------------------------------------------------------


def phase_big(g, tmp: str, dev, rec: Record, keep: dict) -> dict:
    """Phase 7, the 1M-node path; the Ygs-sorted graph and the layout stay
    in `keep` for phase_render_big."""
    state = {}
    host_s = {}
    c0 = ot.init_layout(g, "d")
    start = dict(
        nt_before=ot.sum_of_path_node_distances(g, device=dev).all_nt_space,
        stress_before=ot.sum_of_path_node_distances(
            g, (c0[:, 0], c0[:, 1]), device=dev).all_2d_by_nucleotides)
    say("bigscale_start", **start, bigscale=BIGSCALE)
    for k, v in start.items():
        if not abs(v - BIGSCALE[k]) <= START_RTOL * BIGSCALE[k]:
            fail(f"1M graph {k} {v} != BIGSCALE_r05's {BIGSCALE[k]} (rtol {START_RTOL})")

    def timed_host(name, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            host_s[name] = time.perf_counter() - t0
            return r
        return call

    def run():
        out = dict(start)
        t0 = time.perf_counter()
        gY = ot.sort_pipeline(g, "Y", device=dev)
        out["sort_Y_s"] = sync_wall(t0)
        out["nt_after_Y"] = ot.sum_of_path_node_distances(gY, device=dev).all_nt_space
        t0 = time.perf_counter()
        coords = ot.layout_graph(g, device=dev)
        out["layout_s"] = sync_wall(t0)
        out["stress_after"] = ot.sum_of_path_node_distances(
            g, (coords[:, 0], coords[:, 1]), device=dev).all_2d_by_nucleotides
        state.update(gY=gY, coords=coords)
        return out

    out = counted("big", rec, run)
    gY, coords = state["gY"], state["coords"]
    cfg1, cfg2 = derive_config_1d(g), derive_config_2d(g)
    routes = {"1d": strata_route.graph_route(g, cfg1, True),
              "2d": strata_route.graph_route(g, cfg2, False)}
    p1 = strata_plan.plan_run(g, cfg1, one_d=True)
    p2 = strata_plan.plan_run(g, cfg2, one_d=False)
    check_routes(out, "big", "xxl", routes, {"1d": p1["groups"], "2d": p2["groups"]})
    add_rates(out, p1, p2, "sort_Y")
    out["plan"] = {tag: dict(cpi=p["cpi"], cgs=p["cgs"], groups=p["groups"],
                             total_valid=p["total_valid"], slots=p["data"].num_slots)
                   for tag, p in (("1d", p1), ("2d", p2))}

    # "gs" on the Y-sorted graph: host code, no kernel
    saved = path_sgd_sort.apply_groom, path_sgd_sort.topological_order
    path_sgd_sort.apply_groom = timed_host("groom", saved[0])
    path_sgd_sort.topological_order = timed_host("topological_order", saved[1])
    try:
        t0 = time.perf_counter()
        gYgs = ot.sort_pipeline(gY, "gs", device=dev)
        out["sort_gs_s"] = time.perf_counter() - t0
    finally:
        path_sgd_sort.apply_groom, path_sgd_sort.topological_order = saved
    for tag in ("1d", "2d"):
        host_s[f"levels_{tag}"] = out[f"levels_{tag}"]["seconds"]
    out["host_s"] = host_s
    out["nt_after_Ygs"] = ot.sum_of_path_node_distances(gYgs, device=dev).all_nt_space
    lay_roundtrip(coords, os.path.join(tmp, "big.lay"), dev, out)
    say("main_path", path="big", **out, bigscale=BIGSCALE)

    if not np.isfinite(coords).all():
        fail("1M layout coordinates not finite")
    if not out["nt_after_Y"] <= BIG_NT_AFTER_MAX:
        fail(f"1M nt-distance after Y {out['nt_after_Y']} > {BIG_NT_AFTER_MAX}")
    if not out["stress_after"] <= BIG_STRESS_AFTER_MAX:
        fail(f"1M stress after layout {out['stress_after']} > {BIG_STRESS_AFTER_MAX}")
    g_run, _ = strata_xxl.relabel(g)
    add_bounds(rec, "big", g_run, p1, g_run, p2, "xxl")
    full_groups(g, cfg1, g.node_offset.astype(np.float32), True, "xxl", "big/1d", dev, rec)
    full_groups(g, cfg2, c0, False, "xxl", "big/2d", dev, rec)
    keep.update(gYgs=gYgs, coords=coords)
    return out


def compare_sums(st) -> dict:
    """The blocked sum, the CSR sum and one f64 index_add_ on the state's
    drift, in turns (that order, then back): the blocked sum must equal the
    CSR sum bit for bit.  Returns each one's mean time."""
    ms = {k: [] for k in ("blocked", "csr", "index_add")}
    outs = {}
    for k in ("blocked", "csr", "index_add", "index_add", "csr", "blocked"):
        if k == "index_add":
            ms[k].append(library_merge_sum(st))
            continue
        c, u = st.coords.clone(), st.upd.clone()
        if k == "csr":
            ms[k].append(timed(kernels.strata_merge_sum, st.drift, st.mi, c, u))
        else:
            ms[k].append(timed(kernels.strata_merge_sum_blocked, st.drift, st.mi, st.bsch, c, u))
        outs[k] = (c, u)
    if not all(torch.equal(a, b) for a, b in zip(outs["blocked"], outs["csr"])):
        fail("strata_merge_sum_blocked: differs from strata_merge_sum")
    return {f"sum_{k}_ms": sum(v) / len(v) for k, v in ms.items()}


def full_groups(g, cfg, init, one_d: bool, route: str, key: str, dev, rec: Record) -> None:
    """The first FULL_GROUPS groups of a full plan (the main path's) through
    the leveled kernel and the chain kernel on the route's state: bit-equal
    drift; the chain's times go to the comparison records.  On the "xxl"
    route each group's merge input also goes through `compare_sums`."""
    t0 = time.perf_counter()
    st = strata_sgd.StrataState.build(g, cfg, init, one_d, dev, route)
    build_s = time.perf_counter() - t0
    warm_up(st)
    for gid in range(FULL_GROUPS):
        lv = compare_levels(st, gid, rec, key)
        line = dict(key=key, group=gid, cgs=st.plan["cgs"], levels=lv["levels"],
                    levels_ms=lv["levels_ms"], chain_ms=lv["chain_ms"],
                    state_build_s=build_s)
        st.drift = lv["drift"]
        if route == "xxl":
            line.update(compare_sums(st))
            kernels.strata_merge_sum_blocked(st.drift, st.mi, st.bsch, st.coords, st.upd)
        else:
            kernels.strata_merge_sum(st.drift, st.mi, st.coords, st.upd)
        kernels.strata_merge_bcast(st.drift, st.base, st.mi, st.upd)
        say("levels_vs_chain", **line)
    del st
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Phase 11: the pictures and the edits
# ---------------------------------------------------------------------------


def render_side_files(d: str) -> dict:
    """The BED ranges (over the smoke graph's paths p0 and p3, the base
    names of prune's fragments), the groom target and bubble_graph's GFA
    of RENDER_CMDS, written into `d`."""
    files = dict(bed=os.path.join(d, "ranges.bed"), tgt=os.path.join(d, "targets.txt"),
                 bub=os.path.join(d, "bubbles.gfa"))
    ot.write_gfa(bubble_graph(), files["bub"])
    with open(files["bed"], "w") as f:
        f.write("p0\t100\t5000\tgeneA\np3\t2000\t2600\tgeneB\np3\t40000\t40100\tgeneC\n")
    with open(files["tgt"], "w") as f:
        f.write("p3\n")
    return files


def render_argv(cmd: str, names: dict) -> list:
    return [w.format(**names) for w in cmd.split()]


def render_digest(data: bytes) -> str:
    """16 hex digits of the SHA-256 of a printout or a file's bytes; of a
    PNG, of its shape and pixels (its bytes depend on the zlib)."""
    if data[:8] == png.SIGNATURE:
        img = png.decode(data)
        data = json.dumps(img.shape).encode() + img.tobytes()
    return hashlib.sha256(data).hexdigest()[:16]


def render_run(names: dict, run, cmds=RENDER_CMDS) -> dict:
    """Each command of `cmds` (RENDER_CMDS or POSITION_CMDS) through
    `run(argv)` -> (stdout, stderr); key -> dict(stdout=, stderr=,
    files={name: bytes}, wall_s=)."""
    out = {}
    for key, cmd, files in cmds:
        t0 = time.perf_counter()
        printed, err = run(render_argv(cmd, names))
        wall_s = time.perf_counter() - t0
        got = {}
        for f in files:
            with open(os.path.join(names["d"], f), "rb") as fh:
                got[f] = fh.read()
        out[key] = dict(stdout=printed, stderr=err, files=got, wall_s=wall_s)
    return out


def phase_render(tmp: str, dev, rec: Record) -> dict:
    """Every subcommand of the pictures and the edits through the command
    line on the card (device None), on phase 4c's smoke .otg as generated
    and its init_layout coordinates (a .lay): each printout and file equal
    to odgi_tpu's on a CPU host with PIL (RENDER_DIGESTS; a PNG by its
    pixels); each written PNG decodes to the array the API renders; then
    viz and draw of phase 4c's sorted graph and its layout, which no digest
    holds, card against CPU.  Host code: no kernel may launch."""
    smoke = os.path.join(tmp, "smoke.otg")
    g = og_io.load_graph(smoke)
    lay = os.path.join(tmp, "init.lay")
    ot.save_layout(ot.init_layout(g, "d"), lay, device=dev)
    names = dict(g=smoke, lay=lay, small=os.path.join(tmp, "small.otg"),
                 **render_side_files(tmp))
    dirs = {t: os.path.join(tmp, f"render-{t}") for t in ("card", "cpu")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    walls = {}

    def on_cpu(argv):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli_main.main(argv, device="cpu")
        if rc != 0:
            fail(f"render on the CPU {' '.join(argv)}: exit {rc}")
        return out.getvalue(), err.getvalue()

    def run():
        t0 = time.perf_counter()
        card = render_run(dict(names, d=dirs["card"]), lambda argv: cli(argv, walls))
        return dict(wall_s=time.perf_counter() - t0, card=card)

    res = counted("render", rec, run, levels=())
    card = res.pop("card")
    out = dict(res, walls_s={}, differs_from_odgi_tpu=[], digests={})
    for key, _, _ in RENDER_CMDS:
        c = card[key]
        out["walls_s"][key] = c["wall_s"]
        got = {"stdout": render_digest(c["stdout"].encode()),
               **{f: render_digest(b) for f, b in c["files"].items()}}
        out["digests"][key] = got
        if got != RENDER_DIGESTS.get(key):
            out["differs_from_odgi_tpu"].append(key)

    # the written pictures against the arrays the API renders
    want_viz = viz.render_viz(g, width=1500)
    want_draw = draw.render_png(g, ot.load_layout(lay))
    # the files' bytes against zlib 1.2.13's deflate there: reported, no gate
    out["png_bytes_equal_to_odgi_tpu"] = {
        f: hashlib.sha256(b).hexdigest()[:16] == RENDER_PNG_BYTES.get(f)
        for c in card.values() for f, b in c["files"].items() if f.endswith(".png")}
    out["zlib"] = zlib.ZLIB_RUNTIME_VERSION
    out["pil_installed"] = importlib.util.find_spec("PIL") is not None  # the port never imports it
    out["viz_png_equals_api"] = bool(np.array_equal(
        png.decode(card["viz_path"]["files"]["viz_path.png"]), want_viz))
    out["draw_png_equals_api"] = bool(np.array_equal(
        png.decode(card["draw"]["files"]["draw.png"]), want_draw))

    # the user's chain: viz of the sorted graph, draw of its layout
    sorted_g, sorted_lay = os.path.join(tmp, "cli-sorted.otg"), os.path.join(tmp, "cli.lay")
    chain, chain_walls = {}, {}
    for t, d in dirs.items():
        for argv in (["viz", "-i", sorted_g, "-o", os.path.join(d, "sorted_viz.png")],
                     ["draw", "-i", sorted_g, "-c", sorted_lay, "-p", os.path.join(d, "sorted.png"),
                      "-s", os.path.join(d, "sorted.svg")]):
            if t == "card":
                cli(argv, chain_walls)
            else:
                on_cpu(argv)
        chain[t] = [open(os.path.join(d, f), "rb").read()
                    for f in ("sorted_viz.png", "sorted.png", "sorted.svg")]
    out["chain_walls_s"] = chain_walls
    out["chain_equal_to_cpu"] = chain["card"] == chain["cpu"]
    out["chain_bytes"] = [len(b) for b in chain["card"]]
    say("main_path", path="render", **out)

    if any(out["launches"].values()):
        fail(f"render: kernels launched {out['launches']}")
    if out["differs_from_odgi_tpu"]:
        fail(f"render: differs from odgi_tpu's stored digests: {out['differs_from_odgi_tpu']}")
    if not (out["viz_png_equals_api"] and out["draw_png_equals_api"] and out["chain_equal_to_cpu"]):
        fail(f"render: viz PNG == API {out['viz_png_equals_api']}, draw PNG == API "
             f"{out['draw_png_equals_api']}, sorted chain card == CPU {out['chain_equal_to_cpu']}")
    return out


def phase_render_big(g, keep: dict, tmp: str) -> dict:
    """render_viz of the 1M-node graph after Ygs and draw_png of its layout
    (phase 7's), through the API, each timed; each PNG decodes to the
    array rendered."""
    out = {}
    t0 = time.perf_counter()
    img = viz.render_viz(keep["gYgs"], width=1500)
    out["render_viz_s"] = time.perf_counter() - t0
    path = os.path.join(tmp, "big_viz.png")
    t0 = time.perf_counter()
    png.write(img, path)
    out["viz_png_write_s"] = time.perf_counter() - t0
    out["viz_shape"] = list(img.shape)
    viz_ok = np.array_equal(png.read(path), img)
    path = os.path.join(tmp, "big_draw.png")
    t0 = time.perf_counter()
    draw.draw_png(g, keep["coords"], path)
    out["draw_png_s"] = time.perf_counter() - t0
    want = draw.render_png(g, keep["coords"])
    out["draw_shape"] = list(want.shape)
    out["draw_pixels_set"] = int((want != 255).any(axis=2).sum())
    draw_ok = np.array_equal(png.read(path), want)
    say("main_path", path="render-big", **out, viz_png_ok=viz_ok, draw_png_ok=draw_ok)
    if not (viz_ok and draw_ok):
        fail(f"render-big: PNG decodes to the rendered array: viz {viz_ok}, draw {draw_ok}")
    return out


# ---------------------------------------------------------------------------
# Phase 12: positions, subgraphs, path indexes and analytics
# ---------------------------------------------------------------------------


def position_digests(run: dict) -> dict:
    """render_digest of one command's stdout, stderr and written files."""
    return {"stdout": render_digest(run["stdout"].encode()),
            "stderr": render_digest(run["stderr"].encode()),
            **{f: render_digest(b) for f, b in run["files"].items()}}


def serve_and_ask(module: str, src: str, queries, env=None) -> dict:
    """`python -m <module> server -i src` on a free localhost port: wait
    for it to answer /hi, send `queries` (the last is /stop) and wait for
    it to exit.  A query whose handler raises (the connection closes)
    replies "dropped".  Returns the replies, the exit code, stdout (the
    port number replaced by PORT) and the seconds to the first answer."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    url = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "server", "-i", src, "-p", str(port), "-a", "127.0.0.1"],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        while True:
            try:
                urllib.request.urlopen(f"{url}/hi", timeout=2).read()
                break
            except OSError:
                if proc.poll() is not None or time.perf_counter() - t0 > 120:
                    fail(f"server ({module}) did not come up: exit {proc.poll()}")
                time.sleep(0.2)
        up_s = time.perf_counter() - t0
        replies = []
        for q in queries:
            try:
                replies.append(urllib.request.urlopen(url + q, timeout=10).read().decode())
            except OSError:
                replies.append("dropped")
        out, _ = proc.communicate(timeout=30)
        return dict(replies=replies, rc=proc.returncode,
                    stdout=out.replace(str(port), "PORT"), up_s=up_s)
    finally:
        proc.kill()
        proc.wait()


def position_names(tmp: str, drb) -> dict:
    """POSITION_CMDS' inputs: the DRB1-scale graph `drb` written as .otg
    beside phase 4c's smoke .otg and phase 11's .lay and BED in `tmp`, and
    the output directory."""
    names = dict(g=os.path.join(tmp, "smoke.otg"), lay=os.path.join(tmp, "init.lay"),
                 bed=os.path.join(tmp, "ranges.bed"), drb=os.path.join(tmp, "drb1.otg"),
                 d=os.path.join(tmp, "positions"))
    og_io.save_graph(drb, names["drb"])
    os.makedirs(names["d"], exist_ok=True)
    return names


def phase_positions(tmp: str, dev, rec: Record) -> dict:
    """Every subcommand of the positions, subgraphs, path indexes and
    analytics through the command line on the card (device None), after
    phase 11 (whose .lay and BED it reads): each printout, stderr and
    written file equal to odgi_tpu's (POSITION_DIGESTS, from
    tools/position_digests.py), each command's wall; then `python -m
    odgi_tpu_torch.cli server` from phase 12's .xpt in a subprocess, its
    replies equal to odgi_tpu's (SERVER_REPLIES).  Host code: no kernel
    may launch."""
    names = position_names(tmp, shuffled_graph(*DRB1))
    walls = {}

    def run():
        t0 = time.perf_counter()
        card = render_run(names, lambda argv: cli(argv, walls), POSITION_CMDS)
        wall_s = time.perf_counter() - t0
        server = serve_and_ask("odgi_tpu_torch.cli", os.path.join(names["d"], "smoke.xpt"),
                               SERVER_QUERIES)
        return dict(wall_s=wall_s, card=card, server=server,
                    server_s=time.perf_counter() - t0 - wall_s)

    res = counted("positions", rec, run, levels=())
    card, server = res.pop("card"), res.pop("server")
    out = dict(res, walls_s={}, differs_from_odgi_tpu=[], digests={}, printed_bytes={})
    for key, _, _ in POSITION_CMDS:
        c = card[key]
        out["walls_s"][key] = c["wall_s"]
        out["printed_bytes"][key] = len(c["stdout"])
        out["digests"][key] = position_digests(c)
        if out["digests"][key] != POSITION_DIGESTS.get(key):
            out["differs_from_odgi_tpu"].append(key)
    out["server"] = dict(server, replies_equal_to_odgi_tpu=tuple(server["replies"]) == SERVER_REPLIES)
    say("main_path", path="positions", **out)

    if any(out["launches"].values()):
        fail(f"positions: kernels launched {out['launches']}")
    if out["differs_from_odgi_tpu"]:
        fail(f"positions: differs from odgi_tpu's stored digests: {out['differs_from_odgi_tpu']}")
    if not out["server"]["replies_equal_to_odgi_tpu"] or server["rc"] != 0:
        fail(f"positions: server replies {server['replies']} (exit {server['rc']}), "
             f"odgi_tpu's {list(SERVER_REPLIES)}")
    return out


# ---------------------------------------------------------------------------
# Phase 13: the library surface (import odgi / odgi_ffi), vg_algos,
# mondriaan, layout0 and test
# ---------------------------------------------------------------------------


def library_value(v):
    """A value of the library surface as plain JSON data: a step handle as
    ["step", path, rank, kind], an edge as ["edge", first, second], numpy
    values as Python ones."""
    if hasattr(v, "path_idx"):
        return ["step", v.path_idx, v.rank, v._kind]
    if hasattr(v, "first") and hasattr(v, "second"):
        return ["edge", v.first(), v.second()]
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [library_value(x) for x in v]
    if isinstance(v, dict):
        return [[library_value(k), library_value(x)] for k, x in v.items()]
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, np.integer):
        return int(v)
    return v


def odgi_script(odgi, drb: str, d: str, kw: dict) -> dict:
    """An `import odgi` session on the graph at `drb`: load, iterate a fixed
    set of handles, the edges and the paths, mutate (create_handle,
    create_edge, divide_handle, combine_handles, apply_orientation,
    rewrite_segment, destroy_edge / _handle / _path), serialize and
    to_gfa.  Returns the transcript, the serialized bytes and the GFA."""
    t = []
    rec = lambda *v: t.append(library_value(list(v)))  # noqa: E731
    g = odgi.graph(**kw)
    g.load(drb)
    rec(g.get_node_count(), g.min_node_id(), g.max_node_id(), g.get_path_count())
    hs = []
    g.for_each_handle(lambda h: hs.append(h))
    rec(len(hs), hs[:20], hs[-20:])
    for h in hs[::199][:25]:
        for x in (h, g.flip(h)):
            nb = []
            for left in (False, True):
                seen = []
                g.follow_edges(x, left, lambda y: seen.append(y))
                nb.append(seen)
            rec(x, g.get_id(x), g.get_sequence(x), g.get_length(x), g.get_is_reverse(x),
                g.forward(x), nb, g.get_degree(x, False), g.get_degree(x, True),
                g.get_step_count(x), g.steps_of_handle(x, True))
    edges = []
    g.for_each_edge(lambda e: edges.append(e))
    rec(len(edges), edges[:40], edges[-40:])
    for p in range(g.get_path_count()):
        walk = [g.path_begin(p)]
        for _ in range(5):
            walk.append(g.get_next_step(walk[-1]))
        rec(g.get_path_name(p), g.get_is_circular(p), g.get_step_count_of_path(p), walk,
            [g.get_handle_of_step(s) for s in walk], g.path_back(p), g.path_end(p),
            g.path_front_end(p), g.has_next_step(g.path_back(p)),
            g.get_previous_step(g.path_begin(p)))
    new = g.create_handle("ACGTTGCA")
    g.create_edge(hs[0], new)
    g.create_edge(new, g.flip(hs[1]))
    parts = g.divide_handle(new, [3, 5])
    rec(new, parts, [g.get_sequence(x) for x in parts], g.has_edge(hs[0], parts[0]))
    rec(g.combine_handles(parts))
    rec(g.apply_orientation(g.flip(hs[4])), g.get_sequence(hs[4]))
    s2 = g.get_next_step(g.get_next_step(g.path_begin(0)))
    rec(g.rewrite_segment(g.path_begin(0), s2, [hs[2], g.flip(hs[3])]))
    g.destroy_edge(edges[10].first(), edges[10].second())
    g.destroy_handle(hs[7])
    g.destroy_path(g.get_path_count() - 1)
    rec(g.has_edge(edges[10].first(), edges[10].second()), g.get_node_count(),
        g.get_path_count(), g.get_step_count_of_path(0))
    path = os.path.join(d, "session.og")
    g.serialize(path)
    with open(path, "rb") as f:
        data = f.read()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        g.to_gfa()
    return dict(session=t, serialize=data, to_gfa=buf.getvalue())


def ffi_script(ffi, drb: str, kw: dict) -> list:
    """The `import odgi_ffi` walkthrough (the reference's
    test/python/odgi_ffi.md) on the graph at `drb`: every function but
    odgi_version, over a fixed set of handles and the first steps of each
    path.  Returns the transcript."""
    t = []
    rec = lambda *v: t.append(library_value(list(v)))  # noqa: E731
    rec(ffi.odgi_long_long_size(), ffi.odgi_handle_i_size(), ffi.odgi_step_handle_i_size())
    g = ffi.odgi_load_graph(drb, **kw)
    rec(ffi.odgi_get_node_count(g), ffi.odgi_max_node_id(g), ffi.odgi_min_node_id(g),
        ffi.odgi_get_path_count(g))
    paths, hs = [], []
    ffi.odgi_for_each_path_handle(g, lambda p: paths.append(p))
    rec(paths, ffi.odgi_for_each_handle(g, lambda h: hs.append(h)), len(hs))
    for h in hs[::331][:15]:
        for x in (h, h ^ 1):
            nb, on = [], []
            for left in (False, True):
                seen = []
                ffi.odgi_follow_edges(g, x, left, lambda y: seen.append(y))
                nb.append([(y, ffi.odgi_has_edge(g, y, x) if left else ffi.odgi_has_edge(g, x, y))
                           for y in seen])
            ffi.odgi_for_each_step_on_handle(g, x, lambda s: on.append(s))
            rec(x, ffi.odgi_has_node(g, ffi.odgi_get_id(g, x)), ffi.odgi_get_sequence(g, x),
                ffi.odgi_get_id(g, x), ffi.odgi_get_is_reverse(g, x), ffi.odgi_get_length(g, x),
                ffi.odgi_get_step_count(g, x), nb, on)
    e = g.edge_handle(hs[0], hs[1])
    rec(ffi.odgi_edge_first_handle(g, e), ffi.odgi_edge_second_handle(g, e))
    for p in paths:
        name = ffi.odgi_get_path_name(g, p)
        b, back = ffi.odgi_path_begin(g, p), ffi.odgi_path_back(g, p)
        end, front = ffi.odgi_path_end(g, p), ffi.odgi_path_front_end(g, p)
        rec(name, ffi.odgi_has_path(g, name), ffi.odgi_path_is_empty(g, p),
            ffi.odgi_get_path_handle(g, name), b, back, end, front, ffi.odgi_is_path_end(g, end),
            ffi.odgi_is_path_front_end(g, front), ffi.odgi_step_eq(g, b, back))
        steps = []
        ffi.odgi_for_each_step_in_path(g, p, lambda s: steps.append(s))
        for s in steps[:8] + steps[-2:]:
            rec(ffi.odgi_get_handle_of_step(g, s), ffi.odgi_get_path(g, s),
                ffi.odgi_get_path_handle_of_step(g, s), ffi.odgi_step_path_id(g, s),
                ffi.odgi_step_is_reverse(g, s), ffi.odgi_step_prev_id(g, s),
                ffi.odgi_step_prev_rank(g, s), ffi.odgi_step_next_id(g, s),
                ffi.odgi_step_next_rank(g, s), ffi.odgi_has_next_step(g, s),
                ffi.odgi_has_previous_step(g, s), ffi.odgi_get_next_step(g, s),
                ffi.odgi_get_previous_step(g, s))
    ffi.odgi_free_graph(g)
    rec(ffi.odgi_get_node_count(g))
    return t


def vg_script(odgi, vg, mond, drb: str, kw: dict) -> dict:
    """vg_algos over a fixed set of handles of the graph at `drb` (head /
    tail tests and distances, Dijkstra both ways, sorted id ranges, A* of
    the min case, extend into an empty graph), and mondriaan_sort at
    MONDRIAAN_PARTS parts (and 8 parts weighted by path depth)."""
    c = odgi.graph(**kw)
    c.load(drb)
    g = c.freeze()
    t = []
    rec = lambda *v: t.append(library_value(list(v)))  # noqa: E731
    hs = list(range(0, 2 * g.num_nodes, 397))
    for h in hs:
        rec(h, vg.is_head_node(g, h), vg.is_tail_node(g, h), vg.distance_to_head(g, h, 40),
            vg.distance_to_tail(g, h, 40))
    for h in hs[:4]:
        for left in (False, True):
            rec(h, left, vg.find_shortest_paths(g, h, left))
    rec(vg.sorted_id_ranges(g))
    for a, b in zip(hs[:6], hs[6:12]):
        rec(a, b, vg.a_star(g, (a, 0), (b, 0)))
    into = odgi.graph()
    vg.extend(g, into)
    edges = []
    into.for_each_edge(lambda e: edges.append(e))
    rec(into.get_node_count(), edges)
    out = dict(vg_algos=t)
    for k in MONDRIAAN_PARTS:
        out[f"mondriaan_{k}"] = mond.mondriaan_sort(g, k).tolist()
    out["mondriaan_8_depth"] = mond.mondriaan_sort(g, 8, weight_by_edge_depth=True).tolist()
    return out


def library_session(odgi, ffi, vg, mond, drb: str, d: str, kw: dict) -> dict:
    """render_digest of each part of the library session on `drb` (the
    odgi script's transcript, serialized bytes and GFA; the ffi
    walkthrough; vg_algos; each Mondriaan order), and each part's wall."""
    out, walls = {}, {}
    t0 = time.perf_counter()
    sess = odgi_script(odgi, drb, d, kw)
    walls["odgi"] = time.perf_counter() - t0
    out["odgi_session"] = render_digest(json.dumps(sess["session"]).encode())
    out["odgi_serialize"] = render_digest(sess["serialize"])
    out["odgi_to_gfa"] = render_digest(sess["to_gfa"].encode())
    t0 = time.perf_counter()
    out["ffi"] = render_digest(json.dumps(ffi_script(ffi, drb, kw)).encode())
    walls["ffi"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k, v in vg_script(odgi, vg, mond, drb, kw).items():
        out[k] = render_digest(json.dumps(v).encode())
    walls["vg_mondriaan"] = time.perf_counter() - t0
    return dict(digests=out, walls_s=walls)


def library_names(tmp: str) -> dict:
    """LIBRARY_CMDS' inputs: phase 12's DRB1-scale .otg, phase 10's
    1,000-step graph, and the output directory."""
    names = dict(drb=os.path.join(tmp, "drb1.otg"), small=os.path.join(tmp, "small.otg"),
                 d=os.path.join(tmp, "library"))
    os.makedirs(names["d"], exist_ok=True)
    return names


def port_test(args, block_jax: bool = False) -> dict:
    """`python -m odgi_tpu_torch.cli test -- <args>` in a subprocess from the
    checkout's root (with `block_jax`, the same through `main` with jax made
    unimportable, as on a machine without it): its exit code, the tests it
    passed and the files it says it left out."""
    if block_jax:
        cmd = ["-c", "import sys\nsys.modules['jax'] = None\n"
               "from odgi_tpu_torch.cli.main import main\n"
               "sys.exit(main(['test', '--', *sys.argv[1:]]))\n"]
    else:
        cmd = ["-m", "odgi_tpu_torch.cli", "test", "--"]
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, *cmd, *args], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    passed = re.findall(r"(\d+) passed", res.stdout)
    left = res.stderr.split("that import it: ")[1].split() if "that import it: " in res.stderr else []
    return dict(rc=res.returncode, passed=int(passed[-1]) if passed else 0, left_out=sorted(left),
                summary=res.stdout.strip().splitlines()[-1:] if res.stdout.strip() else [],
                wall_s=time.perf_counter() - t0, stderr_tail=res.stderr[-400:])


def needs_odgi_tpu() -> list:
    """The port's test files that import odgi_tpu or jax: what `test`
    leaves out where jax is not installed."""
    return sorted(os.path.basename(f) for f in glob.glob(os.path.join(REPO, "tests", "test_torch_*.py"))
                  if imports_odgi_tpu(f))


def phase_library(tmp: str, g_ref, rec: Record) -> dict:
    """Phase 13, after phase 12: layout0 through the command line
    (LIBRARY_CMDS) and the library session on the DRB1-scale graph
    (library_session) on the card's machine, each equal to odgi_tpu's
    (LIBRARY_DIGESTS); then a user's script on the card: the compat graph
    of phase 4c's smoke .otg (odgi.graph(), device None), frozen, sorted by
    sort_pipeline("Ygs") on the card -- bit-equal to phase 4's sorted graph
    `g_ref` -- and its order applied to the compat graph with
    apply_ordering, whose frozen graph holds `g_ref`'s nodes in rank order
    (up to groom's flips, which the script does not apply); then the
    port's `test` in a subprocess.  Counted: the chain's Y runs the
    resident 1D kernels."""
    t_phase = time.perf_counter()
    names = library_names(tmp)
    walls = {}

    def run():
        out = {}
        t0 = time.perf_counter()
        out["card"] = render_run(names, lambda argv: cli(argv, walls), LIBRARY_CMDS)
        out["layout0_s"] = time.perf_counter() - t0
        out["session"] = library_session(odgi_compat, odgi_ffi, vg_algos, mondriaan,
                                         names["drb"], names["d"], {})
        t0 = time.perf_counter()
        c = odgi_compat.graph()
        c.load(os.path.join(tmp, "smoke.otg"))
        out["load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        frozen = c.freeze()
        out["freeze_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["sorted"] = ot.sort_pipeline(frozen, "Ygs")
        out["sort_Ygs_s"] = sync_wall(t0)
        out["compat"], out["frozen"] = c, frozen
        return out

    res = counted("library", rec, run, levels=("1d",))
    card, sess = res.pop("card"), res.pop("session")
    c, frozen, g_sorted = res.pop("compat"), res.pop("frozen"), res.pop("sorted")
    out = dict(res, walls_s=dict(sess["walls_s"]), digests=dict(sess["digests"]))
    for key, _, _ in LIBRARY_CMDS:
        out["walls_s"][key] = card[key]["wall_s"]
        out["digests"][key] = position_digests(card[key])
    out["differs_from_odgi_tpu"] = sorted(k for k, v in out["digests"].items()
                                          if v != LIBRARY_DIGESTS.get(k))
    if set(out["digests"]) != set(LIBRARY_DIGESTS):
        fail(f"library: digests of {sorted(out['digests'])}, stored {sorted(LIBRARY_DIGESTS)}")
    out["order_equal_to_phase4"] = same_graph(g_sorted, g_ref)

    # the sort's order and groom's flips, read off the steps: the node of
    # step i had rank old[i] and has rank new[i]
    old, new = frozen.step_handle >> 1, g_sorted.step_handle >> 1
    order = np.full(frozen.num_nodes, -1, np.int64)
    order[new] = old
    flip = np.zeros(frozen.num_nodes, np.int64)
    flip[new] = (frozen.step_handle ^ g_sorted.step_handle) & 1
    t0 = time.perf_counter()
    ids = frozen.node_id
    c.apply_ordering([c.get_handle(int(ids[r])) for r in order])
    reordered = c.freeze()
    out["apply_ordering_s"] = time.perf_counter() - t0
    seqs = [reordered.node_seq(r, bool(flip[r])) for r in range(reordered.num_nodes)]
    out["every_node_on_a_path"] = bool((order >= 0).all())
    out["flipped_by_groom"] = int(flip.sum())
    out["nodes_equal_to_phase4"] = bool(
        out["every_node_on_a_path"]
        and seqs == [g_ref.node_seq(r) for r in range(g_ref.num_nodes)]
        and np.array_equal(reordered.node_id, g_ref.node_id)
        and np.array_equal(reordered.step_handle ^ flip[reordered.step_handle >> 1],
                           g_ref.step_handle))
    out["chain_s"] = out["load_s"] + out["freeze_s"] + out["sort_Ygs_s"] + out["apply_ordering_s"]

    out["jax_installed"] = importlib.util.find_spec("jax") is not None
    out["test"] = port_test(PORT_TEST_ARGS)
    out["test_without_jax"] = port_test(PORT_TEST_ARGS, block_jax=True)
    p1 = strata_plan.plan_run(frozen, derive_config_1d(frozen), one_d=True)
    key = "library/1d"
    rec.bounds[LEVELS_1D][key] = chunk_bounds(p1, True)
    rec.bounds["strata_merge_sum"][key] = [merge_sum_bound(frozen, True)]
    rec.bounds["strata_merge_bcast"][key] = [merge_bcast_bound(frozen, p1["data"].num_slots,
                                                                 True)]
    borrow_times(rec, "smoke", "library")
    say("main_path", path="library", **out)
    say("phase13", wall_s=time.perf_counter() - t_phase)

    if out["differs_from_odgi_tpu"]:
        fail(f"library: differs from odgi_tpu's stored digests: {out['differs_from_odgi_tpu']}")
    if not (out["order_equal_to_phase4"] and out["nodes_equal_to_phase4"]):
        fail(f"library: the compat graph's card sort equals phase 4's: "
             f"{out['order_equal_to_phase4']}; its reordered nodes: {out['nodes_equal_to_phase4']}")
    for n in kernels.NAMES:
        want = p1["groups"] if n in (LEVELS_1D, "strata_merge_sum", "strata_merge_bcast") else 0
        if out["launches"][n] != want:
            fail(f"library: {n} launched {out['launches'][n]} times, expected {want} (the "
                 f"compat script's Y on the resident route)")
    need = needs_odgi_tpu()
    for key, want in (("test", [] if out["jax_installed"] else need), ("test_without_jax", need)):
        tst = out[key]
        if tst["rc"] != 0 or tst["passed"] < 1 or tst["left_out"] != want or not need:
            fail(f"library: `{key}` exit {tst['rc']}, {tst['passed']} passed, left out "
                 f"{tst['left_out']} (expected {want}): {tst['stderr_tail']}")
    return out


# ---------------------------------------------------------------------------
# The kernels line
# ---------------------------------------------------------------------------


def kernel_line(rec: Record) -> dict:
    """One record per kernel: launches and mean time per launch over every
    counted path, the bound of those launches, and the plain version's and
    the library call's time per call on the same graph and dimension
    (weighted by the launches per path and dimension), and the same per
    path; `ms` is the mean of the main path's own event pairs, `spin_ms`
    that of its launches queued behind a spin kernel (SPIN_EVERY).  The
    chain kernels have no launch on a counted path: their
    times and bounds are those of their comparison launches on groups of a
    main path's size."""
    mean = lambda xs: sum(xs) / len(xs) if xs else None
    out = []
    for n in kernels.NAMES:
        common = dict(name=n, route="cuda", source=SOURCES[n], replaces=REPLACES[n],
                      also_replaces=ALSO_REPLACES.get(n),
                      max_abs_err=max(x for v in rec.err[n].values() for x in v))
        if n in CHAIN:
            if rec.events[n] or rec.launches[n]:
                fail(f"{n}: launched on a counted path {rec.launches[n]}")
            per_path = {}
            for k, times in sorted(rec.cmp_ms[n].items()):
                vals = [bound_ms(b) for b in rec.cmp_bounds[n][k]]
                per_path[k] = dict(comparison_launches=len(times), ms=mean(times),
                                   bound_ms=mean([v for v, _ in vals]), bound_by=max(vals)[1])
            times = [t for v in rec.cmp_ms[n].values() for t in v]
            bounds = [bound_ms(b) for v in rec.cmp_bounds[n].values() for b in v]
            if not times:
                fail(f"{n}: no comparison launch was timed")
            plain = [t for v in rec.plain_ms[n].values() for t in v]
            out.append(dict(**common, launches=0, comparison_launches=len(times),
                            ms=mean(times), plain_ms=mean(plain),
                            bound_ms=mean([v for v, _ in bounds]), bound_by=max(bounds)[1],
                            library_ms=None, per_path=per_path))
            continue
        ev, spun = rec.events[n], rec.spun[n]
        launches = sum(len(ev[k]) + len(spun[k]) for k in ev)
        if launches == 0 or launches != sum(rec.launches[n].values()):
            fail(f"{n}: {launches} timed launches, {rec.launches[n]} counted")
        per_path = {}
        for k, times in sorted(ev.items()):
            bl, plain = rec.bounds[n].get(k), rec.plain_ms[n].get(k)
            if not bl or not plain or not spun[k]:
                fail(f"{n}: no bound, plain time or spin-timed launch for {k}")
            vals = [bound_ms(b) for b in bl]
            per_path[k] = dict(launches=len(times) + len(spun[k]), ms=mean(times),
                               spin_ms=mean(spun[k]), spin_launches=len(spun[k]),
                               bound_ms=mean([v for v, _ in vals]), bound_by=max(vals)[1],
                               plain_ms=mean(plain),
                               library_ms=mean(rec.library_ms[n].get(k, [])))
        wsum = lambda f: sum(v["launches"] * v[f] for v in per_path.values()) / launches
        heaviest = max(per_path.values(), key=lambda v: v["launches"] * v["bound_ms"])
        out.append(dict(
            **common, launches=launches,
            ms=sum(sum(v) for v in ev.values()) / sum(len(v) for v in ev.values()),
            spin_ms=wsum("spin_ms"),
            plain_ms=wsum("plain_ms"), bound_ms=wsum("bound_ms"),
            bound_by=heaviest["bound_by"],
            library_ms=wsum("library_ms") if n in LIBRARY else None,
            per_path=per_path,
        ))
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say("device", name=name, count=count, nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    kernels.build()
    build_s = time.perf_counter() - t0
    report = [ln.strip() for ln in kernels.ptxas_report().splitlines()
              if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    say("build", seconds=build_s, ptxas=report,
        levels_clusters={"2d": kernels.levels_clusters(),
                         "1d": kernels.levels_clusters(one_d=True)})

    rec = Record()
    with tempfile.TemporaryDirectory() as tmp:
        gfa = os.path.join(tmp, "smoke.gfa")
        t0 = time.perf_counter()
        write_smoke_gfa(gfa, SMOKE_STEPS, SMOKE_NODES, SMOKE_PATH_STEPS)
        say("gfa", seconds=time.perf_counter() - t0, bytes=os.path.getsize(gfa))
        phase_kernels(ot.parse_gfa(gfa, device=dev), dev, rec)
        smoke, g_smoke, smoke_state = phase_smoke(gfa, tmp, dev, rec)
        snap = phase_options(smoke, smoke_state, tmp, dev, rec)
        phase_cli(gfa, tmp, smoke, smoke_state, dev, rec)
        sampler_in = dict(g=smoke_state["g"], g2=smoke_state["g2"], nt_before=smoke["nt_before"],
                          nt_after_Y=ot.sum_of_path_node_distances(
                              smoke_state["g_Y"], device=dev).all_nt_space, **snap)
        del smoke_state

        t0 = time.perf_counter()
        g_xl = shuffled_graph(XL_STEPS, XL_NODES, XL_PATH_STEPS)
        g_big = shuffled_graph(BIG_STEPS, BIG_NODES, BIG_PATH_STEPS)
        say("graphs", seconds=time.perf_counter() - t0,
            xl=dict(steps=g_xl.num_steps, nodes=g_xl.num_nodes, paths=g_xl.num_paths),
            big=dict(steps=g_big.num_steps, nodes=g_big.num_nodes, paths=g_big.num_paths))
        for label, g in (("xl", g_xl), ("big", g_big)):
            say("schedule", graph=label, **{tag: schedule_stats(g, one_d)
                                            for tag, one_d in (("1d", True), ("2d", False))})
        phase_route_kernels(g_xl, "xl", "xl", dev, rec)
        phase_route_kernels(g_big, "big", "xxl", dev, rec)
        xl, g_xl2 = phase_xl(g_xl, tmp, dev, rec)
        phase_sharded("smoke", g_smoke, smoke["stress_after"], dev, rec, one_device=True)
        phase_sharded("xl", g_xl2, xl["stress_after"], dev, rec)
        del g_xl2
        big_keep = {}
        phase_big(g_big, tmp, dev, rec, big_keep)
        phase_render_big(g_big, big_keep, tmp)
        del g_big, big_keep
        phase_sampler(sampler_in, dev)
        phase_cli_rest(tmp, dev, rec)
        phase_render(tmp, dev, rec)
        phase_positions(tmp, dev, rec)
        phase_library(tmp, g_smoke, rec)

    print(json.dumps(kernel_line(rec)), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
