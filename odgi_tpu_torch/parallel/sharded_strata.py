"""Multi-device 2D PG-SGD on the resident strata kernels.

The counterpart of ``odgi_tpu/parallel/sharded_pallas.py``
(``path_sgd_2d_pallas_sharded``), which launches the resident 2D Pallas
kernel ``_make_kernel_2d`` once per device and iteration.  Here every
device runs the port's resident kernel family: per merge group
``strata_chunks_2d_levels``, then ``strata_merge_sum`` and
``strata_merge_bcast`` (no route check and no relabel, as the reference).

- Node coordinates are replicated.  Each iteration every device starts from
  the consensus: its f64 coordinates the consensus, its base planes the f32
  consensus at each slot's endpoints, its drift zero.
- Device d draws its own chunk scalars (``per_device_streams``): seed
  (seed + 0x9E3779B9 d) & 0x7FFFFFFF at the plan's chunks per iteration.
- Device d's chunk with local index c has global index d * chunks + c (its
  coins and its eta row), as the reference's meta base d * total_chunks.
- After an iteration the consensus adds the mean of the devices' changes of
  the coordinates, summed in f64 in device order.

One plan holds every device (``stacked_plan``): the devices' streams one
after the other, n_dev times the merge groups, the eta table tiled n_dev
times.  So ``StrataState`` builds the planes, the merge index and the
conflict levels once for all devices, and device d's iteration i is the
groups d * groups + i * mpi ... + mpi - 1 of it.  The planes are read-only
and shared.

Two modes, chosen by the caller:
- distributed: when ``torch.distributed`` is initialized, each rank is one
  device (n_dev = the world size) and runs its own stream; the ranks
  all_gather their (2, E) f64 changes and fold them in rank order (an
  all_reduce would sum in an order the backend picks).  gloo runs on the
  CPU, NCCL on the card with one GPU a rank; anything else raises;
- simulated: otherwise n_dev devices (default 1) run one after the other on
  `device`, the reference's ``simulate``, with the same fold.  Both modes
  give the same coordinates bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..ops.sgd import derive_config_2d
from ..ops.strata_plan import _host_chunk_scalars, plan_run
from ..ops.strata_sgd import StrataState

SEED_STRIDE = 0x9E3779B9  # device d's seed: (seed + SEED_STRIDE * d) & 0x7FFFFFFF


def per_device_streams(g, cfg, p: dict, n_dev: int) -> np.ndarray:
    """(n_dev, 2, chunks) i32: each device's chunk scalars (window block o,
    jump D) over the whole run of plan `p` of graph `g`.

    Device 0's are the plan's own.  Device d > 0 draws the same
    distributions from its own seed at the plan's chunks per iteration, not
    from a plan of its own, whose valid-pair fraction could give another
    cpi."""
    if p["data"].num_steps != g.num_steps or p["data"].one_d:
        raise ValueError("per_device_streams: `p` is not a 2D plan of `g`")
    out = np.empty((n_dev, 2, len(p["o_blk"])), np.int32)
    out[0, 0], out[0, 1] = p["o_blk"], p["d_arr"]
    for d in range(1, n_dev):
        cfg_d = dataclasses.replace(cfg, seed=(cfg.seed + SEED_STRIDE * d) & 0x7FFFFFFF)
        out[d, 0], out[d, 1], _ = _host_chunk_scalars(cfg_d, p["data"], p["cpi"], one_d=False)
    return out


def stacked_plan(g, cfg, n_dev: int) -> dict:
    """One 2D plan of every device's chunks: ``plan_run``'s, with the
    devices' streams concatenated in device order, n_dev times its merge
    groups and its eta table tiled n_dev times (eta[gl // cpi] is then
    iteration i's rate on every device); cgs and cpi unchanged.  The
    valid-pair counts of ``plan_run`` are device 0's alone, so they are
    left out."""
    p = plan_run(g, cfg, one_d=False)
    s = per_device_streams(g, cfg, p, n_dev)
    out = dict(p, o_blk=s[:, 0].reshape(-1), d_arr=s[:, 1].reshape(-1),
               groups=n_dev * p["groups"], eta_table=np.tile(p["eta_table"], n_dev),
               eta_arr=np.tile(p["eta_arr"], n_dev), total_slots=n_dev * p["total_slots"])
    del out["total_valid"], out["valid_frac"]
    return out


def check_world(world_size: int, backend: str, device: torch.device) -> None:
    """Raise unless `backend` serves `device` (gloo the CPU, NCCL the card)
    and, for NCCL, every rank has a GPU of its own."""
    want = "nccl" if device.type == "cuda" else "gloo"
    if backend != want:
        raise RuntimeError(f"odgi_tpu_torch: a sharded run on {device.type} needs the "
                           f"{want} backend, not {backend}")
    if backend == "nccl" and world_size > torch.cuda.device_count():
        raise RuntimeError(f"odgi_tpu_torch: {world_size} NCCL ranks need a GPU each; "
                           f"{torch.cuda.device_count()} are visible")


def restart_replica(st: StrataState, consensus: torch.Tensor, pad: torch.Tensor,
                    ends: torch.Tensor) -> None:
    """A device's replica from the consensus (2, E) f64: coordinates, base
    planes [xf, xr, yf, yr] = f32 of the consensus at each slot's endpoints
    `ends` (2L,) = [ep, ep ^ 1], drift zero.  `pad` (2, E_cap) f32 takes the
    rounded consensus (rounding, then gathering, gives the gather's
    rounding) and keeps 0 at the pad slots' dummy endpoints; the gather
    writes straight into the base planes, viewed as (2, 2L)."""
    st.coords.copy_(consensus)
    pad[:, :consensus.shape[1]] = consensus
    torch.index_select(pad, 1, ends, out=st.base.view(2, -1))
    st.drift.zero_()


def gather_changes(change: torch.Tensor, n_dev: int) -> list:
    """Every rank's change, in rank order."""
    out = [torch.empty_like(change) for _ in range(n_dev)]
    dist.all_gather(out, change)
    return out


def fold_consensus(consensus: torch.Tensor, changes: list) -> torch.Tensor:
    """consensus + (changes[0] + changes[1] + ...) / n in f64: the mean
    change, summed in device order."""
    total = changes[0]
    for c in changes[1:]:
        total = total + c
    return consensus + total / len(changes)


def path_sgd_2d_strata_sharded(g, coords0, cfg=None, n_dev: Optional[int] = None,
                               device=None) -> torch.Tensor:
    """Multi-device 2D PG-SGD from the (2N, 2) coordinates `coords0`;
    returns f64 (2N, 2) coordinates on `device` (None: the card).

    With ``torch.distributed`` initialized, this rank is one of n_dev =
    world-size devices (`n_dev`, if given, must equal it); otherwise `n_dev`
    devices (default 1) run one after the other on `device`."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = derive_config_2d(g)
    if not (g.path_step_count > 1).any():
        return torch.as_tensor(np.asarray(coords0, np.float64), device=dev)
    distributed = dist.is_available() and dist.is_initialized()
    if distributed:
        world = dist.get_world_size()
        if n_dev is not None and n_dev != world:
            raise ValueError(f"n_dev {n_dev} differs from the world size {world}")
        check_world(world, dist.get_backend(), dev)
        n_dev, mine = world, [dist.get_rank()]
    else:
        n_dev = 1 if n_dev is None else int(n_dev)
        if n_dev < 1:
            raise ValueError(f"n_dev must be at least 1, not {n_dev}")
        mine = range(n_dev)

    st = StrataState.build(g, cfg, np.asarray(coords0, np.float64), False, dev, "resident",
                           plan=stacked_plan(g, cfg, n_dev))
    per_dev = st.plan["groups"] // n_dev
    mpi = per_dev // cfg.iter_max
    ends = torch.cat([st.mi.ep, st.mi.ep ^ 1])
    pad = torch.zeros(st.upd.shape, dtype=torch.float32, device=dev)
    consensus = st.coords.clone()
    for i in range(cfg.iter_max):
        changes = []
        for d in mine:
            restart_replica(st, consensus, pad, ends)
            g0 = d * per_dev + i * mpi
            for gid in range(g0, g0 + mpi):
                st.run_group(gid)
            changes.append(st.coords - consensus)
        if distributed:
            changes = gather_changes(changes[0], n_dev)
        consensus = fold_consensus(consensus, changes)
    return consensus.T.contiguous()


def run_rank(rank: int, world_size: int, init_method: str, backend: str, g, coords0, cfg,
             out_path: str) -> None:
    """One rank of a distributed run, the target of a spawned process (it
    imports torch and this package only): join the group (gloo: the CPU;
    NCCL: GPU `rank`), run `path_sgd_2d_strata_sharded`, save the
    coordinates to `out_path` (.npy) and leave the group."""
    device = torch.device("cuda", rank) if backend == "nccl" else torch.device("cpu")
    check_world(world_size, backend, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    try:
        out = path_sgd_2d_strata_sharded(g, coords0, cfg, device=device)
        np.save(out_path, out.cpu().numpy())
    finally:
        dist.destroy_process_group()
