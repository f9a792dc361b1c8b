"""Multi-device PG-SGD on the batched sampler: replicated coordinates,
sharded pair sampling.

The counterpart of ``odgi_tpu/parallel/sharded.py`` (``make_sharded_sgd_1d/2d``,
``sharded_layout``, ``sharded_sort_order``), which runs the batched path of
``ops/batched_sgd.py`` data-parallel over a mesh.  It has no Pallas kernel
there (XLA scatters and one-hot matmuls), so here it is plain PyTorch on the
run's device.

- The coordinates are replicated.  Device d of n_dev samples its own pairs:
  the batch of global index (it * num_batches + b) * n_dev + d of the
  permuted step table, and its own random words.
- consensus "iteration" (the default): each device compounds its own
  replica through the iteration's num_batches batches, then
  x += sum_d(local_d - x) / n_dev once an iteration.
- consensus "batch": the devices' accumulators are summed every batch
  round, which equals one batch of n_dev * B pairs.
- 1D cools after first_cooling_iteration, 2D from it on (the reference's
  quirk, kept).

The words: device d draws from its own ``torch.Generator`` seeded with
``device_seed(cfg.seed, d)``, so a simulated and a distributed run draw the
same words.  The reference's ``jax.random`` keys cannot be reproduced; the
entry points take a word source ``words(it, b, d) -> (2, B)`` instead, so
the tests can feed the reference's words.

Two modes, chosen by the caller:
- simulated (the default, n_dev devices on one device): the devices are a
  leading dimension of the replicas and of the sampled lanes, so a batch
  round is one set of launches for every device;
- distributed: when ``torch.distributed`` is initialized, each rank is one
  device (n_dev = the world size); ``all_reduce(SUM)`` takes the place of
  the reference's ``psum``.  gloo runs on the CPU, NCCL on the card with
  one GPU a rank (``sharded_strata.check_world``); anything else raises.
The two agree within rounding: the sums over devices run in another order.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..algorithms.layout import init_layout
from ..algorithms.path_sgd_sort import order_from_x
from ..device import resolve_device
from ..ops.batched_sgd import (SgdData, batch_start, draw_words, pair_acc_1d, pair_acc_2d,
                               pairs_from_cols, sample_pairs)
from ..ops.scatter import mean_apply
from ..ops.sgd import derive_config_1d, derive_config_2d, sgd_schedule
from .sharded_strata import SEED_STRIDE, check_world

CONSENSUS = ("iteration", "batch")

# words(it, b, d) -> (2, B) uint32 values in an integer tensor
WordSource = Callable[[int, int, int], torch.Tensor]


def device_seed(seed: int, d: int) -> int:
    """Device d's generator seed: (seed + SEED_STRIDE * d) & 0x7FFFFFFF."""
    return (int(seed) + SEED_STRIDE * d) & 0x7FFFFFFF


def generator_words(cfg, devs, device) -> WordSource:
    """The run's word source: one generator a device of `devs`, seeded by
    `device_seed`; each call draws the next (2, B) words of device d's
    stream."""
    gens = {}
    for d in devs:
        gens[d] = torch.Generator(device=device)
        gens[d].manual_seed(device_seed(cfg.seed, d))
    return lambda it, b, d: draw_words(gens[d], cfg.batch_size, device)


def local_acc_2d(coords: torch.Tensor, words: torch.Tensor, start: int, data: SgdData, cfg,
                 eta, cooling: bool) -> torch.Tensor:
    """One device's (M, 3) [dx, dy, count] accumulator for one local batch
    of the (2, B) `words` from column `start`, against the (M, 2) f32
    coordinates (the reference's `_local_acc_2d`)."""
    pairs, _ = sample_pairs(words, start, data, cfg, cooling)
    return pair_acc_2d(coords, pairs, eta)[0]


def local_acc_1d(X: torch.Tensor, words: torch.Tensor, start: int, data: SgdData, cfg,
                 eta, cooling: bool) -> torch.Tensor:
    """One device's (N, 2) [dx, count] accumulator for one local 1D batch
    against the (N,) f32 positions (the reference's `_local_acc_1d`)."""
    pairs, _ = sample_pairs(words, start, data, cfg, cooling)
    return pair_acc_1d(X[:, None], pairs, eta)[0]


def _world(n_dev: Optional[int], device: torch.device):
    """(n_dev, the devices this process runs, distributed?)."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_dev is not None and n_dev != world:
            raise ValueError(f"n_dev {n_dev} differs from the world size {world}")
        check_world(world, dist.get_backend(), device)
        return world, [dist.get_rank()], True
    n_dev = 1 if n_dev is None else int(n_dev)
    if n_dev < 1:
        raise ValueError(f"n_dev must be at least 1, not {n_dev}")
    return n_dev, list(range(n_dev)), False


def batch_starts(cfg, num_batches: int, n_dev: int, devs, S: int, width: int) -> np.ndarray:
    """i64 (iter_max, num_batches, len(devs)): each device's first column
    of each batch round, clamped as ``sample_pairs`` clamps it."""
    B = cfg.batch_size
    if B > width:
        raise ValueError(f"batch of {B} pairs over a step table of {width // 2} steps")
    it = np.arange(cfg.iter_max, dtype=np.int64)[:, None, None]
    b = np.arange(num_batches, dtype=np.int64)[None, :, None]
    out = batch_start((it * num_batches + b) * n_dev + np.asarray(devs, np.int64), B, S)
    return np.clip(out, 0, width - B)


def _make(cfg, num_batches: int, n_dev: Optional[int], consensus: str, one_d: bool):
    if consensus not in CONSENSUS:
        raise ValueError(f"consensus must be one of {CONSENSUS}, not {consensus!r}")
    per_iter = consensus == "iteration"
    acc_fn = pair_acc_1d if one_d else pair_acc_2d
    fc = cfg.first_cooling_iteration

    def run(x: torch.Tensor, etas: torch.Tensor, data: SgdData,
            words: Optional[WordSource] = None) -> torch.Tensor:
        dev = x.device
        n, devs, distributed = _world(n_dev, dev)
        if words is None:
            words = generator_words(cfg, devs, dev)
        B, D = cfg.batch_size, len(devs)
        starts = torch.as_tensor(batch_starts(cfg, num_batches, n, devs, data.num_steps,
                                              data.tab_a.shape[1]), device=dev)
        lanes = torch.arange(B, device=dev)
        R = D if per_iter else 1
        shape = x.shape
        x = x.reshape(shape[0], -1)
        M = x.shape[0]
        # each device's lanes land in its own replica (one replica in "batch")
        base = ((torch.arange(D, device=dev) if per_iter else
                 torch.zeros(D, dtype=torch.int64, device=dev)) * M)[:, None]
        for it in range(cfg.iter_max):
            eta = etas[it]
            cooling = it > fc if one_d else it >= fc
            local = x.expand(R, *x.shape).clone()
            for b in range(num_batches):
                w = torch.stack([words(it, b, d).to(dev) for d in devs], dim=1)
                cols = data.tab_a[:, starts[it, b][:, None] + lanes]
                pairs, _ = pairs_from_cols(cols, w, data, cfg, cooling)
                flat = local.reshape(R * M, -1)
                acc = acc_fn(flat, pairs, eta, base)[0]
                if distributed and not per_iter:
                    dist.all_reduce(acc)
                local = mean_apply(flat, acc).reshape(local.shape)
            if per_iter:
                drift = (local - x).sum(0)
                if distributed:
                    dist.all_reduce(drift)
                x = x + drift / n
            else:
                x = local[0]
        return x.reshape(shape)

    return run


def make_sharded_sgd_2d(cfg, num_batches: int, n_dev: Optional[int] = None,
                        consensus: str = "iteration"):
    """The multi-device 2D run: fn(coords, etas, data, words=None) ->
    coords, the (2N, 2) f32 coordinates after cfg.iter_max iterations of
    `num_batches` batch rounds on coords' device, at the etas (iter_max,)
    f32 of that device.  Simulated at `n_dev` devices (default 1), or one
    rank a device when ``torch.distributed`` is initialized.  `words`
    replaces the devices' generators (``WordSource``)."""
    return _make(cfg, num_batches, n_dev, consensus, one_d=False)


def make_sharded_sgd_1d(cfg, num_batches: int, n_dev: Optional[int] = None,
                        consensus: str = "iteration"):
    """The multi-device 1D run on the (N,) f32 positions; as
    `make_sharded_sgd_2d`."""
    return _make(cfg, num_batches, n_dev, consensus, one_d=True)


def sharded_positions(g, x0, cfg, one_d: bool, n_dev: Optional[int] = None,
                      consensus: str = "iteration", device=None,
                      words: Optional[WordSource] = None,
                      num_batches: Optional[int] = None) -> torch.Tensor:
    """The sharded run of `g` from the host start `x0` ((N,) positions in
    1D, (2N, 2) coordinates in 2D) at the schedule of `cfg`, num_batches
    rounds an iteration (default cfg.num_batches): f32 on `device` (None:
    the card)."""
    dev = resolve_device(device)
    make = make_sharded_sgd_1d if one_d else make_sharded_sgd_2d
    fn = make(cfg, cfg.num_batches if num_batches is None else num_batches, n_dev, consensus)
    etas = sgd_schedule(1.0 / cfg.eta_max, 1.0, cfg.iter_max, cfg.iter_with_max_learning_rate,
                        cfg.eps)
    data = SgdData.build(g, cfg.theta, cfg.space, cfg.space_max, cfg.space_quantization_step,
                         device=dev)
    return fn(torch.as_tensor(np.asarray(x0, np.float32), device=dev),
              torch.as_tensor(etas.astype(np.float32), device=dev), data, words)


def sharded_layout(g, cfg=None, init_mode: str = "d", seed: int = 9399220,
                   n_dev: Optional[int] = None, consensus: str = "iteration", device=None,
                   words: Optional[WordSource] = None) -> np.ndarray:
    """Multi-device 2D layout of `g` from init_layout(g, init_mode, seed)
    at the default config (or `cfg`); returns the f64 (2N, 2) coordinates.
    Runs on `device` (None: the card)."""
    cfg = derive_config_2d(g) if cfg is None else cfg
    out = sharded_positions(g, init_layout(g, init_mode, seed), cfg, False, n_dev, consensus,
                            device, words)
    return out.to(torch.float64).cpu().numpy()


def sharded_sort_order(g, cfg=None, n_dev: Optional[int] = None,
                       consensus: str = "iteration", device=None,
                       words: Optional[WordSource] = None) -> np.ndarray:
    """Multi-device 1D PG-SGD node order of `g` (the ``sort -Y`` step,
    data-parallel) from the node offsets at the default config (or `cfg`):
    ``order_from_x`` of the positions.  Runs on `device` (None: the
    card)."""
    cfg = derive_config_1d(g) if cfg is None else cfg
    X = sharded_positions(g, g.node_offset, cfg, True, n_dev, consensus, device, words)
    return order_from_x(g, X.to(torch.float64).cpu().numpy())


def run_rank(rank: int, world_size: int, init_method: str, backend: str, g, cfg, one_d: bool,
             consensus: str, out_path: str) -> None:
    """One rank of a distributed run, the target of a spawned process:
    join the group (gloo: the CPU; NCCL: GPU `rank`), run `g` from its
    default start (the node offsets in 1D, init mode d in 2D), save the
    f32 result to `out_path` (.npy) and leave the group."""
    device = torch.device("cuda", rank) if backend == "nccl" else torch.device("cpu")
    check_world(world_size, backend, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    try:
        x0 = g.node_offset if one_d else init_layout(g, "d")
        out = sharded_positions(g, x0, cfg, one_d, consensus=consensus, device=device)
        np.save(out_path, out.cpu().numpy())
    finally:
        dist.destroy_process_group()
