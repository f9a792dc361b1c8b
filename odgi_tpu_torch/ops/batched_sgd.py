"""The batched PG-SGD path: batches of sampled term pairs merged by a
per-node mean.

The counterpart of the batched half of ``odgi_tpu/ops/sgd.py``
(``SgdData``, ``_sample_pairs``, ``_update_1d/_2d``, ``sgd_1d/2d_run`` and
``sgd_1d/2d_iteration``).  The reference takes this path where it leaves
the strata kernels: graphs under 1,024 steps or with path positions of 2^30
and more, target-path pinning (``-H``), per-iteration snapshots (``-u``),
and delta early stop (``-j``) on a graph past the resident route.  It has
no Pallas kernel there (XLA scatters and one-hot matmuls), so its port is
plain PyTorch on the run's device.

A batch takes B consecutive rows of the step table in a fixed random
permutation (the first steps), draws each pair's second step along the
same path (a Zipf jump with probability 1/2, always while cooling, else
uniform in the path), and moves both endpoints by the mean of the
batch's updates of each node (``index_add_``; the reference's MXU
one-hot merge has no counterpart).  The random words come from an
explicit ``torch.Generator`` seeded from ``cfg.seed``: the reference's
``jax.random`` "rbg" words cannot be reproduced, so the sampler takes its
words as a tensor, and the tests feed it the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .scatter import factored_scatter_add, mean_apply
from .sgd import sgd_schedule
from .zipf import zeta_eta_table, zeta_index, zeta_table, zipf_sample

# Rows of the transposed first-step table (columns of the permuted steps).
A_LO, A_RANK, A_COUNT, A_POS, A_POSEND, A_HANDLE = range(6)
A_COLS = 8
# Columns of the second-step table (true step order).
B_POS, B_POSEND, B_HANDLE = range(3)
B_COLS = 4
PERM_SEED = 421
_M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class SgdData:
    """The sampling tables of one graph, on one device.

    tab_a: i32 (8, 2S) the step table in the default_rng(421) permutation,
        transposed and doubled so any B <= S consecutive columns wrap; rows
        [path first step, rank in path, path step count, pos, pos_end,
        handle, 0, 0].
    tab_b: i32 (S, 4) [pos, pos_end, handle, 0] in step order.
    zetas: f32 quantized zeta table; zeta_eta: f32 (T, 2) [zeta, eta] a
        table entry (``ops/zipf.py``).
    """

    tab_a: torch.Tensor
    tab_b: torch.Tensor
    zetas: torch.Tensor
    zeta_eta: torch.Tensor
    num_steps: int
    num_nodes: int

    @staticmethod
    def build(g, theta: float, space: int, space_max: int, quant_step: int,
              use_paths: Optional[Sequence[int]] = None, perm_seed: int = PERM_SEED,
              device=None) -> "SgdData":
        if use_paths is not None and sorted(use_paths) != list(range(g.num_paths)):
            g = g.keep_paths(sorted(use_paths))
        S = g.num_steps
        handle = g.step_handle.astype(np.int64)
        pos = g.step_pos.astype(np.int64)
        pos_end = pos + g.node_len[handle >> 1]
        lo = g.path_offset[g.step_path].astype(np.int64)

        a = np.zeros((max(S, 1), A_COLS), np.int32)
        b = np.zeros((max(S, 1), B_COLS), np.int32)
        if S:
            a[:, A_LO] = lo
            a[:, A_RANK] = np.arange(S, dtype=np.int64) - lo
            a[:, A_COUNT] = g.path_step_count[g.step_path]
            a[:, A_POS] = pos
            a[:, A_POSEND] = pos_end
            a[:, A_HANDLE] = handle
            a = a[np.random.default_rng(perm_seed).permutation(S)]
            b[:, B_POS] = pos
            b[:, B_POSEND] = pos_end
            b[:, B_HANDLE] = handle
        t = lambda x, dt: torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=device)
        return SgdData(
            tab_a=t(np.concatenate([a, a]).T, torch.int32),
            tab_b=t(b, torch.int32),
            zetas=t(zeta_table(space, space_max, quant_step, theta).astype(np.float32),
                    torch.float32),
            zeta_eta=t(zeta_eta_table(space, space_max, quant_step, theta), torch.float32),
            num_steps=S,
            num_nodes=g.num_nodes,
        )


class Pairs(NamedTuple):
    """One batch of term pairs: the first steps' table columns (8, B) i32,
    the second steps' rows (B, 4) i32, the valid mask (B,) and the second
    random word (B,) (its bits 0-1 pick the 2D endpoints)."""

    cols_a: torch.Tensor
    rows_b: torch.Tensor
    valid: torch.Tensor
    w1: torch.Tensor


def _u24(word: torch.Tensor) -> torch.Tensor:
    """uint32 word (held in int64) -> f32 uniform in [0, 1), 24 bits."""
    return (word >> 8).to(torch.float32) * (2.0 ** -24)


def batch_start(global_batch: int, B: int, S: int) -> int:
    """First column of a batch: (global_batch * B) mod S, the product
    wrapped to int32 as the reference's traced scalars wrap it."""
    prod = (global_batch * B + 2**31) % 2**32 - 2**31
    return prod % S


def sample_pairs(words: torch.Tensor, start: int, data: SgdData, cfg, cooling: bool):
    """One batch of B = cfg.batch_size term pairs from the (2, B) random
    words (any integer dtype holding uint32 values), as the reference's
    `_sample_pairs` does lane for lane: word 0's bit 0 picks Zipf or
    uniform, bit 1 the jump's direction, bits 8-31 the Zipf uniform; word
    1's bits 8-31 the uniform step.  Returns (Pairs, step_b), step_b the
    second steps' i32 indices."""
    B = cfg.batch_size
    width = data.tab_a.shape[1]
    if B > width:
        raise ValueError(f"batch of {B} pairs over a step table of {width // 2} steps")
    start = max(0, min(int(start), width - B))  # dynamic_slice's clamp
    return pairs_from_cols(data.tab_a[:, start:start + B], words, data, cfg, cooling)


def pairs_from_cols(cols_a: torch.Tensor, words: torch.Tensor, data: SgdData, cfg,
                    cooling: bool):
    """The pairs of the first steps `cols_a` (8, ...) (columns of tab_a)
    and the words (2, ...) of the same lane shape; `sample_pairs` after
    its slice.  Every operation is lane-wise, so the lanes may have any
    shape (the sharded sampler's (devices, B))."""
    lo, s_rank, count = cols_a[A_LO], cols_a[A_RANK], cols_a[A_COUNT]
    valid = count > 1

    w = words.to(torch.int64) & _M32
    w0, w1 = w[0], w[1]
    coin_zipf = (w0 & 1) != 0
    coin_dir = (w0 & 2) != 0
    u = _u24(w0)

    backward = ((s_rank > 0) & coin_dir) | (s_rank == count - 1)
    jump_space = torch.clamp(torch.where(backward, s_rank, count - 1 - s_rank),
                             min=1, max=int(cfg.space))
    ze = data.zeta_eta[zeta_index(jump_space, cfg.space_max,
                                  cfg.space_quantization_step).to(torch.int64)]
    zi = zipf_sample(u, jump_space, cfg.theta, ze[..., 0], ze[..., 1])
    s2_zipf = torch.where(backward, s_rank - zi, s_rank + zi)
    s2_unif = torch.floor(_u24(w1) * count.to(torch.float32)).to(torch.int32)
    s2 = torch.where(coin_zipf | bool(cooling), s2_zipf, s2_unif)
    s2 = torch.minimum(torch.clamp_min(s2, 0), count - 1)
    step_b = lo + s2
    return Pairs(cols_a, data.tab_b[step_b.to(torch.int64)], valid, w1), step_b


def endpoints_2d(coin: torch.Tensor, handle: torch.Tensor, pos0: torch.Tensor,
                 pos1: torch.Tensor):
    """The endpoint index (into the (2N, 2) coordinates) and the path
    position of one side of each pair: the coin picks the step's start or
    end, turned by the step's orientation (the reference's
    `_endpoints_2d`)."""
    rev = (handle & 1) != 0
    pos = torch.where(coin, pos1, pos0)
    use_other = torch.where(coin, ~rev, rev)
    return 2 * (handle >> 1) + use_other.to(torch.int32), pos


def pair_acc_1d(table: torch.Tensor, pairs: Pairs, eta, base=0):
    """The 1D pair updates of `pairs` (lanes of any shape) against the
    positions `table` (rows, 1), summed into the (rows, 2) [dx, count]
    accumulator; each lane's nodes are offset by `base` (the sharded
    sampler's replica times its rows).  Returns (acc, delta, valid), the
    last two flat over the lanes.  The counts are the valid pairs: a path
    of one step or a pair at distance 0 moves nothing."""
    cols_a, rows_b, valid, _ = pairs
    i = ((cols_a[A_HANDLE] >> 1).to(torch.int64) + base).reshape(-1)
    j = ((rows_b[..., B_HANDLE] >> 1).to(torch.int64) + base).reshape(-1)
    term = (cols_a[A_POS] - rows_b[..., B_POS]).abs().to(torch.float32).reshape(-1)
    valid = valid.reshape(-1) & (term != 0)
    mu = torch.clamp_max(eta * (1.0 / torch.clamp_min(term, 1e-30)), 1.0)
    dx = table[i, 0] - table[j, 0]
    dx = torch.where(dx == 0.0, 1e-9, dx)
    mag = dx.abs()
    delta = mu * (mag - term) / 2.0
    r = torch.where(valid, delta / mag * dx, 0.0)
    v = valid.to(torch.float32)
    upd = torch.stack([torch.cat([-r, r]), torch.cat([v, v])], dim=1)
    return factored_scatter_add(table.shape[0], torch.cat([i, j]), upd), delta, valid


def pair_acc_2d(table: torch.Tensor, pairs: Pairs, eta, base=0):
    """The 2D pair updates against the endpoint coordinates `table`
    (rows, 2), summed into the (rows, 3) [dx, dy, count] accumulator; as
    `pair_acc_1d`.  The term distance has a 1e-9 floor."""
    cols_a, rows_b, valid, w1 = pairs
    ep_a, pos_a = endpoints_2d((w1 & 1) != 0, cols_a[A_HANDLE], cols_a[A_POS],
                               cols_a[A_POSEND])
    ep_b, pos_b = endpoints_2d((w1 & 2) != 0, rows_b[..., B_HANDLE], rows_b[..., B_POS],
                               rows_b[..., B_POSEND])
    ia = (ep_a.to(torch.int64) + base).reshape(-1)
    ib = (ep_b.to(torch.int64) + base).reshape(-1)
    term = torch.clamp_min((pos_a - pos_b).abs().to(torch.float32), 1e-9).reshape(-1)
    mu = torch.clamp_max(eta / term, 1.0)
    d = table[ia] - table[ib]
    dx = torch.where(d[:, 0] == 0.0, 1e-9, d[:, 0])
    dy = d[:, 1]
    # the correctly rounded f32 root (see strata_sgd._chunk_2d)
    mag = torch.sqrt((dx * dx + dy * dy).to(torch.float64)).to(torch.float32)
    delta = mu * (mag - term) / 2.0
    valid = valid.reshape(-1)
    r = torch.where(valid, delta / mag, 0.0)
    v = valid.to(torch.float32)
    upd = torch.cat([torch.stack([-r * dx, -r * dy, v], dim=1),
                     torch.stack([r * dx, r * dy, v], dim=1)])
    return factored_scatter_add(table.shape[0], torch.cat([ia, ib]), upd), delta, valid


def update_1d(X: torch.Tensor, pairs: Pairs, eta: torch.Tensor, pin=None):
    """One 1D batch (the reference's `_update_1d`, scatter form): returns
    the new f32 positions and the batch's max |delta| over valid pairs.
    Pinned nodes keep their old value."""
    acc, delta, valid = pair_acc_1d(X[:, None], pairs, eta)
    Xn = mean_apply(X[:, None], acc)[:, 0]
    if pin is not None:
        Xn = torch.where(pin, X, Xn)
    return Xn, torch.where(valid, delta.abs(), 0.0).max()


def update_2d(coords: torch.Tensor, pairs: Pairs, eta: torch.Tensor, pin_ep=None):
    """One 2D batch (the reference's `_update_2d`, scatter form) on the
    (2N, 2) f32 coordinates; returns them and the batch's max |delta|.
    Pinned endpoints keep their old value."""
    acc, delta, valid = pair_acc_2d(coords, pairs, eta)
    out = mean_apply(coords, acc)
    if pin_ep is not None:
        out = torch.where(pin_ep[:, None], coords, out)
    return out, torch.where(valid, delta.abs(), 0.0).max()


def make_generator(cfg, device) -> torch.Generator:
    """The run's random stream: a generator on `device` seeded from
    cfg.seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg.seed))
    return gen


def draw_words(gen: torch.Generator, B: int, device) -> torch.Tensor:
    """(2, B) uint32 random words, held in int64."""
    return torch.randint(0, 2**32, (2, B), generator=gen, device=device, dtype=torch.int64)


def sgd_iteration(x, gen, eta, it: int, data: SgdData, cfg, cooling: bool, one_d: bool,
                  pin=None):
    """One iteration of cfg.num_batches batches (the reference's
    `sgd_1d_iteration` / `sgd_2d_iteration`); returns the coordinates and
    the iteration's max |delta|, a 0-d tensor on the device."""
    nb, B = cfg.num_batches, cfg.batch_size
    update = update_1d if one_d else update_2d
    dmax = torch.zeros((), dtype=torch.float32, device=x.device)
    for b in range(nb):
        pairs, _ = sample_pairs(draw_words(gen, B, x.device),
                                batch_start(it * nb + b, B, data.num_steps), data, cfg, cooling)
        x, bmax = update(x, pairs, eta, pin)
        dmax = torch.maximum(dmax, bmax)
    return x, dmax


def sgd_run(x, data: SgdData, cfg, one_d: bool, pin=None, snapshot_cb=None) -> dict:
    """The whole run from the f32 coordinates `x` (the reference's
    `sgd_*_run` and its per-iteration driver).  1D cools after
    first_cooling_iteration, 2D from it on: the reference's quirk, kept.
    After each iteration `snapshot_cb(it, host f64 array)` is called (one
    host sync a snapshot), and with cfg.delta > 0 the run stops after the
    first iteration whose max |delta| is at most delta (one host sync an
    iteration).  Returns dict(x, iterations, delta_max)."""
    etas = sgd_schedule(1.0 / cfg.eta_max, 1.0, cfg.iter_max,
                        cfg.iter_with_max_learning_rate, cfg.eps)
    eta_t = torch.as_tensor(etas.astype(np.float32), device=x.device)
    gen = make_generator(cfg, x.device)
    fc = cfg.first_cooling_iteration
    delta_max = []
    it = -1
    for it in range(cfg.iter_max):
        cooling = it > fc if one_d else it >= fc
        x, dmax = sgd_iteration(x, gen, eta_t[it], it, data, cfg, cooling, one_d, pin)
        if snapshot_cb is not None:
            snapshot_cb(it, x.to(torch.float64).cpu().numpy())
        if cfg.delta > 0:
            delta_max.append(float(dmax))
            if delta_max[-1] <= cfg.delta:
                break
    return dict(x=x, iterations=it + 1, delta_max=delta_max)


def path_sgd_1d_batched(g, cfg, x0=None, pin_nodes=None, snapshot_cb=None,
                        device=None) -> dict:
    """1D PG-SGD on the batched path over graph `g` (the kept paths' graph
    when the caller subsets them); positions start at `x0` or the node
    offsets.  Returns `sgd_run`'s dict, x as f64 (N,) on `device`."""
    data = SgdData.build(g, cfg.theta, cfg.space, cfg.space_max,
                         cfg.space_quantization_step, device=device)
    x = torch.as_tensor(g.node_offset.astype(np.float32) if x0 is None
                        else np.asarray(x0, np.float32), device=device)
    pin = None if pin_nodes is None else torch.as_tensor(np.asarray(pin_nodes, bool),
                                                         device=device)
    out = sgd_run(x, data, cfg, True, pin, snapshot_cb)
    out["x"] = out["x"].to(torch.float64)
    return out


def path_sgd_2d_batched(g, coords0, cfg, pin_nodes=None, snapshot_cb=None,
                        device=None) -> dict:
    """2D PG-SGD on the batched path from the (2N, 2) `coords0`; returns
    `sgd_run`'s dict, x as f64 (2N, 2) on `device`."""
    data = SgdData.build(g, cfg.theta, cfg.space, cfg.space_max,
                         cfg.space_quantization_step, device=device)
    x = torch.as_tensor(np.asarray(coords0, np.float32), device=device)
    pin = None if pin_nodes is None else torch.as_tensor(
        np.repeat(np.asarray(pin_nodes, bool), 2), device=device)
    out = sgd_run(x, data, cfg, False, pin, snapshot_cb)
    out["x"] = out["x"].to(torch.float64)
    return out
