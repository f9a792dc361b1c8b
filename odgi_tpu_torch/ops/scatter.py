"""The scatter-add and the per-row mean merge of the batched PG-SGD.

The counterpart of ``odgi_tpu/ops/scatter.py``.  There the scatter is a
one-hot factored matmul, so that the TPU's systolic array does the
random-index work its scalar core would serialize, and the gather is one
too.  They have no Pallas kernel, and on the card the same semantics are
one indexing (the gather, which the port writes as indexing where it
gathers) or one ``index_add_`` each, so here they are plain tensor
functions on the run's device.  ``index_add_`` on the card adds in no fixed
order: results agree with the CPU within rounding, not bit for bit.

The reference's ``scatter_mean_apply(table, idx_list, upd_list, valid)`` is
``mean_apply(table, factored_scatter_add(M, idx, [upd, valid]))`` here: the
batched path and the sharded sampler build the accumulator in one pass
(``batched_sgd.pair_acc_1d/2d``), and the sampler sums it over devices
before it takes the mean.
"""

from __future__ import annotations

import torch


def factored_scatter_add(shape_m: int, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """(shape_m, C) accumulator of the rows `values` (B, C) summed at the
    rows `idx` (B,)."""
    acc = torch.zeros((shape_m, values.shape[1]), dtype=values.dtype, device=values.device)
    acc.index_add_(0, idx.to(torch.int64), values)
    return acc


def mean_apply(table: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """table (M, C) + the mean of the updates each row received, from the
    (M, C + 1) accumulator [update sums, count]; a row without a count
    keeps its value."""
    return table + acc[:, :-1] / torch.clamp_min(acc[:, -1:], 1.0)
