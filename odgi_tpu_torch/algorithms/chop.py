"""Chop: split nodes longer than k bp into chains (``odgi chop -c k``),
the counterpart of ``odgi_tpu/algorithms/chop.py``.

Vectorized over the flat arrays: nodes map to runs of pieces, edges
re-attach to chain ends, and every path step expands into the oriented
piece chain.
"""

from __future__ import annotations

import numpy as np

from ..core.graph import GraphTensors, handle_rank


def chop(g: GraphTensors, k: int) -> GraphTensors:
    """Split every node longer than k into ceil(len/k) pieces of <= k bp."""
    assert k >= 1
    n = g.num_nodes
    lens = g.node_len.astype(np.int64)
    pieces = np.maximum(1, -(-lens // k))  # per-node piece count
    new_n = int(pieces.sum())
    base = np.cumsum(pieces) - pieces  # first new rank per old node

    # new node lengths: k for all but the last piece of each node
    new_len = np.full(new_n, k, dtype=np.int64)
    last_idx = base + pieces - 1
    new_len[last_idx] = lens - (pieces - 1) * k
    new_off = np.zeros(new_n + 1, dtype=np.int64)
    np.cumsum(new_len, out=new_off[1:])
    # sequence unchanged: pieces are consecutive slices in the same order
    new_seq = g.seq.copy()

    def map_end_handle(h):
        """Map an old packed handle to the piece handle at its 'outgoing'
        end: forward -> last piece forward, reverse -> first piece reverse."""
        h = np.asarray(h)
        r = h >> 1
        rev = h & 1
        piece = np.where(rev == 1, base[r], base[r] + pieces[r] - 1)
        return (piece << 1) | rev

    def map_start_handle(h):
        """Map to the piece handle at the 'incoming' end: forward -> first
        piece, reverse -> last piece."""
        h = np.asarray(h)
        r = h >> 1
        rev = h & 1
        piece = np.where(rev == 1, base[r] + pieces[r] - 1, base[r])
        return (piece << 1) | rev

    # edges: from the outgoing end of `from` to the incoming end of `to`
    ef = map_end_handle(g.edge_from)
    et = map_start_handle(g.edge_to)
    # plus internal chain edges for each split node
    multi = np.nonzero(pieces > 1)[0]
    chain_from = []
    chain_to = []
    for r in multi:
        ranks = np.arange(base[r], base[r] + pieces[r] - 1)
        chain_from.append(ranks << 1)
        chain_to.append((ranks + 1) << 1)
    if chain_from:
        ef = np.concatenate([ef, np.concatenate(chain_from)])
        et = np.concatenate([et, np.concatenate(chain_to)])

    # paths: expand each step into its oriented piece chain
    sh = g.step_handle
    sr = handle_rank(sh)
    srev = (sh & 1).astype(bool)
    reps = pieces[sr]
    new_S = int(reps.sum())
    # for each expanded slot: offset within the step's chain
    excl = np.cumsum(reps) - reps
    within = np.arange(new_S, dtype=np.int64) - np.repeat(excl, reps)
    rep_rank = np.repeat(sr, reps)
    rep_rev = np.repeat(srev, reps)
    # forward traversal: base..base+p-1 ; reverse: base+p-1..base, reversed
    piece_rank = np.where(
        rep_rev,
        base[rep_rank] + pieces[rep_rank] - 1 - within,
        base[rep_rank] + within,
    )
    new_steps = (piece_rank << 1) | rep_rev.astype(np.int64)
    new_path_off = np.zeros(g.num_paths + 1, dtype=np.int64)
    if g.num_paths:
        per_path = np.bincount(
            g.step_path, weights=reps.astype(np.float64), minlength=g.num_paths
        ).astype(np.int64)
        np.cumsum(per_path, out=new_path_off[1:])
    # recompute step positions
    step_lens = new_len[piece_rank]
    cum = np.cumsum(step_lens) - step_lens
    new_step_path = np.repeat(
        np.arange(g.num_paths, dtype=np.int64), np.diff(new_path_off)
    )
    new_step_pos = cum - cum[new_path_off[new_step_path]]

    return GraphTensors(
        node_len=new_len,
        seq_offset=new_off,
        seq=new_seq,
        node_id=np.arange(1, new_n + 1, dtype=np.int64),
        edge_from=ef.astype(np.int64),
        edge_to=et.astype(np.int64),
        path_names=g.path_names,
        path_circular=g.path_circular,
        path_offset=new_path_off,
        step_handle=new_steps,
        step_pos=new_step_pos,
    )
