"""The benchmark's graph generator (numpy only).

A pangenome graph of H haplotypes over N nodes, the shape of a graph built
from whole assemblies (see ``configs/``): every haplotype walks the whole
node chain once, end to end, so each node is visited once by each haplotype
that carries it.  A step advances one node; with probability ``skip`` it
jumps over one (the haplotype lacks that node: a deletion), and with
probability ``stay`` it visits the same node again (a tandem duplication).
A haplotype leaves its first node at once and ends at its first arrival
at the last node, so the chain has a head and a tail, as a chromosome has
its telomeres, and no visits pile up at its ends.  Half of the haplotypes
(which half is drawn from the seed) are reverse as a whole, as assembly
contigs are: a reverse haplotype walks the chain from the last node to the
first with every step reversed.  Both are fixed so that every seed gives
the same work: the strand counts move the time of a layout's host set-up,
and a head the time of a sort's groom and topological order.  Nodes are
``node_bp`` bp long.

The edges are the distinct consecutive step pairs in canonical form (the
smaller of (a, b) and (b ^ 1, a ^ 1), so a pair and its reverse are one
edge), deduplicated by a 1-D ``np.unique`` over ``from << 32 | to`` keys.
The node ids are then shuffled by ``default_rng(5)`` so that a sort has
work to do.

Imports nothing of the program: it returns the graph's fields as arrays.
"""

from __future__ import annotations

import math

import numpy as np

SHUFFLE_SEED = 5


def walk_arrays(haplotypes: int, nodes: int, seed: int, skip: float = 0.025,
                stay: float = 0.025, node_bp: int = 1) -> dict:
    """The fields of the unshuffled graph (node i has id i + 1)."""
    rng = np.random.default_rng(seed)
    H, N = int(haplotypes), int(nodes)
    # Enough steps that every walk reaches the last node (8 sd of the
    # walk's spread past the mean).
    T = N + int(8 * math.sqrt((skip + stay) * N)) + 16
    move = rng.choice(np.array([1, 2, 0], np.int8), size=(H, T), p=[1 - skip - stay, skip, stay])
    move[:, 0] = 0
    move[:, 1] = np.maximum(move[:, 1], 1)   # a walk leaves its first node
    node = np.cumsum(move, axis=1, dtype=np.int64)
    arrived = node >= N - 1
    if not arrived[:, -1].all():
        raise ValueError("graphgen: a walk did not reach the last node")
    end = arrived.argmax(axis=1)
    lengths = end + 1
    keep = np.arange(T)[None, :] <= end[:, None]
    node = np.minimum(node, N - 1)
    reverse = np.zeros(H, bool)
    reverse[rng.permutation(H)[:H // 2]] = True
    node = np.where(reverse[:, None], N - 1 - node, node)[keep]
    step_handle = (node << 1) | np.repeat(reverse, lengths).astype(np.int64)
    path_offset = np.zeros(H + 1, np.int64)
    np.cumsum(lengths, out=path_offset[1:])

    a, b = step_handle[:-1], step_handle[1:]
    inner = np.ones(len(a), bool)
    inner[path_offset[1:-1] - 1] = False
    a, b = a[inner], b[inner]
    ra, rb = b ^ 1, a ^ 1
    first = (a < ra) | ((a == ra) & (b <= rb))
    key = np.unique((np.where(first, a, ra) << 32) | np.where(first, b, rb))
    starts = np.repeat(path_offset[:-1], lengths)
    return dict(
        node_len=np.full(N, node_bp, np.int64),
        seq_offset=np.arange(N + 1, dtype=np.int64) * node_bp,
        seq=np.full(N * node_bp, ord("A"), np.uint8),
        node_id=np.arange(1, N + 1, dtype=np.int64),
        edge_from=key >> 32,
        edge_to=key & 0xFFFFFFFF,
        path_names=tuple(f"h{i}" for i in range(H)),
        path_circular=np.zeros(H, bool),
        path_offset=path_offset,
        step_handle=step_handle,
        step_pos=(np.arange(len(node), dtype=np.int64) - starts) * node_bp,
    )


def reorder(f: dict, order: np.ndarray) -> dict:
    """The fields with node rank k taken by old rank order[k], ids
    compacted to 1..N; every handle renumbered, orientation kept."""
    n = len(f["node_len"])
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n, dtype=np.int64)
    node_len = f["node_len"][order]
    seq_offset = np.zeros(n + 1, np.int64)
    np.cumsum(node_len, out=seq_offset[1:])
    starts = f["seq_offset"][order]
    within = np.arange(int(node_len.sum()), dtype=np.int64) - np.repeat(seq_offset[:-1], node_len)
    remap = lambda h: (inv[h >> 1] << 1) | (h & 1)
    return dict(
        f,
        node_len=node_len,
        seq_offset=seq_offset,
        seq=f["seq"][np.repeat(starts, node_len) + within],
        node_id=np.arange(1, n + 1, dtype=np.int64),
        edge_from=remap(f["edge_from"]),
        edge_to=remap(f["edge_to"]),
        step_handle=remap(f["step_handle"]),
    )


def graph_arrays(config: dict, seed: int) -> dict:
    """The configuration's graph (its ``haplotypes``, ``nodes``,
    ``node_bp``, ``skip`` and ``stay``) for walk seed `seed`, node ids
    shuffled."""
    f = walk_arrays(config["haplotypes"], config["nodes"], seed,
                    skip=float(config.get("skip", 0.025)), stay=float(config.get("stay", 0.025)),
                    node_bp=int(config.get("node_bp", 1)))
    perm = np.random.default_rng(SHUFFLE_SEED).permutation(len(f["node_len"]))
    return reorder(f, perm)
