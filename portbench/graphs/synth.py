"""Deep-coverage random walks with a random strand on every step.

``chip_smoke.py``'s ``shuffled_graph``, in numpy alone: P paths of
``path_steps`` steps each (P the ``steps`` over ``path_steps``, rounded
up) walk ``nodes`` 1-bp nodes.  A path starts at node 0 and advances about
``nodes / path_steps`` nodes a step; 2.5% of steps go one node further and
2.5% one node less, the walk clipped to the node range; each step takes a
strand of its own.  The edges are the distinct (smaller, larger) handle
pairs of consecutive steps, in lexical order.  The node ids are then
shuffled by ``default_rng(5)`` as ``GraphTensors.apply_ordering`` renumbers
them.  With ``steps`` 35,064, ``nodes`` 4,955, ``path_steps`` 2,922 and
seed 11 this is the smoke run's DRB1-scale graph (12 paths, the sizes of
DRB1-3123), field for field.
"""

from __future__ import annotations

import numpy as np

from portbench.graphgen import SHUFFLE_SEED, reorder

TINY = dict(steps=3000, nodes=400, path_steps=500)


def graph_arrays(config: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    nodes, path_steps = int(config["nodes"]), int(config["path_steps"])
    P = -(-int(config["steps"]) // path_steps)
    S = P * path_steps
    adv = nodes / path_steps
    steps = int(adv) + (rng.random(S) < adv - int(adv)).astype(np.int64)
    noise = rng.choice([0, 1, -1], size=S, p=[0.95, 0.025, 0.025])
    steps = (steps + noise).reshape(P, path_steps)
    steps[:, 0] = 0
    node = np.clip(np.cumsum(steps, axis=1), 0, nodes - 1).reshape(-1)
    step_handle = (node << 1) | rng.integers(0, 2, S)
    keep = (np.arange(1, S) % path_steps) != 0
    a, b = step_handle[:-1][keep], step_handle[1:][keep]
    e = np.unique(np.stack([np.minimum(a, b), np.maximum(a, b)], 1), axis=0)
    f = dict(
        node_len=np.ones(nodes, np.int64),
        seq_offset=np.arange(nodes + 1, dtype=np.int64),
        seq=np.full(nodes, ord("A"), np.uint8),
        node_id=np.arange(1, nodes + 1, dtype=np.int64),
        edge_from=e[:, 0].copy(),
        edge_to=e[:, 1].copy(),
        path_names=tuple(f"p{i}" for i in range(P)),
        path_circular=np.zeros(P, bool),
        path_offset=np.arange(P + 1, dtype=np.int64) * path_steps,
        step_handle=step_handle,
        step_pos=np.tile(np.arange(path_steps, dtype=np.int64), P),
    )
    return reorder(f, np.random.default_rng(SHUFFLE_SEED).permutation(nodes))
