"""The benchmark's generator and graph sources give the graphs their
configurations describe."""

import numpy as np
import pytest

from portbench import graphgen


@pytest.mark.parametrize("haplotypes,nodes,seed", [(6, 5000, 11), (2, 20000, 2**40 + 1),
                                                   (40, 1500, 7)])
def test_every_haplotype_walks_the_chain_once(haplotypes, nodes, seed):
    f = graphgen.walk_arrays(haplotypes, nodes, seed)
    off, h = f["path_offset"], f["step_handle"]
    node = h >> 1
    assert len(off) == haplotypes + 1 and off[-1] == len(h)
    for p in range(haplotypes):
        walk = node[off[p]:off[p + 1]]
        strand = h[off[p]:off[p + 1]] & 1
        assert (strand == strand[0]).all()
        fwd = walk if strand[0] == 0 else nodes - 1 - walk
        assert fwd[0] == 0 and fwd[-1] == nodes - 1 and (fwd[:-1] < nodes - 1).all()
        step = np.diff(fwd)
        assert set(np.unique(step)) <= {0, 1, 2}
        # a step stays or skips about 2.5% of the time each
        assert abs((step == 0).mean() - 0.025) < 0.01 and abs((step == 2).mean() - 0.025) < 0.01
    assert (h[off[:-1]] & 1).sum() == haplotypes // 2
    visits = np.bincount(node, minlength=nodes)
    assert visits.max() <= haplotypes + 8 and np.median(visits) == haplotypes
    assert np.array_equal(f["step_pos"][off[:-1]], np.zeros(haplotypes, np.int64))


def test_edges_are_the_canonical_step_pairs():
    f = graphgen.walk_arrays(5, 3000, 3)
    h, off = f["step_handle"], f["path_offset"]
    pairs = set()
    for p in range(5):
        w = h[off[p]:off[p + 1]].tolist()
        for a, b in zip(w, w[1:]):
            pairs.add(min((a, b), (b ^ 1, a ^ 1)))
    got = list(zip(f["edge_from"].tolist(), f["edge_to"].tolist()))
    assert len(got) == len(set(got)) and set(got) == pairs
    assert got == sorted(got)


@pytest.mark.parametrize("seed", range(8))
def test_the_chain_has_a_head_and_a_tail(seed):
    f = graphgen.walk_arrays(90, 500, seed)
    a, b = f["edge_from"], f["edge_to"]
    entered = set(b.tolist()) | set((a ^ 1).tolist())
    # nothing enters the first node forward or the last node reverse
    assert 0 not in entered and ((499 << 1) | 1) not in entered


def test_walk_seed_changes_only_the_walk():
    p = dict(haplotypes=4, nodes=2000)
    a, b = graphgen.graph_arrays(p, 1), graphgen.graph_arrays(p, 2**40 + 1)
    assert not np.array_equal(a["step_handle"], b["step_handle"])
    assert np.array_equal(a["node_len"], b["node_len"]) and len(a["path_names"]) == 4
    again = graphgen.graph_arrays(p, 1)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(again[k])), k


def test_shuffle_keeps_the_graph():
    f = graphgen.walk_arrays(3, 1000, 5)
    g = graphgen.graph_arrays(dict(haplotypes=3, nodes=1000), 5)
    perm = np.random.default_rng(graphgen.SHUFFLE_SEED).permutation(1000)
    inv = np.empty(1000, np.int64)
    inv[perm] = np.arange(1000)
    assert np.array_equal(g["step_handle"], (inv[f["step_handle"] >> 1] << 1) | (f["step_handle"] & 1))


def test_synth_is_the_smoke_runs_drb1_scale_graph():
    """graphs/synth.py at the DRB1 sizes and seed 11 gives chip_smoke.py's
    shuffled DRB1-scale graph, field for field and edge order included."""
    import chip_smoke
    from odgi_tpu_torch.convert import graph_to_arrays

    from portbench import harness

    steps, nodes, path_steps = chip_smoke.DRB1
    assert (steps, nodes, path_steps) == (35_064, 4_955, 2_922)
    f = harness.graph_fields(dict(graph="synth", steps=steps, nodes=nodes,
                                  path_steps=path_steps), 11)
    ref = graph_to_arrays(chip_smoke.shuffled_graph(steps, nodes, path_steps))
    assert f.keys() == ref.keys() and f["path_names"] == ref["path_names"]
    for k in ref.keys() - {"path_names"}:
        assert f[k].dtype == ref[k].dtype and np.array_equal(f[k], ref[k]), k
