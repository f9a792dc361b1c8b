"""simplify_siblings and normalize (host), the counterpart of
``odgi_tpu/algorithms/simplify.py``.

simplify_siblings merges the children of one set of parents that start
with the same base, over a small mutable adjacency; `normalize` is the
unchop + simplify_siblings fixpoint (``odgi normalize``).
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from ..core.graph import GraphBuilder, GraphTensors


def _flip(h: int) -> int:
    return h ^ 1


class _MutableGraph:
    """Minimal mutable bidirected graph keyed by node id, supporting the
    divide/merge edits simplify_siblings needs."""

    def __init__(self, g: GraphTensors):
        self.seq: Dict[int, bytes] = {}
        self.right: Dict[int, Set[int]] = {}  # handle -> right neighbors
        self.paths: List[List[int]] = []
        self.path_names = list(g.path_names)
        self.path_circular = list(g.path_circular)
        self.next_id = int(g.node_id.max()) + 1 if g.num_nodes else 1
        id_of = g.node_id
        for r in range(g.num_nodes):
            nid = int(id_of[r])
            self.seq[nid] = g.node_seq(r)
        for a, b in zip(g.edge_from, g.edge_to):
            ha = (int(id_of[int(a) >> 1]) << 1) | (int(a) & 1)
            hb = (int(id_of[int(b) >> 1]) << 1) | (int(b) & 1)
            self._add_edge(ha, hb)
        for p in range(g.num_paths):
            lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
            self.paths.append(
                [
                    (int(id_of[int(h) >> 1]) << 1) | (int(h) & 1)
                    for h in g.step_handle[lo:hi]
                ]
            )

    # -- edges ------------------------------------------------------------
    def _add_edge(self, a: int, b: int):
        self.right.setdefault(a, set()).add(b)
        self.right.setdefault(_flip(b), set()).add(_flip(a))

    def _del_edge(self, a: int, b: int):
        self.right.get(a, set()).discard(b)
        self.right.get(_flip(b), set()).discard(_flip(a))

    def rights(self, h: int) -> Set[int]:
        return set(self.right.get(h, ()))

    def lefts(self, h: int) -> Set[int]:
        return {_flip(x) for x in self.right.get(_flip(h), ())}

    def handle_seq(self, h: int) -> bytes:
        s = self.seq[h >> 1]
        if h & 1:
            return bytes(reversed(s.translate(_RC)))
        return s

    # -- edits -------------------------------------------------------------
    def divide(self, h: int, offset: int) -> Tuple[int, int]:
        """Split node (in h's orientation) at `offset`; returns the two part
        handles in h's orientation (reference: graph_t::divide_handle)."""
        nid = h >> 1
        seq = self.handle_seq(h)
        s1, s2 = seq[:offset], seq[offset:]
        id1, id2 = self.next_id, self.next_id + 1
        self.next_id += 2
        self.seq[id1] = s1
        self.seq[id2] = s2
        h1, h2 = id1 << 1, id2 << 1
        fwd = h & ~1
        lefts = self.lefts(fwd)
        rights = self.rights(fwd)
        if h & 1:
            # parts are in reverse orientation relative to the original
            first, second = _flip(h2), _flip(h1)  # forward-order parts
        else:
            first, second = h1, h2
        for l in lefts:
            if (l >> 1) == nid:  # self loop adjusts below
                continue
            self._add_edge(l, first)
        for r in rights:
            if (r >> 1) == nid:
                continue
            self._add_edge(second, r)
        # self-loops: reattach around the pair
        for l in lefts:
            if (l >> 1) == nid:
                end = second if (l & 1) == 0 else _flip(first)
                self._add_edge(end, first)
        self._add_edge(first, second)
        # rewrite path steps
        for steps in self.paths:
            i = 0
            while i < len(steps):
                st = steps[i]
                if (st >> 1) == nid:
                    if st & 1:
                        repl = [_flip(second), _flip(first)]
                    else:
                        repl = [first, second]
                    steps[i : i + 1] = repl
                    i += len(repl)
                else:
                    i += 1
        self._destroy_node(nid)
        if h & 1:
            return _flip(second), _flip(first)
        return first, second

    def _destroy_node(self, nid: int):
        for rev in (0, 1):
            h = (nid << 1) | rev
            for r in list(self.rights(h)):
                self._del_edge(h, r)
            self.right.pop(h, None)
        for hs in self.right.values():
            hs.difference_update({nid << 1, (nid << 1) | 1})
        del self.seq[nid]

    def merge(self, handles: List[int]):
        """Merge identical-sequence full handles into one
        (reference: merge.cpp:13-155)."""
        merged = handles[-1]
        others = handles[:-1]
        for other in others:
            for r in self.rights(other):
                if r != other and (r >> 1) != (other >> 1):
                    self._add_edge(merged, r)
                elif (r >> 1) == (other >> 1):
                    # self-loop on the merged family member
                    tgt = merged if r == other else _flip(merged)
                    self._add_edge(merged, tgt)
            for l in self.lefts(other):
                if (l >> 1) != (other >> 1):
                    self._add_edge(l, merged)
        for steps_list in self.paths:
            for i, st in enumerate(steps_list):
                for other in others:
                    if (st >> 1) == (other >> 1):
                        flip = (st & 1) != (other & 1)
                        steps_list[i] = _flip(merged) if flip else merged
        for other in others:
            self._destroy_node(other >> 1)

    def to_tensors(self) -> GraphTensors:
        b = GraphBuilder()
        for nid in sorted(self.seq):
            b.add_node(nid, self.seq[nid])
        # the builder canonicalizes and dedupes edges
        for a, targets in sorted(self.right.items()):
            for t in sorted(targets):
                b.add_edge(a >> 1, bool(a & 1), t >> 1, bool(t & 1))
        for p, steps in enumerate(self.paths):
            pid = b.add_path(self.path_names[p], self.path_circular[p])
            for st in steps:
                b.append_step(pid, st >> 1, bool(st & 1))
        return b.build()


_RC = bytes.maketrans(b"ACGTNacgtn", b"TGCANtgcan")


def simplify_siblings(g: GraphTensors) -> Tuple[GraphTensors, bool]:
    """One pass of sibling simplification; returns (graph, made_progress)
    (reference: simplify_siblings.cpp:13-305)."""
    m = _MutableGraph(g)

    # family discovery on the frozen snapshot
    in_family: Set[int] = set()
    families: List[List[int]] = []
    for nid in sorted(m.seq):
        for orient in (0, 1):
            node = (nid << 1) | orient
            if nid in in_family:
                continue
            parents = m.lefts(node)
            if not parents:
                continue
            superfamily: Set[int] = set()
            partial: Set[int] = set()
            for parent in parents:
                for cand in m.rights(parent):
                    if cand in partial or cand in superfamily:
                        continue
                    if (cand >> 1) in in_family:
                        continue
                    cand_parents = m.lefts(cand)
                    if cand_parents == parents:
                        superfamily.add(cand)
                    else:
                        partial.add(cand)
            if len(superfamily) > 1:
                ids = [h >> 1 for h in superfamily]
                if len(set(ids)) != len(ids):
                    continue  # same node in both orientations: skip
                by_base: Dict[int, List[int]] = {}
                for h in sorted(superfamily):
                    s = m.handle_seq(h)
                    if not s:
                        continue
                    by_base.setdefault(s[0], []).append(h)
                for base, family in sorted(by_base.items()):
                    if len(family) == 1:
                        continue
                    for h in family:
                        in_family.add(h >> 1)
                    families.append(family)

    if not families:
        return g, False

    for family in families:
        seqs = [m.handle_seq(h) for h in family]
        lcp = len(seqs[0])
        for s in seqs[1:]:
            k = 0
            while k < min(lcp, len(s)) and s[k] == seqs[0][k]:
                k += 1
            lcp = min(lcp, k)
        assert lcp >= 1
        middles = []
        for h in family:
            if lcp != len(m.handle_seq(h)):
                first, _ = m.divide(h, lcp)
                middles.append(first)
            else:
                middles.append(h)
        m.merge(middles)

    return m.to_tensors(), True


def normalize(g: GraphTensors, max_iter: int = 10) -> GraphTensors:
    """unchop + simplify_siblings fixpoint
    (reference: src/algorithms/normalize.cpp:20-50)."""
    from .unchop import unchop

    last_len = g.total_length if max_iter > 1 else 0
    it = 0
    while True:
        g = unchop(g)
        g, _ = simplify_siblings(g)
        it += 1
        if max_iter > 1:
            cur = g.total_length
            if cur == last_len:
                break
            last_len = cur
        if it >= max_iter:
            break
    return unchop(g)
