"""The ``import odgi`` class API (the reference's pybind11 module,
src/pythonmodule.cpp), the counterpart of ``odgi_tpu/compat/odgi.py``.

Usage: ``from odgi_tpu_torch.compat import odgi``, then ``g =
odgi.graph()`` and ``g.load("x.og")``.  Handles are opaque ints packed as
``(id - 1) << 1 | is_reverse``, the reference's number_bool_packing; step
handles are (path, rank) pairs with the reference's accessor methods.

The class keeps a mutable id-keyed model (a dict of sequences, an
insertion-ordered edge set, step lists) with graph_t's mutation API
(create / destroy / divide / combine / apply_ordering ...; reference:
src/odgi.hpp:120-360), and freezes to the port's GraphTensors for IO and
the algorithms.  ``load`` reads through the command line's ``load_any``
on ``graph(device=...)``'s device: None is the card, and raises without
one; ``device="cpu"`` runs on the CPU.  Every method returns what
``odgi_tpu``'s returns.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class step_handle:
    """A step on a path (reference step_handle_t + pythonmodule accessors)."""

    __slots__ = ("_g", "path_idx", "rank", "_kind")

    def __init__(self, g: "graph", path_idx: int, rank: int, kind: str = "s"):
        self._g = g
        self.path_idx = path_idx
        self.rank = rank
        self._kind = kind  # 's' step, 'end' past-the-end, 'front' before-front

    def _steps(self):
        return self._g._paths[self.path_idx]["steps"]

    def path_id(self) -> int:
        return self.path_idx + 1

    def is_reverse(self) -> bool:
        return self._steps()[self.rank][1]

    def prev_id(self) -> int:
        s = self._steps()
        return s[self.rank - 1][0] if self.rank > 0 else s[self.rank][0]

    def prev_rank(self) -> int:
        return max(0, self.rank - 1)

    def next_id(self) -> int:
        s = self._steps()
        return s[self.rank + 1][0] if self.rank + 1 < len(s) else s[self.rank][0]

    def next_rank(self) -> int:
        return min(len(self._steps()) - 1, self.rank + 1)

    def __eq__(self, other):
        return (
            isinstance(other, step_handle)
            and self.path_idx == other.path_idx
            and self.rank == other.rank
            and self._kind == other._kind
        )

    def __hash__(self):
        return hash((self.path_idx, self.rank, self._kind))


class edge:
    """An edge as a pair of handles (reference edge_t)."""

    __slots__ = ("_a", "_b")

    def __init__(self, a: int, b: int):
        self._a, self._b = a, b

    def first(self) -> int:
        return self._a

    def second(self) -> int:
        return self._b


class graph:
    """Mutable variation graph with the reference graph_t python API."""

    def __init__(self, device=None):
        self._device = device
        self.clear()

    # ---- internal model ---------------------------------------------------

    def clear(self):
        self._seqs: Dict[int, bytes] = {}  # id -> forward sequence
        # canonical ((id, rev), (id, rev)) -> None; INSERTION-ORDERED so
        # per-node traversal order projects the creation order like the
        # reference's node_t edge records
        self._edges: Dict[tuple, None] = {}
        self._paths: List[dict] = []  # {name, circular, steps:[(id, rev)]}
        self._path_by_name: Dict[str, int] = {}
        self._next_id = 1
        self._frozen = None

    def clear_paths(self):
        self._paths = []
        self._path_by_name = {}
        self._dirty()

    def _dirty(self):
        self._frozen = None

    def _ids_sorted(self) -> List[int]:
        return sorted(self._seqs.keys())

    def _id_handle(self, node_id: int, rev: bool) -> Tuple[int, bool]:
        return (node_id << 1) | int(rev)

    @staticmethod
    def _canon(a: Tuple[int, bool], b: Tuple[int, bool]):
        fa, fb = (b[0], not b[1]), (a[0], not a[1])
        return (fa, fb) if (fa, fb) < (a, b) else (a, b)

    def freeze(self):
        """Freeze into an immutable GraphTensors (cached until mutation)."""
        if self._frozen is None:
            from ..core.graph import GraphBuilder

            b = GraphBuilder()
            for nid in self._ids_sorted():
                b.add_node(nid, self._seqs[nid])
            for (a, b_) in self._edges:
                b.add_edge(a[0], a[1], b_[0], b_[1])
            for pm in self._paths:
                pi = b.add_path(pm["name"], pm["circular"])
                for nid, rev in pm["steps"]:
                    b.append_step(pi, nid, rev)
            self._frozen = b.build()
        return self._frozen

    @classmethod
    def from_tensors(cls, g, device=None) -> "graph":
        out = cls(device)
        ids = g.node_id
        for r in range(g.num_nodes):
            out._seqs[int(ids[r])] = g.node_seq(r)
        out._next_id = (int(ids.max()) + 1) if g.num_nodes else 1
        for fh, th in zip(g.edge_from, g.edge_to):
            a = (int(ids[int(fh) >> 1]), bool(int(fh) & 1))
            bb = (int(ids[int(th) >> 1]), bool(int(th) & 1))
            out._edges[cls._canon(a, bb)] = None
        for p in range(g.num_paths):
            lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
            steps = [
                (int(ids[int(h) >> 1]), bool(int(h) & 1))
                for h in g.step_handle[lo:hi]
            ]
            out._paths.append(
                {
                    "name": g.path_names[p],
                    "circular": bool(g.path_circular[p]),
                    "steps": steps,
                }
            )
            out._path_by_name[g.path_names[p]] = p
        out._frozen = g
        return out

    # ---- handle helpers (number_bool_packing on ids) ----------------------

    def get_handle(self, node_id: int, is_reverse: bool = False) -> int:
        # reference packing: rank = id - 1 - id_increment
        # (src/odgi.cpp:30-37; number_bool_packing)
        return ((int(node_id) - 1) << 1) | int(is_reverse)

    def get_id(self, handle: int) -> int:
        return (handle >> 1) + 1

    @staticmethod
    def _hid(handle: int) -> int:
        """Internal: node id from a public handle."""
        return (handle >> 1) + 1

    def get_is_reverse(self, handle: int) -> bool:
        return bool(handle & 1)

    def flip(self, handle: int) -> int:
        return handle ^ 1

    def forward(self, handle: int) -> int:
        return handle & ~1

    def edge_handle(self, left: int, right: int) -> edge:
        a, b = self._canon(
            (self._hid(left), bool(left & 1)),
            (self._hid(right), bool(right & 1)),
        )
        return edge(self.get_handle(*a), self.get_handle(*b))

    # ---- node queries ------------------------------------------------------

    def has_node(self, node_id: int) -> bool:
        return node_id in self._seqs

    def get_length(self, handle: int) -> int:
        return len(self._seqs[self._hid(handle)])

    def get_sequence(self, handle: int) -> str:
        seq = self._seqs[self._hid(handle)]
        if handle & 1:
            from ..core.graph import revcomp_bytes

            seq = bytes(revcomp_bytes(np.frombuffer(seq, np.uint8)))
        return seq.decode()

    def get_node_count(self) -> int:
        return len(self._seqs)

    def min_node_id(self) -> int:
        return min(self._seqs) if self._seqs else 0

    def max_node_id(self) -> int:
        return max(self._seqs) if self._seqs else 0

    def get_degree(self, handle: int, go_left: bool) -> int:
        out = []
        self.follow_edges(handle, go_left, lambda h: (out.append(h), True)[1])
        return len(out)

    def get_step_count(self, handle_or_path) -> int:
        if isinstance(handle_or_path, int) and handle_or_path >= 0:
            # node handle: number of steps on the node
            nid = self._hid(handle_or_path)
            return sum(
                1
                for pm in self._paths
                for (sid, _r) in pm["steps"]
                if sid == nid
            )
        raise TypeError("get_step_count expects a node handle")

    def steps_of_handle(self, handle: int, match_orientation: bool = False):
        nid = self._hid(handle)
        rev = bool(handle & 1)
        out = []
        for pi, pm in enumerate(self._paths):
            for r, (sid, srev) in enumerate(pm["steps"]):
                if sid == nid and (not match_orientation or srev == rev):
                    out.append(step_handle(self, pi, r))
        return out

    # ---- traversal ---------------------------------------------------------

    def follow_edges(self, handle: int, go_left: bool, iteratee) -> bool:
        nid = self._hid(handle)
        rev = bool(handle & 1)
        # iteration follows edge CREATION order: its projection onto a
        # node equals the reference node_t record order (the .og loader
        # reconstructs creation order, io/og_compat.py:219-228), so
        # traversal order matches the reference exactly
        for (a, b) in self._edges:
            for (x, y, to_curr) in ((a, b, False), (b, a, True)):
                if x[0] != nid:
                    continue
                other_id, other_rev = y
                on_rev = x[1]
                tc = to_curr
                if other_id == nid and on_rev == other_rev and a == b:
                    tc = go_left
                    other_rev = rev
                elif rev != on_rev:
                    other_rev = not other_rev
                    tc = not tc
                if (not go_left and not tc) or (go_left and tc):
                    if iteratee(self.get_handle(other_id, other_rev)) is False:
                        return False
        return True

    def for_each_handle(self, iteratee, parallel: bool = False) -> bool:
        for nid in self._ids_sorted():
            if iteratee(self.get_handle(nid, False)) is False:
                return False
        return True

    def for_each_edge(self, iteratee) -> bool:
        for (a, b) in self._edges:
            if iteratee(edge(self.get_handle(*a), self.get_handle(*b))) is False:
                return False
        return True

    # ---- paths -------------------------------------------------------------

    def get_path_count(self) -> int:
        return len(self._paths)

    def has_path(self, name: str) -> bool:
        return name in self._path_by_name

    def get_path_handle(self, name: str) -> int:
        return self._path_by_name[name]

    def get_path_name(self, path: int) -> str:
        return self._paths[path]["name"]

    def get_is_circular(self, path: int) -> bool:
        return self._paths[path]["circular"]

    def set_circularity(self, path: int, circular: bool):
        self._paths[path]["circular"] = circular
        self._dirty()

    def is_empty(self, path: int) -> bool:
        return not self._paths[path]["steps"]

    def for_each_path_handle(self, iteratee) -> bool:
        for pi in range(len(self._paths)):
            if iteratee(pi) is False:
                return False
        return True

    def for_each_step_on_handle(self, handle: int, iteratee) -> bool:
        for s in self.steps_of_handle(handle):
            if iteratee(s) is False:
                return False
        return True

    def for_each_step_in_path(self, path: int, iteratee):
        for r in range(len(self._paths[path]["steps"])):
            iteratee(step_handle(self, path, r))

    def get_step_count_of_path(self, path: int) -> int:
        return len(self._paths[path]["steps"])

    # step navigation (reference: pythonmodule.cpp:154-199)
    def get_handle_of_step(self, step: step_handle) -> int:
        nid, rev = self._paths[step.path_idx]["steps"][step.rank]
        return self.get_handle(nid, rev)

    def get_path(self, step: step_handle) -> int:
        return step.path_idx

    get_path_handle_of_step = get_path

    def path_begin(self, path: int) -> step_handle:
        return step_handle(self, path, 0)

    def path_end(self, path: int) -> step_handle:
        return step_handle(self, path, len(self._paths[path]["steps"]), "end")

    def path_back(self, path: int) -> step_handle:
        return step_handle(self, path, len(self._paths[path]["steps"]) - 1)

    def path_front_end(self, path: int) -> step_handle:
        return step_handle(self, path, -1, "front")

    def is_path_front_end(self, step: step_handle) -> bool:
        return step._kind == "front"

    def is_path_end(self, step: step_handle) -> bool:
        return step._kind == "end"

    def has_next_step(self, step: step_handle) -> bool:
        pm = self._paths[step.path_idx]
        return step.rank + 1 < len(pm["steps"]) or (
            pm["circular"] and len(pm["steps"]) > 0
        )

    def has_previous_step(self, step: step_handle) -> bool:
        pm = self._paths[step.path_idx]
        return step.rank > 0 or (pm["circular"] and len(pm["steps"]) > 0)

    def get_next_step(self, step: step_handle) -> step_handle:
        pm = self._paths[step.path_idx]
        if step.rank + 1 < len(pm["steps"]):
            return step_handle(self, step.path_idx, step.rank + 1)
        if pm["circular"]:
            return step_handle(self, step.path_idx, 0)
        return self.path_end(step.path_idx)

    def get_previous_step(self, step: step_handle) -> step_handle:
        pm = self._paths[step.path_idx]
        if step.rank > 0:
            return step_handle(self, step.path_idx, step.rank - 1)
        if pm["circular"]:
            return step_handle(self, step.path_idx, len(pm["steps"]) - 1)
        return self.path_front_end(step.path_idx)

    def get_ordinal_rank_of_step(self, step: step_handle) -> int:
        return step.rank

    # ---- mutation ----------------------------------------------------------

    def create_handle(self, sequence: str, node_id: Optional[int] = None) -> int:
        if node_id is None:
            node_id = self._next_id
        if node_id in self._seqs:
            raise ValueError(f"node {node_id} exists")
        self._seqs[node_id] = sequence.encode()
        self._next_id = max(self._next_id, node_id + 1)
        self._dirty()
        return self.get_handle(node_id, False)

    def destroy_handle(self, handle: int):
        nid = self._hid(handle)
        del self._seqs[nid]
        self._edges = {
            e: None
            for e in self._edges
            if e[0][0] != nid and e[1][0] != nid
        }
        for pm in self._paths:
            pm["steps"] = [s for s in pm["steps"] if s[0] != nid]
        self._dirty()

    def create_edge(self, left: int, right: int):
        a = (self._hid(left), bool(left & 1))
        b = (self._hid(right), bool(right & 1))
        self._edges[self._canon(a, b)] = None
        self._dirty()

    def has_edge(self, left: int, right: int) -> bool:
        a = (self._hid(left), bool(left & 1))
        b = (self._hid(right), bool(right & 1))
        return self._canon(a, b) in self._edges

    def destroy_edge(self, left: int, right: int):
        a = (self._hid(left), bool(left & 1))
        b = (self._hid(right), bool(right & 1))
        self._edges.pop(self._canon(a, b), None)
        self._dirty()

    def create_path_handle(self, name: str, is_circular: bool = False) -> int:
        if name in self._path_by_name:
            raise ValueError(f"path {name} exists")
        self._paths.append({"name": name, "circular": is_circular, "steps": []})
        self._path_by_name[name] = len(self._paths) - 1
        self._dirty()
        return len(self._paths) - 1

    def destroy_path(self, path: int):
        self._paths.pop(path)
        self._path_by_name = {
            pm["name"]: i for i, pm in enumerate(self._paths)
        }
        self._dirty()

    def append_step(self, path: int, handle: int) -> step_handle:
        pm = self._paths[path]
        pm["steps"].append((self._hid(handle), bool(handle & 1)))
        self._dirty()
        return step_handle(self, path, len(pm["steps"]) - 1)

    def prepend_step(self, path: int, handle: int) -> step_handle:
        pm = self._paths[path]
        pm["steps"].insert(0, (self._hid(handle), bool(handle & 1)))
        self._dirty()
        return step_handle(self, path, 0)

    def insert_step(self, after: step_handle, handle: int) -> step_handle:
        pm = self._paths[after.path_idx]
        pm["steps"].insert(
            after.rank + 1, (self._hid(handle), bool(handle & 1))
        )
        self._dirty()
        return step_handle(self, after.path_idx, after.rank + 1)

    def set_step(self, step: step_handle, handle: int) -> step_handle:
        pm = self._paths[step.path_idx]
        pm["steps"][step.rank] = (self._hid(handle), bool(handle & 1))
        self._dirty()
        return step

    def rewrite_segment(self, begin: step_handle, end: step_handle, handles):
        pm = self._paths[begin.path_idx]
        new = [(self._hid(h), bool(h & 1)) for h in handles]
        pm["steps"][begin.rank : end.rank] = new
        self._dirty()
        return (
            step_handle(self, begin.path_idx, begin.rank),
            step_handle(self, begin.path_idx, begin.rank + len(new)),
        )

    def divide_handle(self, handle: int, offsets) -> List[int]:
        """Split a node at offsets (forward-strand coords of the handle)."""
        if isinstance(offsets, int):
            offsets = [offsets]
        nid = self._hid(handle)
        rev = bool(handle & 1)
        seq = self.get_sequence(handle)
        cuts = [0] + sorted(offsets) + [len(seq)]
        parts = [seq[cuts[i] : cuts[i + 1]] for i in range(len(cuts) - 1)]
        new_ids = [nid] + [self._next_id + i for i in range(len(parts) - 1)]
        self._next_id += len(parts) - 1
        # orientation: parts are in the handle's strand; store forward seqs
        if rev:
            from ..core.graph import revcomp_bytes

            fwd_parts = [
                bytes(
                    revcomp_bytes(np.frombuffer(p.encode(), np.uint8))
                )
                for p in reversed(parts)
            ]
            # ids follow the forward order
            store = list(zip(new_ids, fwd_parts))
        else:
            store = list(zip(new_ids, [p.encode() for p in parts]))
        # reroute edges touching the original ends
        old_edges = [
            e for e in self._edges if e[0][0] == nid or e[1][0] == nid
        ]
        for e in old_edges:
            self._edges.pop(e, None)
        for i, (iid, s) in enumerate(store):
            self._seqs[iid] = s
        first_id, last_id = store[0][0], store[-1][0]
        for (a, b) in old_edges:
            def reroute(x, incoming):
                if x[0] != nid:
                    return x
                # edge into the node's start attaches to first part's start;
                # out of the end attaches to last part's end
                if incoming != x[1]:
                    return (first_id, x[1])
                return (last_id, x[1])
            na = reroute(a, False)
            nb = reroute(b, True)
            self._edges[self._canon(na, nb)] = None
        # chain edges between parts
        chain = [sid for sid, _ in store]
        for i in range(len(chain) - 1):
            self._edges[
                self._canon((chain[i], False), (chain[i + 1], False))
            ] = None
        # rewrite path steps
        fwd_chain = [(sid, False) for sid, _ in store]
        rev_chain = [(sid, True) for sid, _ in reversed(store)]
        for pm in self._paths:
            out = []
            for (sid, srev) in pm["steps"]:
                if sid == nid:
                    out.extend(rev_chain if srev else fwd_chain)
                else:
                    out.append((sid, srev))
            pm["steps"] = out
        self._dirty()
        handles = [self.get_handle(sid, rev) for sid, _ in store]
        return list(reversed(handles)) if rev else handles

    def combine_handles(self, handles) -> int:
        """Concatenate a chain of handles into one node."""
        seq = "".join(self.get_sequence(h) for h in handles)
        new_h = self.create_handle(seq)
        new_id = self._hid(new_h)
        first, last = handles[0], handles[-1]
        ids = {self._hid(h) for h in handles}
        # reconnect: edges into `first` start and out of `last` end
        for (a, b) in list(self._edges):
            if a[0] in ids or b[0] in ids:
                self._edges.pop((a, b), None)
                def remap(x):
                    if x[0] == self._hid(first) and x[1] == bool(first & 1):
                        return (new_id, False)
                    if x[0] == self._hid(last) and x[1] == bool(last & 1):
                        return (new_id, False)
                    if x[0] == self._hid(first) and x[1] != bool(first & 1):
                        return (new_id, True)
                    if x[0] == self._hid(last) and x[1] != bool(last & 1):
                        return (new_id, True)
                    return None if x[0] in ids else x
                na, nb = remap(a), remap(b)
                if na and nb and not (na[0] == new_id and nb[0] == new_id):
                    self._edges[self._canon(na, nb)] = None
        # rewrite paths: replace runs of the chain
        chain_f = [(self._hid(h), bool(h & 1)) for h in handles]
        chain_r = [(self._hid(h), not bool(h & 1)) for h in reversed(handles)]
        L = len(chain_f)
        for pm in self._paths:
            s = pm["steps"]
            out = []
            i = 0
            while i < len(s):
                if s[i : i + L] == chain_f:
                    out.append((new_id, False))
                    i += L
                elif s[i : i + L] == chain_r:
                    out.append((new_id, True))
                    i += L
                else:
                    out.append(s[i])
                    i += 1
            pm["steps"] = out
        for h in handles:
            self._seqs.pop(self._hid(h), None)
        self._dirty()
        return self.get_handle(new_id, False)

    def apply_orientation(self, handle: int) -> int:
        """Flip a node to its reverse complement everywhere."""
        if not (handle & 1):
            return handle
        nid = self._hid(handle)
        from ..core.graph import revcomp_bytes

        self._seqs[nid] = bytes(
            revcomp_bytes(np.frombuffer(self._seqs[nid], np.uint8))
        )
        new_edges: Dict[tuple, None] = {}
        for (a, b) in self._edges:
            a = (a[0], not a[1]) if a[0] == nid else a
            b = (b[0], not b[1]) if b[0] == nid else b
            new_edges[self._canon(a, b)] = None
        self._edges = new_edges
        for pm in self._paths:
            pm["steps"] = [
                (sid, (not r) if sid == nid else r) for sid, r in pm["steps"]
            ]
        self._dirty()
        return self.get_handle(nid, False)

    def apply_ordering(self, order, compact_ids: bool = True):
        """Renumber nodes following the given handle order."""
        mapping = {}
        for new_rank, h in enumerate(order):
            mapping[self._hid(h)] = new_rank + 1
        self._seqs = {mapping[i]: s for i, s in self._seqs.items()}
        self._edges = {
            self._canon((mapping[a[0]], a[1]), (mapping[b[0]], b[1])): None
            for (a, b) in self._edges
        }
        for pm in self._paths:
            pm["steps"] = [(mapping[sid], r) for sid, r in pm["steps"]]
        self._next_id = len(mapping) + 1
        self._dirty()

    def optimize(self, allow_id_reassignment: bool = True):
        order = [self.get_handle(nid, False) for nid in self._ids_sorted()]
        self.apply_ordering(order, True)

    # ---- IO ----------------------------------------------------------------

    def serialize(self, filename: str):
        from ..io.og_compat import save_og

        save_og(self.freeze(), filename)

    def load(self, filename: str):
        from ..cli.main import load_any
        from ..device import resolve_device

        g = load_any(filename, resolve_device(self._device))
        loaded = graph.from_tensors(g, self._device)
        self.__dict__.update(loaded.__dict__)

    def to_gfa(self):
        import io as _io
        import sys

        from ..io.gfa import write_gfa

        buf = _io.StringIO()
        write_gfa(self.freeze(), buf)
        sys.stdout.write(buf.getvalue())
