"""Immutable flat-array variation graph: the port's core data model.

The host-side counterpart of ``odgi_tpu/core/graph.py``, kept to what the
sort -> layout path reads.  Nodes, edges and paths are flat numpy arrays:

- nodes:  ``node_len[N]``, ``seq_offset[N+1]`` + ``seq[total_bp]``,
  ``node_id[N]`` (external ids; rank = index).
- edges:  packed-handle pairs ``edge_from[E]``, ``edge_to[E]``; a packed
  handle is ``rank << 1 | is_reverse``.  Edges are stored canonically once.
- paths:  one flattened step table: ``step_handle[S]``, ``path_offset[P+1]``
  (CSR offsets) and ``step_pos[S]`` (nucleotide offset of each step in its
  path).

Construction and edits stay on the host; the SGD runs copy the step
table into device tensors (see ``ops/strata_sgd.py`` ``fill_slots``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..utils.metrics import span

# ---------------------------------------------------------------------------
# Handle packing (libhandlegraph number_bool_packing convention)
# ---------------------------------------------------------------------------


def pack_handle(rank, is_reverse):
    """Pack node rank + orientation into a handle int: (rank << 1) | rev."""
    return (np.asarray(rank, dtype=np.int64) << 1) | np.asarray(
        is_reverse, dtype=np.int64
    )


def handle_rank(handle):
    """Node rank of a packed handle."""
    return np.asarray(handle) >> 1


def handle_is_reverse(handle):
    """Orientation bit of a packed handle."""
    return (np.asarray(handle) & 1).astype(bool)


def handle_flip(handle):
    """Flip the orientation of a packed handle."""
    return np.asarray(handle) ^ 1


# Reverse complement table over ASCII bytes.
_REVCOMP = np.arange(256, dtype=np.uint8)
for _a, _b in [
    (b"A", b"T"), (b"T", b"A"), (b"C", b"G"), (b"G", b"C"),
    (b"a", b"t"), (b"t", b"a"), (b"c", b"g"), (b"g", b"c"),
    (b"N", b"N"), (b"n", b"n"),
    (b"U", b"A"), (b"u", b"a"),
    (b"Y", b"R"), (b"R", b"Y"), (b"S", b"S"), (b"W", b"W"),
    (b"K", b"M"), (b"M", b"K"), (b"B", b"V"), (b"V", b"B"),
    (b"D", b"H"), (b"H", b"D"),
    (b"y", b"r"), (b"r", b"y"), (b"s", b"s"), (b"w", b"w"),
    (b"k", b"m"), (b"m", b"k"), (b"b", b"v"), (b"v", b"b"),
    (b"d", b"h"), (b"h", b"d"),
]:
    _REVCOMP[_a[0]] = _b[0]


def revcomp_bytes(seq: np.ndarray) -> np.ndarray:
    """Reverse-complement an ASCII uint8 sequence array."""
    return _REVCOMP[seq[::-1]]


# ---------------------------------------------------------------------------
# GraphTensors
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GraphTensors:
    """Immutable flat-array variation graph (see module docstring)."""

    node_len: np.ndarray       # i64[N] sequence length per node
    seq_offset: np.ndarray     # i64[N+1] offsets into `seq`
    seq: np.ndarray            # u8[total_bp] concatenated forward sequences
    node_id: np.ndarray        # i64[N] external node ids (rank = index)

    edge_from: np.ndarray      # i64[E] canonical packed-handle pairs
    edge_to: np.ndarray        # i64[E]

    path_names: Tuple[str, ...]
    path_circular: np.ndarray  # bool[P]
    path_offset: np.ndarray    # i64[P+1] CSR offsets into step arrays
    step_handle: np.ndarray    # i64[S] packed handles in path order
    step_pos: np.ndarray       # i64[S] nucleotide offset of step within path

    _cache: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def num_nodes(self) -> int:
        return len(self.node_len)

    @property
    def num_edges(self) -> int:
        return len(self.edge_from)

    @property
    def num_paths(self) -> int:
        return len(self.path_names)

    @property
    def num_steps(self) -> int:
        return len(self.step_handle)

    @property
    def total_length(self) -> int:
        """Total sequence length in bp."""
        return int(self.seq_offset[-1])

    def _cached(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    @property
    def step_path(self) -> np.ndarray:
        """i32[S]: path index of every step."""
        return self._cached(
            "step_path",
            lambda: np.repeat(
                np.arange(self.num_paths, dtype=np.int32),
                np.diff(self.path_offset),
            ),
        )

    @property
    def step_rank(self) -> np.ndarray:
        """i64[S]: rank of every step within its path."""
        return self._cached(
            "step_rank",
            lambda: np.arange(self.num_steps, dtype=np.int64)
            - self.path_offset[self.step_path],
        )

    @property
    def path_step_count(self) -> np.ndarray:
        """i64[P]: number of steps per path."""
        return self._cached("path_step_count", lambda: np.diff(self.path_offset))

    @property
    def path_length(self) -> np.ndarray:
        """i64[P]: nucleotide length of each path."""

        def compute():
            out = np.zeros(self.num_paths, dtype=np.int64)
            if self.num_steps:
                last = self.path_offset[1:] - 1
                first = self.path_offset[:-1]
                nonempty = last >= first
                ln = self.node_len[handle_rank(self.step_handle)]
                out[nonempty] = self.step_pos[last[nonempty]] + ln[last[nonempty]]
            return out

        return self._cached("path_length", compute)

    @property
    def node_offset(self) -> np.ndarray:
        """i64[N]: cumulative bp start of each node in current order (the
        seed of 1D PG-SGD)."""
        return self._cached("node_offset", lambda: self.seq_offset[:-1].copy())

    @property
    def id_to_rank(self) -> Dict[int, int]:
        """External node id -> rank lookup (host only)."""
        return self._cached(
            "id_to_rank",
            lambda: {int(i): r for r, i in enumerate(self.node_id)},
        )

    @property
    def step_node_pos(self) -> np.ndarray:
        """i64[S]: signed per-step positions: the 1-based start of the step
        in its path, negated for reverse steps."""

        def compute():
            pos = self.step_pos + 1
            rev = handle_is_reverse(self.step_handle)
            return np.where(rev, -pos, pos)

        return self._cached("step_node_pos", compute)

    @property
    def adjacency(self) -> "SideAdjacency":
        """CSR adjacency over packed handles; built lazily on host."""
        return self._cached("adjacency", lambda: SideAdjacency.build(self))

    def node_seq(self, rank: int, is_reverse: bool = False) -> bytes:
        s = self.seq[self.seq_offset[rank] : self.seq_offset[rank + 1]]
        if is_reverse:
            s = revcomp_bytes(s)
        return s.tobytes()

    def node_seq_str(self, rank: int, is_reverse: bool = False) -> str:
        return self.node_seq(rank, is_reverse).decode("ascii")

    # ---- integrity --------------------------------------------------------

    def is_optimized(self) -> bool:
        """True iff external ids are exactly 1..N in rank order."""
        return bool(
            np.array_equal(self.node_id, np.arange(1, self.num_nodes + 1))
        )

    def validate(self) -> List[str]:
        """Path/edge consistency (`odgi validate`): every consecutive step
        pair of every path must be joined by an edge.  Returns the problems
        as readable lines (empty: valid)."""
        problems: List[str] = []
        edge_set = set(zip(self.edge_from.tolist(), self.edge_to.tolist()))

        def has_edge(a, b):
            # edges are bidirected: a->b equals flip(b)->flip(a)
            return (a, b) in edge_set or (int(handle_flip(b)), int(handle_flip(a))) in edge_set

        for p in range(self.num_paths):
            lo, hi = int(self.path_offset[p]), int(self.path_offset[p + 1])
            hs = self.step_handle[lo:hi]
            for k in range(len(hs) - 1):
                a, b = int(hs[k]), int(hs[k + 1])
                if not has_edge(a, b):
                    problems.append(
                        f"path {self.path_names[p]!r} step {k}->{k+1}: "
                        f"missing edge between node ids "
                        f"{int(self.node_id[a >> 1])} and {int(self.node_id[b >> 1])}"
                    )
        return problems

    # ---- functional transforms -------------------------------------------

    @span("graph.apply_ordering")
    def apply_ordering(
        self, order: np.ndarray, compact_ids: bool = True
    ) -> "GraphTensors":
        """Renumber nodes by a new rank order: `order[k]` is the old rank of
        the node that gets new rank `k`.  With `compact_ids`, external ids
        become 1..N in the new order."""
        order = np.asarray(order, dtype=np.int64)
        n = self.num_nodes
        if len(order) != n:
            raise ValueError("order must be a permutation of all nodes")
        inv = np.empty(n, dtype=np.int64)
        inv[order] = np.arange(n, dtype=np.int64)

        new_len = self.node_len[order]
        new_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(new_len, out=new_off[1:])
        new_seq = self.seq[_ranges_gather_index(self.seq_offset[order], new_len)]

        def remap(h):
            return pack_handle(inv[handle_rank(h)], np.asarray(h) & 1)

        new_ids = (
            np.arange(1, n + 1, dtype=np.int64)
            if compact_ids
            else self.node_id[order]
        )
        return GraphTensors(
            node_len=new_len,
            seq_offset=new_off,
            seq=new_seq,
            node_id=new_ids,
            edge_from=remap(self.edge_from),
            edge_to=remap(self.edge_to),
            path_names=self.path_names,
            path_circular=self.path_circular,
            path_offset=self.path_offset,
            step_handle=remap(self.step_handle),
            step_pos=self.step_pos,
        )

    def optimize(self) -> "GraphTensors":
        """Compact ids to 1..N in the current order."""
        return self.apply_ordering(np.arange(self.num_nodes), compact_ids=True)

    def apply_orientations(self, flip_mask: np.ndarray) -> "GraphTensors":
        """Reverse-complement the nodes in `flip_mask` and rewrite every
        handle that touches them (used by groom)."""
        flip_mask = np.asarray(flip_mask, dtype=bool)
        if not flip_mask.any():
            return self
        new_seq = self.seq.copy()
        for r in np.nonzero(flip_mask)[0]:
            lo, hi = self.seq_offset[r], self.seq_offset[r + 1]
            new_seq[lo:hi] = revcomp_bytes(self.seq[lo:hi])

        def remap(h):
            h = np.asarray(h)
            return np.where(flip_mask[handle_rank(h)], h ^ 1, h)

        return dataclasses.replace(
            self,
            seq=new_seq,
            edge_from=remap(self.edge_from),
            edge_to=remap(self.edge_to),
            step_handle=remap(self.step_handle),
            _cache={},
        )

    def keep_paths(self, keep: Sequence[int]) -> "GraphTensors":
        """Subset to the given path indices."""
        keep = list(keep)
        counts = self.path_step_count
        new_names = tuple(self.path_names[i] for i in keep)
        new_circ = self.path_circular[keep] if self.num_paths else self.path_circular
        new_off = np.zeros(len(keep) + 1, dtype=np.int64)
        np.cumsum(counts[keep], out=new_off[1:])
        idx = _ranges_gather_index(self.path_offset[keep], counts[keep])
        return dataclasses.replace(
            self,
            path_names=new_names,
            path_circular=new_circ,
            path_offset=new_off,
            step_handle=self.step_handle[idx],
            step_pos=self.step_pos[idx],
            _cache={},
        )


def _ranges_gather_index(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Index array covering [starts[i], starts[i]+lengths[i]) ranges."""
    starts = np.asarray(starts, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    total = int(lengths.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    excl = np.cumsum(lengths) - lengths
    within = np.arange(total, dtype=np.int64) - np.repeat(excl, lengths)
    return np.repeat(starts, lengths) + within


# The largest packed (src, dst) key SideAdjacency.build dedupes on.
_PACKED_KEY_MAX = np.iinfo(np.int64).max


class SideAdjacency:
    """CSR adjacency over packed handles: `neighbors(h)` lists the handles
    reached by following edges rightward out of h.  Going left from h is
    going right from flip(h) and flipping the results."""

    def __init__(self, offsets: np.ndarray, targets: np.ndarray):
        self.offsets = offsets  # i64[2N+1]
        self.targets = targets  # i64[total]

    @staticmethod
    def build(g: GraphTensors) -> "SideAdjacency":
        # Each canonical edge (a -> b) means: right-of-a connects to b, and
        # right-of-flip(b) connects to flip(a).  The entries are sorted by
        # (src, dst), and a self-inverse edge (a -> flip(a)), listed twice,
        # is kept once: on one packed key src * 2N + dst, sorted in place,
        # while (2N)^2 fits in an int64, else on the rows.  (No np.unique:
        # numpy 2.3's took 1.7 s on a chromosome graph's 1.4M keys on an
        # H100 machine's host, the in-place sort 0.02 s.)
        n2 = 2 * g.num_nodes
        if n2 * n2 > _PACKED_KEY_MAX:
            return SideAdjacency._build_rows(g)
        E = len(g.edge_from)
        key = np.empty(2 * E, dtype=np.int64)
        fwd, rev = key[:E], key[E:]
        np.multiply(g.edge_from, n2, out=fwd)
        fwd += g.edge_to
        # flip(b) * 2N + flip(a) == (flip(b) * 2N + a) ^ 1, as 2N is even
        np.bitwise_xor(g.edge_to, 1, out=rev)
        rev *= n2
        rev += g.edge_from
        rev ^= 1
        key.sort()
        if len(key) > 1:
            dup = key[1:] == key[:-1]
            if dup.any():
                key = key[np.concatenate([[True], ~dup])]
        offsets = np.zeros(n2 + 1, dtype=np.int64)
        np.cumsum(np.bincount(key // n2, minlength=n2), out=offsets[1:])
        key %= n2
        return SideAdjacency(offsets, key)

    @staticmethod
    def _build_rows(g: GraphTensors) -> "SideAdjacency":
        """`build` on (src, dst) rows, where a packed key could overflow."""
        n2 = 2 * g.num_nodes
        src = np.concatenate([g.edge_from, handle_flip(g.edge_to)])
        dst = np.concatenate([g.edge_to, handle_flip(g.edge_from)])
        if len(src):
            pairs = np.unique(np.stack([src, dst], axis=1), axis=0)
            src, dst = pairs[:, 0], pairs[:, 1]
        counts = np.bincount(src, minlength=n2)
        offsets = np.zeros(n2 + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return SideAdjacency(offsets, dst.astype(np.int64))

    def neighbors(self, handle: int) -> np.ndarray:
        return self.targets[self.offsets[handle] : self.offsets[handle + 1]]

    def degree_out(self) -> np.ndarray:
        """Out-degree per packed handle (2N)."""
        return np.diff(self.offsets)


# ---------------------------------------------------------------------------
# GraphBuilder — host-side mutable construction
# ---------------------------------------------------------------------------


class GraphBuilder:
    """Mutable host-side builder; `build()` freezes into GraphTensors."""

    def __init__(self):
        self._seqs: List[bytes] = []
        self._ids: List[int] = []
        self._id_to_rank: Dict[int, int] = {}
        self._edges: set = set()
        self._edge_list: List[Tuple[int, int]] = []
        self._path_names: List[str] = []
        self._path_circular: List[bool] = []
        self._path_steps: List[List[int]] = []

    def add_node(self, node_id: int, seq: bytes) -> int:
        if node_id in self._id_to_rank:
            raise ValueError(f"duplicate node id {node_id}")
        rank = len(self._ids)
        self._ids.append(node_id)
        self._id_to_rank[node_id] = rank
        self._seqs.append(seq)
        return rank

    def has_node(self, node_id: int) -> bool:
        return node_id in self._id_to_rank

    def add_edge(self, id_a: int, rev_a: bool, id_b: int, rev_b: bool):
        a = (self._id_to_rank[id_a] << 1) | int(rev_a)
        b = (self._id_to_rank[id_b] << 1) | int(rev_b)
        self.add_edge_handles(a, b)

    def add_edge_handles(self, a: int, b: int):
        # Canonical form: the one of (a, b) and (flip(b), flip(a)) that
        # compares smaller.
        if (b ^ 1, a ^ 1) < (a, b):
            a, b = b ^ 1, a ^ 1
        if (a, b) not in self._edges:
            self._edges.add((a, b))
            self._edge_list.append((a, b))

    def add_path(self, name: str, circular: bool = False) -> int:
        self._path_names.append(name)
        self._path_circular.append(circular)
        self._path_steps.append([])
        return len(self._path_names) - 1

    def append_step(self, path_idx: int, node_id: int, is_reverse: bool):
        h = (self._id_to_rank[node_id] << 1) | int(is_reverse)
        self._path_steps[path_idx].append(h)

    def append_step_handle(self, path_idx: int, handle: int):
        self._path_steps[path_idx].append(handle)

    def build(self) -> GraphTensors:
        n = len(self._ids)
        node_len = np.array([len(s) for s in self._seqs], dtype=np.int64)
        seq_offset = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(node_len, out=seq_offset[1:])
        seq = (
            np.frombuffer(b"".join(self._seqs), dtype=np.uint8)
            if self._seqs
            else np.empty(0, dtype=np.uint8)
        )
        if self._edge_list:
            earr = np.array(self._edge_list, dtype=np.int64)
            edge_from, edge_to = earr[:, 0], earr[:, 1]
        else:
            edge_from = edge_to = np.empty(0, dtype=np.int64)
        p = len(self._path_names)
        path_offset = np.zeros(p + 1, dtype=np.int64)
        np.cumsum([len(s) for s in self._path_steps], out=path_offset[1:])
        step_handle = (
            np.concatenate(
                [np.asarray(s, dtype=np.int64) for s in self._path_steps]
            )
            if p and path_offset[-1]
            else np.empty(0, dtype=np.int64)
        )
        # Per-path nucleotide prefix positions (restart at path boundaries).
        step_pos = np.zeros(len(step_handle), dtype=np.int64)
        if len(step_handle):
            lens = node_len[step_handle >> 1]
            cum = np.cumsum(lens) - lens
            step_path = np.repeat(np.arange(p, dtype=np.int64), np.diff(path_offset))
            step_pos = cum - cum[path_offset[step_path]]
        return GraphTensors(
            node_len=node_len,
            seq_offset=seq_offset,
            seq=seq,
            node_id=np.asarray(self._ids, dtype=np.int64),
            edge_from=edge_from,
            edge_to=edge_to,
            path_names=tuple(self._path_names),
            path_circular=np.asarray(self._path_circular, dtype=bool),
            path_offset=path_offset,
            step_handle=step_handle,
            step_pos=step_pos,
        )
