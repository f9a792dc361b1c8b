"""Positional path indexes, serializable (.xpt / .stpidx).

Plays the role of the reference's XP path index (src/algorithms/xp.{hpp,cpp},
built by `odgi pathindex`, consumed by `odgi panpos` / `odgi position` /
`odgi server`) and the sampled step index (src/algorithms/stepindex.{hpp,cpp},
`odgi stepindex`, consumed by tips/untangle).

The XP index's succinct machinery (CSA path names, rank/select bitvectors,
mmmulti-built np/nr/npi vectors — xp.hpp:156-222) exists to answer O(1)
position queries against a pointer-graph.  Our flat GraphTensors already
holds every answer as a dense prefix-summed tensor, so the "index" is just
those tensors persisted without sequence/edge payload, and every query is
a searchsorted.

Host code (Python and numpy): a copy of ``odgi_tpu/core/index.py`` with the
same results.  It imports nothing of ``odgi_tpu``.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass
from typing import BinaryIO, Dict, Optional, Tuple, Union

import numpy as np

from .graph import GraphTensors

XPT_MAGIC = b"XPTIDX01"
STP_MAGIC = b"STPIDX01"


def _write_arrays(out: BinaryIO, magic: bytes, meta: dict, arrays: Dict[str, np.ndarray]):
    out.write(magic)
    m = dict(meta)
    m["arrays"] = [
        [k, str(v.dtype), list(v.shape)] for k, v in arrays.items()
    ]
    mb = json.dumps(m).encode()
    out.write(struct.pack("<q", len(mb)))
    out.write(mb)
    for v in arrays.values():
        out.write(np.ascontiguousarray(v).tobytes())


def _read_arrays(src: BinaryIO, magic: bytes) -> Tuple[dict, Dict[str, np.ndarray]]:
    got = src.read(8)
    if got != magic:
        raise ValueError(f"bad index magic {got!r} (want {magic!r})")
    (mlen,) = struct.unpack("<q", src.read(8))
    meta = json.loads(src.read(mlen))
    arrays = {}
    for name, dtype, shape in meta.pop("arrays"):
        count = int(np.prod(shape)) if shape else 1
        buf = src.read(count * np.dtype(dtype).itemsize)
        arrays[name] = np.frombuffer(buf, dtype=dtype).reshape(shape).copy()
    return meta, arrays


@dataclass
class PathIndex:
    """Positional path index (role of xp::XP, src/algorithms/xp.hpp:43-175).

    Queries mirror the XP surface: path step counts, step->position,
    position->step, and path position -> pangenome position
    (xp.hpp:100-131)."""

    path_names: Tuple[str, ...]
    path_offset: np.ndarray   # i64[P+1] step CSR
    step_handle: np.ndarray   # i64[S] packed handles
    step_pos: np.ndarray      # i64[S] nucleotide offset within path
    node_pan_pos: np.ndarray  # i64[N] pangenome offset of each node rank
    node_len: np.ndarray      # i64[N]

    @staticmethod
    def build(g: GraphTensors) -> "PathIndex":
        return PathIndex(
            path_names=tuple(g.path_names),
            path_offset=g.path_offset.copy(),
            step_handle=g.step_handle.copy(),
            step_pos=g.step_pos.copy(),
            node_pan_pos=g.node_offset[:-1].copy()
            if g.num_nodes
            else np.zeros(0, np.int64),
            node_len=g.node_len.copy(),
        )

    # -- queries (xp.hpp:100-131) ------------------------------------------

    @property
    def num_paths(self) -> int:
        return len(self.path_names)

    def path_rank(self, name: str) -> Optional[int]:
        try:
            return self.path_names.index(name)
        except ValueError:
            return None

    def has_path(self, name: str) -> bool:
        return self.path_rank(name) is not None

    def path_length(self, p: int) -> int:
        lo, hi = int(self.path_offset[p]), int(self.path_offset[p + 1])
        if hi == lo:
            return 0
        last = hi - 1
        return int(self.step_pos[last]) + int(
            self.node_len[int(self.step_handle[last]) >> 1]
        )

    def has_position(self, name: str, pos: int) -> bool:
        p = self.path_rank(name)
        return p is not None and 0 <= pos < self.path_length(p)

    def get_path_step_count(self, p: int) -> int:
        return int(self.path_offset[p + 1] - self.path_offset[p])

    def get_position_of_step(self, step: int) -> int:
        return int(self.step_pos[step])

    def get_step_at_position(self, p: int, pos: int) -> int:
        """Global step index of the step covering path position `pos`."""
        lo, hi = int(self.path_offset[p]), int(self.path_offset[p + 1])
        k = int(np.searchsorted(self.step_pos[lo:hi], pos, side="right")) - 1
        return lo + max(0, k)

    def get_pangenome_pos(self, name: str, pos: int) -> int:
        """Pangenome (sort-order nucleotide) position of path:pos
        (xp.cpp get_pangenome_pos; used by panpos/server)."""
        p = self.path_rank(name)
        if p is None:
            raise KeyError(name)
        s = self.get_step_at_position(p, pos)
        h = int(self.step_handle[s])
        off_in_node = pos - int(self.step_pos[s])
        return int(self.node_pan_pos[h >> 1]) + off_in_node

    # -- serialization (.xpt; role of `odgi pathindex` .xp) ------------------

    def save(self, out: Union[str, BinaryIO]) -> None:
        close = isinstance(out, str)
        f = open(out, "wb") if close else out
        try:
            _write_arrays(
                f,
                XPT_MAGIC,
                {"path_names": list(self.path_names)},
                {
                    "path_offset": self.path_offset,
                    "step_handle": self.step_handle,
                    "step_pos": self.step_pos,
                    "node_pan_pos": self.node_pan_pos,
                    "node_len": self.node_len,
                },
            )
        finally:
            if close:
                f.close()

    @staticmethod
    def load(src: Union[str, BinaryIO]) -> "PathIndex":
        close = isinstance(src, str)
        f = open(src, "rb") if close else src
        try:
            meta, arrays = _read_arrays(f, XPT_MAGIC)
            return PathIndex(path_names=tuple(meta["path_names"]), **arrays)
        finally:
            if close:
                f.close()


@dataclass
class StepIndex:
    """Sampled step->position index (role of step_index_t,
    src/algorithms/stepindex.hpp:48-76, `odgi stepindex` .stpidx).

    The reference samples positions at rate-2^k nodes and walks the rest;
    we store positions for steps on sampled nodes and reconstruct unsampled
    ones by scanning backward along the path's step slice (bounded by the
    sample rate times the max node span)."""

    sample_rate: int
    path_names: Tuple[str, ...]
    path_offset: np.ndarray
    sampled_steps: np.ndarray  # i64[K] global step indices
    sampled_pos: np.ndarray    # i64[K]
    step_node: np.ndarray      # i64[S] node rank per step
    node_len: np.ndarray       # i64[N]

    @staticmethod
    def build(g: GraphTensors, sample_rate: int = 8) -> "StepIndex":
        node_rank = (g.step_handle >> 1).astype(np.int64)
        node_id = g.node_id[node_rank]
        if sample_rate > 0:
            mask = (node_id % sample_rate) == 0
        else:
            mask = np.ones(g.num_steps, dtype=bool)
        # always sample first step of each path so reconstruction terminates
        firsts = g.path_offset[:-1][np.diff(g.path_offset) > 0]
        mask[firsts] = True
        idx = np.nonzero(mask)[0].astype(np.int64)
        return StepIndex(
            sample_rate=sample_rate,
            path_names=tuple(g.path_names),
            path_offset=g.path_offset.copy(),
            sampled_steps=idx,
            sampled_pos=g.step_pos[idx].copy(),
            step_node=node_rank,
            node_len=g.node_len.copy(),
        )

    def get_position(self, step: int) -> int:
        """Path position of a global step index (stepindex.hpp
        step_index_t::get_position)."""
        k = int(np.searchsorted(self.sampled_steps, step, side="right")) - 1
        anchor = int(self.sampled_steps[k])
        pos = int(self.sampled_pos[k])
        # walk forward from the sampled anchor to the queried step
        for s in range(anchor, step):
            pos += int(self.node_len[int(self.step_node[s])])
        return pos

    def save(self, out: Union[str, BinaryIO]) -> None:
        close = isinstance(out, str)
        f = open(out, "wb") if close else out
        try:
            _write_arrays(
                f,
                STP_MAGIC,
                {
                    "path_names": list(self.path_names),
                    "sample_rate": self.sample_rate,
                },
                {
                    "path_offset": self.path_offset,
                    "sampled_steps": self.sampled_steps,
                    "sampled_pos": self.sampled_pos,
                    "step_node": self.step_node,
                    "node_len": self.node_len,
                },
            )
        finally:
            if close:
                f.close()

    @staticmethod
    def load(src: Union[str, BinaryIO]) -> "StepIndex":
        close = isinstance(src, str)
        f = open(src, "rb") if close else src
        try:
            meta, arrays = _read_arrays(f, STP_MAGIC)
            return StepIndex(
                sample_rate=int(meta["sample_rate"]),
                path_names=tuple(meta["path_names"]),
                **arrays,
            )
        finally:
            if close:
                f.close()


# ---------------------------------------------------------------------------
# Linear index (reference: src/algorithms/linear_index.hpp:15-21)
# ---------------------------------------------------------------------------


@dataclass
class LinearIndex:
    """Concatenated forward graph sequence + per-handle start offsets
    (reference linear_index_t: graph_seq, handle_positions,
    position_of_handle)."""

    graph_seq: bytes
    handle_positions: np.ndarray  # i64[N]

    @staticmethod
    def build(g: GraphTensors) -> "LinearIndex":
        return LinearIndex(
            graph_seq=g.seq.tobytes(),
            handle_positions=np.asarray(g.seq_offset[:-1], np.int64).copy(),
        )

    def position_of_handle(self, handle: int) -> int:
        """Offset of the handle's node sequence in the concatenated
        graph sequence (rank-packed handle, orientation ignored like the
        reference's forward storage)."""
        return int(self.handle_positions[int(handle) >> 1])
