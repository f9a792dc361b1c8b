"""Bit-compatible reader/writer for the reference's ``.og`` graph container.

A copy of ``odgi_tpu/io/og_compat.py``: the same bytes in both directions.
One difference: ``load_og`` also reads empty paths, where ``odgi_tpu``'s
raises (``KeyError`` for a graph without node id 1, ``IndexError`` for an
empty last path).

The reference serializes its dynamic succinct graph as (reference:
src/odgi.cpp:1632-1686 ``serialize_members``, magic ``1988148666`` written
big-endian by libhandlegraph's ``SerializableHandleGraph``):

  [u32be magic] [u64 max_node_id] [u64 min_node_id] [u64 node_count]
  [u64 edge_count] [u64 path_count] [u64 path_handle_next] [u64 id_increment]
  node records x node_count, then path_count metadata records of
  [u64 length] [2x u64 first step handle] [2x u64 last step handle]
  [u64 name_len] [name bytes]

Each node record (reference: src/node.cpp:422-436 ``node_t::serialize``):
  [u64 seq_len] [seq] [u64 id] [edges vec] [decoding vec] [paths vec]

where each vector is a serialized ``dyn::hacked_vector`` (the DYNAMIC dep is
not present in the snapshot; this wire format was reverse-engineered from
``test/DRB1-3123_sorted.og`` and verified over all 3214 node records):

  [u64 n_words] [n_words x u64 LE words] [u64 MASK] [u64 size]
  [u8 width] [u8 ints_per_word]

with ``ints_per_word = 64 // width``, ``MASK = (1 << width) - 1``, and
element ``j`` packed LSB-first at bits ``(j % ipw) * width`` of word
``j // ipw`` (no prefix-sum field -- the "hacked" vector drops psum).

``n_words`` is the vector's ALLOCATION CAPACITY, not the used word count.
The growth rule was reverse-engineered by exhaustive fit against all 9642
vectors of ``test/DRB1-3123_sorted.og`` (0 mismatches; see _HackedVector):

  - width starts at 0; ``push_back(x)`` with ``bitsize(x) > width`` rebuilds
    at the new width with ``n_words = ceil((size+1)/ipw) + 2``;
  - a full ``push_back`` without width change appends ONE word;
  - ``set(i, x)`` with ``bitsize(x) > width`` rebuilds with
    ``n_words = ceil(max(size,1)/ipw) + 2`` (no incoming element);
  - capacity words beyond ``ceil(size/ipw)`` and slack bits are zero.

Byte-identical re-encode therefore requires replaying the reference's
construction history: per-node ``paths`` vectors keep their build-time
capacities (graph_t::apply_ordering edits them in place, src/odgi.cpp:840
-> node_t::apply_ordering, src/node.cpp:344-409, which rebuilds only
``edges`` and ``decoding``), so save_og simulates create_step/link_steps
(src/odgi.cpp append_step/create_step/link_steps; node.cpp:96-108) over
the steps in path-major order.

Record semantics (reference: src/node.cpp, src/node.hpp):
  - edges: flat pairs ``[other_id, type]`` with raw neighbor ids and
    ``type = other_rev | on_rev << 1 | to_curr << 2``
    (edge_helper::pack, src/node.hpp:54-67; filled by create_edge,
    src/odgi.cpp:613-659: the left side stores to_curr=0, the right side
    to_curr=1, self-loops only once with to_curr=0).
  - decoding: per-node first-use dictionary of delta-encoded neighbor ids,
    ``delta = 0`` for self else ``(|other-id| << 1) | (other > id)``
    (to_delta/from_delta, src/node.hpp:34-51).
  - paths: 6-int records ``[path_id_1based, flags, prev_idx, prev_rank,
    next_idx, next_rank]`` where flags =
    ``is_rev | is_start << 1 | is_end << 2 | is_del << 3``
    (step_type_helper, src/node.hpp:68-85), prev/next_idx index the
    decoding dictionary, and ranks are node-local step ranks -- steps form
    doubly-linked lists across nodes (add_path_step, src/node.cpp:96-108).

Path metadata ``first``/``last`` are step handles = (node handle, node-local
rank) with node handle = ``(id - 1 - id_increment) << 1 | is_rev``
(number_bool_packing; get_handle src/odgi.cpp:30-38).  Path circularity is
NOT serialized (path_metadata_t, src/odgi.hpp:457-464 -- the atomic bool is
skipped by serialize_members), matching reference behavior.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, List, Tuple, Union

import numpy as np

from ..core.graph import GraphTensors

OG_MAGIC_BE = struct.pack(">I", 1988148666)


# ---------------------------------------------------------------------------
# hacked_vector codec
# ---------------------------------------------------------------------------


def _read_hacked_vector(buf: memoryview, p: int) -> Tuple[np.ndarray, int]:
    (n_words,) = struct.unpack_from("<Q", buf, p)
    p += 8
    words = np.frombuffer(buf, dtype="<u8", count=n_words, offset=p)
    p += 8 * n_words
    mask, size = struct.unpack_from("<2Q", buf, p)
    p += 16
    width, ipw = struct.unpack_from("<2B", buf, p)
    p += 2
    if size == 0:
        return np.zeros(0, dtype=np.int64), p
    if width == 0 or ipw == 0:
        raise ValueError("corrupt hacked_vector: zero width with nonzero size")
    shifts = (np.arange(ipw, dtype=np.uint64) * np.uint64(width))[None, :]
    slots = (words[:, None] >> shifts) & np.uint64(mask)
    return slots.ravel()[:size].astype(np.int64), p


class _HackedVector:
    """Exact simulation of ``dyn::hacked_vector`` growth (fit against all
    9642 vectors of the sorted DRB1 fixture, zero mismatches; see module
    docstring).  Tracks the values AND the capacity/width history, so the
    serialized bytes match what the reference would write."""

    __slots__ = ("vals", "w", "W")

    def __init__(self) -> None:
        self.vals: List[int] = []
        self.w = 0
        self.W = 0

    def _rebuild(self, bl: int, incoming: int) -> None:
        self.w = bl
        ipw = 64 // bl
        self.W = -(-max(len(self.vals) + incoming, 1) // ipw) + 2

    def push(self, x: int) -> None:
        bl = max(1, int(x).bit_length())
        if bl > self.w:
            self._rebuild(bl, 1)
        if len(self.vals) + 1 > self.W * (64 // self.w):
            self.W += 1
        self.vals.append(int(x))

    def set(self, i: int, x: int) -> None:
        bl = max(1, int(x).bit_length())
        if bl > self.w:
            self._rebuild(bl, 0)
        self.vals[i] = int(x)

    def write(self, out: BinaryIO) -> None:
        size = len(self.vals)
        if self.w == 0:
            # never-pushed vector: default-constructed state
            out.write(struct.pack("<Q2Q2B", 0, 0, 0, 0, 0))
            return
        width = self.w
        ipw = 64 // width
        n_words = self.W
        padded = np.zeros(n_words * ipw, dtype=np.uint64)
        padded[:size] = np.asarray(self.vals, dtype=np.uint64)
        shifts = (np.arange(ipw, dtype=np.uint64) * np.uint64(width))[None, :]
        words = (padded.reshape(n_words, ipw) << shifts).sum(
            axis=1, dtype=np.uint64
        )
        out.write(struct.pack("<Q", n_words))
        out.write(words.astype("<u8").tobytes())
        out.write(struct.pack("<2Q2B", (1 << width) - 1, size, width, ipw))


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


def load_og(src: Union[str, bytes, BinaryIO]) -> GraphTensors:
    """Load a reference ``.og`` file into GraphTensors.

    Reconstructs the flattened step tensor by walking every embedded path's
    doubly-linked step list in lockstep (all paths advance one step per
    numpy-gather iteration), replacing the reference's per-step pointer
    chases (graph_t::get_next_step, src/odgi.cpp:394-430).
    """
    if isinstance(src, str):
        with open(src, "rb") as f:
            data = f.read()
    elif isinstance(src, bytes):
        data = src
    else:
        data = src.read()
    buf = memoryview(data)
    if bytes(buf[:4]) != OG_MAGIC_BE:
        raise ValueError("not a reference .og file (bad magic)")
    (
        _max_id,
        _min_id,
        node_count,
        edge_count,
        path_count,
        _path_next,
        id_increment,
    ) = struct.unpack_from("<7Q", buf, 4)
    p = 4 + 7 * 8

    seqs: List[bytes] = []
    node_ids = np.zeros(node_count, dtype=np.int64)
    edges_per_node: List[np.ndarray] = []
    # flattened per-node paths records + decoding dicts for the lockstep walk
    paths_flat: List[np.ndarray] = []
    dec_flat: List[np.ndarray] = []
    for i in range(node_count):
        (seq_len,) = struct.unpack_from("<Q", buf, p)
        p += 8
        seqs.append(bytes(buf[p : p + seq_len]))
        p += seq_len
        (nid,) = struct.unpack_from("<Q", buf, p)
        p += 8
        node_ids[i] = nid
        ev, p = _read_hacked_vector(buf, p)
        dv, p = _read_hacked_vector(buf, p)
        pv, p = _read_hacked_vector(buf, p)
        edges_per_node.append(ev)
        dec_flat.append(dv)
        paths_flat.append(pv)

    # node id -> rank
    id_to_rank = {int(nid): r for r, nid in enumerate(node_ids)}

    node_len = np.array([len(s) for s in seqs], dtype=np.int64)
    seq = np.frombuffer(b"".join(seqs), dtype=np.uint8).copy()
    seq_offset = np.zeros(node_count + 1, dtype=np.int64)
    np.cumsum(node_len, out=seq_offset[1:])

    # ---- edges: emit each edge once, in CREATION order ----
    # Each create_edge (src/odgi.cpp:613-659) appends a to_curr=0 record to
    # the from-node and (for non-self-loops) a to_curr=1 record to the
    # to-node; per-node record order is the projection of the global
    # creation order.  Merge the per-node queues back into one global
    # sequence (any linearization consistent with every per-node order
    # projects back identically, which is what byte-stable re-encode
    # needs).  Greedy: emit a front to_curr=0 record once its partner is
    # at the to-node's front.
    recs: List[np.ndarray] = []
    for i, ev in enumerate(edges_per_node):
        if len(ev):
            r = np.empty((len(ev) // 2, 3), dtype=np.int64)
            r[:, 0] = [id_to_rank[int(x)] for x in ev[0::2]]
            r[:, 1] = ev[1::2]
            r[:, 2] = i
            recs.append(r)
        else:
            recs.append(np.zeros((0, 3), dtype=np.int64))
    front = [0] * node_count
    ef: List[int] = []
    et: List[int] = []

    def _drain(i: int) -> bool:
        """Emit as many front records of node i as possible.  A to_curr=1
        front waits for the partner node's pass; a to_curr=0 front emits
        when its partner record is at the to-node's front."""
        r = recs[i]
        progressed = False
        while front[i] < len(r):
            other, etype, _ = r[front[i]]
            other = int(other)
            other_rev, on_rev, to_curr = etype & 1, (etype >> 1) & 1, etype >> 2
            if to_curr:
                break
            if other == i:  # self-loop: single record
                ef.append((i << 1) | int(on_rev))
                et.append((i << 1) | int(other_rev))
                front[i] += 1
                progressed = True
                continue
            ro = recs[other]
            if front[other] >= len(ro):
                break
            o2, t2, _ = ro[front[other]]
            if not (
                int(o2) == i
                and (t2 >> 2) == 1
                and (t2 & 1) == on_rev
                and ((t2 >> 1) & 1) == other_rev
            ):
                break
            ef.append((i << 1) | int(on_rev))
            et.append((other << 1) | int(other_rev))
            front[i] += 1
            front[other] += 1
            progressed = True
        return progressed

    remaining = [i for i in range(node_count) if len(recs[i])]
    while remaining:
        progressed = False
        for i in remaining:
            progressed |= _drain(i)
        remaining = [i for i in remaining if front[i] < len(recs[i])]
        if not progressed:
            # No consistent linearization (e.g. racy concurrent build):
            # consume remaining to_curr=0 records in node order; loses
            # byte-stable re-encode only for such files.
            for i in remaining:
                for other, etype, _ in recs[i][front[i] :]:
                    if etype >> 2:
                        continue
                    ef.append((i << 1) | int((etype >> 1) & 1))
                    et.append((int(other) << 1) | int(etype & 1))
            break
    edge_from = np.array(ef, dtype=np.int64)
    edge_to = np.array(et, dtype=np.int64)

    # ---- paths: metadata then lockstep linked-list walk ----
    path_names: List[str] = []
    path_len = np.zeros(path_count, dtype=np.int64)
    first_node = np.zeros(path_count, dtype=np.int64)  # node rank
    first_rank = np.zeros(path_count, dtype=np.int64)  # node-local step rank
    for j in range(path_count):
        (length, f_handle, f_rank, _l_handle, _l_rank, name_len) = (
            struct.unpack_from("<6Q", buf, p)
        )
        p += 48
        name = bytes(buf[p : p + name_len]).decode()
        p += name_len
        path_names.append(name)
        path_len[j] = length
        if length:
            # an empty path's first handle is 0, whose id need not exist
            fid = (f_handle >> 1) + 1 + id_increment  # id of first node
            first_node[j] = id_to_rank[int(fid)]
            first_rank[j] = f_rank

    # flatten per-node records for vectorized gathers
    prec_off = np.zeros(node_count + 1, dtype=np.int64)
    np.cumsum([len(v) for v in paths_flat], out=prec_off[1:])
    prec = (
        np.concatenate(paths_flat)
        if paths_flat
        else np.zeros(0, dtype=np.int64)
    )
    dec_off = np.zeros(node_count + 1, dtype=np.int64)
    np.cumsum([len(v) for v in dec_flat], out=dec_off[1:])
    dec = np.concatenate(dec_flat) if dec_flat else np.zeros(0, dtype=np.int64)

    total_steps = int(path_len.sum())
    step_handle = np.zeros(total_steps, dtype=np.int64)
    path_offset = np.zeros(path_count + 1, dtype=np.int64)
    np.cumsum(path_len, out=path_offset[1:])

    cur_node = first_node.copy()
    cur_rank = first_rank.copy()
    cursor = path_offset[:-1].copy()
    active = path_len > 0
    max_len = int(path_len.max()) if path_count else 0
    for _ in range(max_len):
        if not active.any():
            break
        n = cur_node[active]
        r = cur_rank[active]
        base = prec_off[n] + 6 * r
        pid = prec[base]  # 1-based path id
        if not np.array_equal(pid - 1, np.flatnonzero(active)):
            raise ValueError(".og path linked list: path id mismatch")
        flags = prec[base + 1]
        is_rev = flags & 1
        is_end = (flags >> 2) & 1
        step_handle[cursor[active]] = (n << 1) | is_rev
        # advance to next step via delta decode
        nxt_idx = prec[base + 4]
        nxt_rank = prec[base + 5]
        delta = dec[dec_off[n] + nxt_idx]
        nid = node_ids[n]
        other = np.where(
            delta == 0, nid, np.where(delta & 1, nid + (delta >> 1), nid - (delta >> 1))
        )
        nxt_node = np.array([id_to_rank[int(x)] for x in other], dtype=np.int64)
        cursor[active] += 1
        still = is_end == 0
        idx = np.flatnonzero(active)
        cur_node[idx] = nxt_node
        cur_rank[idx] = nxt_rank
        active[idx[still == 0]] = False
    if not np.array_equal(cursor, path_offset[1:]):
        raise ValueError(".og path walk did not consume declared step counts")

    # step positions: cumulative node lengths along each path
    lens = node_len[step_handle >> 1]
    step_pos = np.zeros(total_steps, dtype=np.int64)
    cum = np.cumsum(lens)
    step_pos[1:] = cum[:-1]
    if total_steps:
        # an empty path repeats nothing: clip its start into range
        first = step_pos[np.minimum(path_offset[:-1], total_steps - 1)]
        step_pos -= np.repeat(first, path_len)

    return GraphTensors(
        node_len=node_len,
        seq_offset=seq_offset,
        seq=seq,
        node_id=node_ids,
        edge_from=edge_from,
        edge_to=edge_to,
        path_names=tuple(path_names),
        path_circular=np.zeros(path_count, dtype=bool),
        path_offset=path_offset,
        step_handle=step_handle,
        step_pos=step_pos,
    )


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def save_og(g: GraphTensors, out: Union[str, BinaryIO]) -> None:
    """Write GraphTensors as a byte-stable, reference-loadable ``.og``.

    Replays the reference's construction history so the re-encode of a
    loaded reference file is byte-identical (verified against
    ``test/DRB1-3123_sorted.og``):

    - paths vectors: simulate create_step (push [path_id, rev|start|end,
      enc(self), 0, enc(self), 0]) then link_steps sets (next_idx/rank +
      is_end=0 on the previous node, prev_idx/rank + is_start=0 on this
      node) per step in path-major order (src/odgi.cpp append_step;
      src/node.cpp:96-108 add_path_step);
    - decoding vectors: first-use delta dictionaries built by those
      encode() calls (src/node.cpp:26-41), re-encoded at final ids exactly
      as node_t::apply_ordering does (src/node.cpp:353-374);
    - edges vectors: replay create_edge in edge-array order, appending the
      to_curr=0 record to the from-node and the to_curr=1 record to the
      to-node (src/odgi.cpp:613-659; type bits edge_helper::pack,
      src/node.hpp:54-67).
    """
    close = False
    if isinstance(out, str):
        out = open(out, "wb")
        close = True
    try:
        N = g.num_nodes
        P = g.num_paths
        S = g.num_steps
        node_ids = g.node_id.astype(np.int64)
        id_increment = 0
        out.write(OG_MAGIC_BE)
        out.write(
            struct.pack(
                "<7Q",
                int(node_ids.max()) if N else 0,
                int(node_ids.min()) if N else 0,
                N,
                g.num_edges,
                P,
                P,
                id_increment,
            )
        )

        ranks = (g.step_handle >> 1).astype(np.int64)
        revs = (g.step_handle & 1).astype(np.int64)
        pc = g.path_step_count
        path_of_step = g.step_path
        step_rank_in_path = g.step_rank

        # node-local rank = number of prior (path-major) steps on the node
        local_rank = np.zeros(S, dtype=np.int64)
        seen = np.zeros(N, dtype=np.int64)
        for s in range(S):
            n = ranks[s]
            local_rank[s] = seen[n]
            seen[n] += 1

        node_paths = [_HackedVector() for _ in range(N)]
        node_dec_order: List[List[int]] = [[] for _ in range(N)]
        node_dec_idx: List[dict] = [dict() for _ in range(N)]

        def encode(n: int, other: int) -> int:
            """First-use dictionary index of neighbor `other` on node `n`
            (keyed by node rank; bijective with the stored delta)."""
            d = node_dec_idx[n]
            i = d.get(other)
            if i is None:
                i = len(d)
                d[other] = i
                node_dec_order[n].append(other)
            return i

        for s in range(S):
            n = int(ranks[s])
            r = int(step_rank_in_path[s])
            v = node_paths[n]
            # create_step: record pushed with is_start=is_end=1
            i0 = encode(n, n)
            v.push(int(path_of_step[s]) + 1)
            v.push(int(revs[s]) | 6)
            v.push(i0)
            v.push(0)
            v.push(i0)
            v.push(0)
            if r > 0:
                pn = int(ranks[s - 1])
                pv = node_paths[pn]
                pr = int(local_rank[s - 1]) * 6
                # link_steps: from-node next fields, then to-node prev
                pv.set(pr + 4, encode(pn, n))
                pv.set(pr + 5, int(local_rank[s]))
                pv.set(pr + 1, pv.vals[pr + 1] & ~4)
                mr = int(local_rank[s]) * 6
                v.set(mr + 2, encode(n, pn))
                v.set(mr + 3, int(local_rank[s - 1]))
                v.set(mr + 1, v.vals[mr + 1] & ~2)

        # decoding vectors: final deltas in first-use order
        node_dec = [_HackedVector() for _ in range(N)]
        for n in range(N):
            nid = int(node_ids[n])
            for other in node_dec_order[n]:
                oid = int(node_ids[other])
                if oid == nid:
                    delta = 0
                elif oid > nid:
                    delta = ((oid - nid) << 1) | 1
                else:
                    delta = (nid - oid) << 1
                node_dec[n].push(delta)

        # edges vectors: replay create_edge in edge-array order
        node_edges = [_HackedVector() for _ in range(N)]
        for fh, th in zip(g.edge_from, g.edge_to):
            fn, fr = int(fh) >> 1, int(fh) & 1
            tn, tr = int(th) >> 1, int(th) & 1
            v = node_edges[fn]
            v.push(int(node_ids[tn]))
            v.push(tr | (fr << 1))
            if fn != tn:
                v = node_edges[tn]
                v.push(int(node_ids[fn]))
                v.push(fr | (tr << 1) | 4)

        for n in range(N):
            sq = g.node_seq(n)
            out.write(struct.pack("<Q", len(sq)))
            out.write(sq)
            out.write(struct.pack("<Q", int(node_ids[n])))
            node_edges[n].write(out)
            node_dec[n].write(out)
            node_paths[n].write(out)

        # path metadata: step handles pack (id - 1 - id_increment, is_rev)
        po = g.path_offset
        for j in range(P):
            length = int(pc[j])
            if length:
                f_s = int(po[j])
                l_s = int(po[j + 1]) - 1
                f_handle = int(
                    (node_ids[ranks[f_s]] - 1 - id_increment) << 1
                ) | int(revs[f_s])
                l_handle = int(
                    (node_ids[ranks[l_s]] - 1 - id_increment) << 1
                ) | int(revs[l_s])
                f_rank = int(local_rank[f_s])
                l_rank = int(local_rank[l_s])
            else:
                f_handle = l_handle = f_rank = l_rank = 0
            name = g.path_names[j].encode()
            out.write(
                struct.pack(
                    "<6Q", length, f_handle, f_rank, l_handle, l_rank, len(name)
                )
            )
            out.write(name)
    finally:
        if close:
            out.close()
