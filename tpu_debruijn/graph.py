"""Path-compressed De Bruijn graph containers and traversal (L4/L5).

Reference: /root/reference/src/graph.rs.  ``BaseGraph`` is the SoA unitig
store (graph.rs:44-114); ``DebruijnGraph`` adds walkability
(graph.rs:172-342).  Where the reference indexes node end-kmers with two
minimal-perfect-hash maps (BoomHashMap, graph.rs:117-141), this build
keeps two *sorted* end-kmer limb arrays + id permutations and resolves
links with vectorized binary search — `find_link` (graph.rs:252-291)
becomes a batched device op, and the full edge table of the graph is
materialized in one shot for host traversal.

Node-level re-compression (`compress_graph`, the shard-merge/tip-clean
path, compression.rs:100-349) reuses the same pointer-doubling chain
machinery as kmer-level compression.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_debruijn import bases as B
from tpu_debruijn import compress as C
from tpu_debruijn import exts as E
from tpu_debruijn import kmer as KM
from tpu_debruijn import sorting as S
from tpu_debruijn.dna import DnaSeq, PackedSeqSet
from tpu_debruijn.exts import Dir, Exts
from tpu_debruijn.kmer import KmerSpec

LEFT, RIGHT = E.LEFT, E.RIGHT


class BaseGraph:
    """SoA unitig store: sequences + per-node Exts + per-node data.

    graph.rs:44-114 equivalent (data is an int32 payload; richer data
    lives host-side keyed by node id).
    """

    def __init__(self, k: int, stranded: bool):
        self.spec = KmerSpec(k)
        self.stranded = stranded
        self.sequences = PackedSeqSet()
        self._exts = np.zeros(0, np.int32)
        self._data = np.zeros(0, np.int32)
        self._exts_chunks: List[np.ndarray] = []
        self._data_chunks: List[np.ndarray] = []
        # optional generic-D sidecar: one arbitrary payload object per
        # node, alongside the int32 ``data`` lane — the BaseGraph<K, D>
        # rich-data role (graph.rs:44-50)
        self._rich: Optional[List] = None

    @property
    def rich(self) -> Optional[List]:
        """Per-node arbitrary payloads (aligned with nodes), or None."""
        return self._rich

    def _rich_ensure(self) -> List:
        if self._rich is None:
            self._rich = [None] * (len(self) - 0)
        return self._rich

    def _consolidate(self) -> None:
        if self._exts_chunks:
            self._exts = np.concatenate([self._exts] + self._exts_chunks)
            self._data = np.concatenate([self._data] + self._data_chunks)
            self._exts_chunks = []
            self._data_chunks = []

    @property
    def exts(self) -> np.ndarray:
        self._consolidate()
        return self._exts

    @exts.setter
    def exts(self, value) -> None:
        self._consolidate()
        self._exts = np.asarray(value, np.int32)

    @property
    def data(self) -> np.ndarray:
        self._consolidate()
        return self._data

    @data.setter
    def data(self, value) -> None:
        self._consolidate()
        self._data = np.asarray(value, np.int32)

    def __len__(self):
        return len(self.sequences)

    def is_empty(self) -> bool:
        return len(self) == 0

    def add(self, bases, exts: int, data: int = 0, rich=None) -> None:
        n_before = len(self)
        self.sequences.add(np.asarray(bases, np.uint8))
        self._exts_chunks.append(np.array([exts], np.int32))
        self._data_chunks.append(np.array([data], np.int32))
        if rich is not None or self._rich is not None:
            if self._rich is None:
                self._rich = [None] * n_before
            self._rich.append(rich)

    def add_flat(self, seq_flat, lengths, exts, data=None, rich=None) -> None:
        """Bulk-append many unitigs: concatenated bases + per-node arrays.

        The O(1)-Python path used by combine and the flat assemblers; per
        graph.rs:104 semantics but without a per-node loop.  ``rich`` may
        be a list of per-node payload objects (generic D sidecar).
        """
        n_before = len(self)
        lengths = np.asarray(lengths, np.int64)
        self.sequences.add_flat(seq_flat, lengths)
        self._exts_chunks.append(np.asarray(exts, np.int32))
        self._data_chunks.append(
            np.zeros(len(lengths), np.int32)
            if data is None
            else np.asarray(data, np.int32)
        )
        if rich is not None or self._rich is not None:
            if self._rich is None:
                self._rich = [None] * n_before
            if rich is None:
                rich = [None] * len(lengths)
            if len(rich) != len(lengths):
                raise ValueError("rich sidecar length != node count")
            self._rich.extend(rich)

    @staticmethod
    def combine(graphs: Sequence["BaseGraph"]) -> "BaseGraph":
        """Concatenate shard graphs (graph.rs:71-101); mixed strandedness
        is an error.  Pure array concatenation — no per-node loop."""
        graphs = list(graphs)
        if not graphs:
            raise ValueError("no graphs to combine")
        strandeds = {g.stranded for g in graphs}
        if len(strandeds) != 1:
            raise ValueError("attempted to combine stranded and unstranded graphs")
        out = BaseGraph(graphs[0].spec.k, graphs[0].stranded)
        for g in graphs:
            out.add_flat(
                g.sequences._flat(), g.sequences.length, g.exts, g.data,
                rich=g.rich,
            )
        return out

    def finish(self) -> "DebruijnGraph":
        """Build the sorted end-kmer indexes (graph.rs:117-141)."""
        return DebruijnGraph(self)


def from_compress_output(k: int, stranded: bool, nodes) -> BaseGraph:
    """Wrap compress.compress_kmers output [(bases, exts, data)].

    Non-integer data payloads (compress_kmers_rich output) go to the
    ``rich`` sidecar with data = 0."""
    g = BaseGraph(k, stranded)
    for seq, exts, data in nodes:
        if isinstance(data, (int, np.integer)):
            g.add(seq, exts, int(data))
        else:
            g.add(seq, exts, 0, rich=data)
    return g


def from_flat_output(k: int, stranded: bool, seq_flat, lengths, exts, data=None) -> BaseGraph:
    """Wrap compress.assemble_unitigs_flat output — the bulk path."""
    g = BaseGraph(k, stranded)
    g.add_flat(seq_flat, lengths, exts, data)
    return g


@partial(jax.jit, static_argnums=(0, 1))
def _link_and_edges(spec, stranded, lk_sorted, lk_ids, rk_sorted, rk_ids,
                    first_k, last_k):
    """All candidate links of the graph in one batch.

    For each node, dir, base: the find_link result of term_kmer.extend
    (graph.rs:223-241).  Returns (target, in_side, flip, found) with
    shape (N, 2, 4); callers AND ``found`` with the extension bits to get
    actual edges (kept separate so exts edits don't re-run the search).
    """
    n = first_k.shape[0]
    targets = []
    insides = []
    flips = []
    exist = []
    for d in (LEFT, RIGHT):
        term = first_k if d == LEFT else last_k
        for b in range(4):
            cand = (
                KM.extend_left(spec, term, np.uint32(b))
                if d == LEFT
                else KM.extend_right(spec, term, np.uint32(b))
            )
            t, side, fl, ok = _find_link_device(
                spec, stranded, d, cand, lk_sorted, lk_ids, rk_sorted, rk_ids
            )
            targets.append(t)
            insides.append(side)
            flips.append(fl)
            exist.append(ok)
    shape = (2, 4, n)
    return (
        jnp.stack(targets).reshape(shape).transpose(2, 0, 1),
        jnp.stack(insides).reshape(shape).transpose(2, 0, 1),
        jnp.stack(flips).reshape(shape).transpose(2, 0, 1),
        jnp.stack(exist).reshape(shape).transpose(2, 0, 1),
    )


def _find_link_device(spec, stranded, d, kmers, lk_sorted, lk_ids, rk_sorted,
                      rk_ids, n_valid=None):
    """Batched find_link (graph.rs:252-291): same-strand probe first,
    then the rc probe in unstranded graphs.

    ``n_valid`` bounds the logical length of the sorted index arrays
    (entries beyond are padding) — used by the collective shard stitch,
    which works on padded allgathered tables.
    """
    if d == LEFT:
        prim_sorted, prim_ids, prim_side = rk_sorted, rk_ids, RIGHT
        sec_sorted, sec_ids, sec_side = lk_sorted, lk_ids, LEFT
    else:
        prim_sorted, prim_ids, prim_side = lk_sorted, lk_ids, LEFT
        sec_sorted, sec_ids, sec_side = rk_sorted, rk_ids, RIGHT
    i1, f1 = S.searchsorted_limbs(prim_sorted, kmers, n_valid)
    t1 = prim_ids[jnp.clip(i1, 0, prim_ids.shape[0] - 1)]
    if stranded:
        return t1, jnp.full_like(t1, prim_side), jnp.zeros_like(f1), f1
    rck = KM.rc(spec, kmers)
    i2, f2 = S.searchsorted_limbs(sec_sorted, rck, n_valid)
    t2 = sec_ids[jnp.clip(i2, 0, sec_ids.shape[0] - 1)]
    target = jnp.where(f1, t1, t2)
    side = jnp.where(f1, prim_side, sec_side)
    flip = (~f1) & f2
    return target, side, flip, f1 | f2


def _fix_exts_device(spec, stranded, lk_sorted, lk_ids, rk_sorted, rk_ids,
                     first_k, last_k, exts, valid, n_valid=None):
    """Device fix_exts (graph.rs:337-377): keep only extensions whose
    target kmer is the end kmer of a valid node.  Works on padded node
    tables (``valid`` masks live slots; ``n_valid`` bounds the indexes)."""
    n = first_k.shape[0]
    fixed = jnp.zeros_like(exts)
    for d in (LEFT, RIGHT):
        term = first_k if d == LEFT else last_k
        for b in range(4):
            cand = (
                KM.extend_left(spec, term, np.uint32(b))
                if d == LEFT
                else KM.extend_right(spec, term, np.uint32(b))
            )
            t, _, _, ok = _find_link_device(
                spec, stranded, d, cand, lk_sorted, lk_ids, rk_sorted, rk_ids,
                n_valid,
            )
            tc = jnp.clip(t, 0, n - 1)
            keep = E.has_ext(exts, d, b) & ok & valid[tc]
            fixed = jnp.where(keep, E.set_ext(fixed, d, b), fixed)
    return jnp.where(valid, fixed, 0)


class DebruijnGraph:
    """Walkable compressed graph: BaseGraph + sorted end-kmer indexes."""

    def __init__(self, base: BaseGraph):
        self.base = base
        self.spec = base.spec
        self.stranded = base.stranded
        n = len(base)
        k = self.spec.k
        w = self.spec.w
        if n:
            flat = base.sequences._flat()
            starts = np.asarray(base.sequences.start, np.int64)
            lens = np.asarray(base.sequences.length, np.int64)
            ar = np.arange(k)[None, :]
            first = flat[starts[:, None] + ar]
            last = flat[(starts + lens - k)[:, None] + ar]
            self.first_kmers = KM.from_bases_batch_np(self.spec, first)
            self.last_kmers = KM.from_bases_batch_np(self.spec, last)
        else:
            self.first_kmers = np.zeros((0, w), np.uint32)
            self.last_kmers = np.zeros((0, w), np.uint32)
        self.exts = np.asarray(base.exts, np.int32)
        self.data = np.asarray(base.data, np.int32)
        self.rich = base.rich

        order_l = self._sort_ids(self.first_kmers)
        order_r = self._sort_ids(self.last_kmers)
        self._lk_sorted = self.first_kmers[order_l]
        self._lk_ids = order_l.astype(np.int32)
        self._rk_sorted = self.last_kmers[order_r]
        self._rk_ids = order_r.astype(np.int32)
        self._edges = None
        self._links = None  # exts-independent link results (cached once)
        self._lk_bytes = None  # lazy byte-key views for searchsorted
        self._rk_bytes = None

    @staticmethod
    def _sort_ids(kmers: np.ndarray) -> np.ndarray:
        if len(kmers) == 0:
            return np.zeros(0, np.int64)
        return np.lexsort(tuple(kmers[:, i] for i in range(kmers.shape[1] - 1, -1, -1)))

    # -- basic accessors -------------------------------------------------
    def __len__(self):
        return len(self.base)

    def is_empty(self):
        return len(self) == 0

    def get_node(self, node_id: int) -> "Node":
        return Node(node_id, self)

    def iter_nodes(self):
        for i in range(len(self)):
            yield Node(i, self)

    # -- link resolution -------------------------------------------------
    def _edge_table(self):
        """(target, in_side, flip, exists) per (node, dir, base).

        The link results (where does term_kmer.extend(b) land) depend only
        on the node end-kmer indexes and are computed ONCE; the exists
        mask additionally requires the extension bit and is re-derived
        cheaply whenever ``exts`` changes (fix_exts no longer pays a full
        device round per call)."""
        if self._edges is None:
            if len(self) == 0:
                z = np.zeros((0, 2, 4), np.int32)
                self._links = (z, z, z.astype(bool), z.astype(bool))
            else:
                if self._links is None:
                    t, s, f, found = _link_and_edges(
                        self.spec, self.stranded,
                        jnp.asarray(self._lk_sorted), jnp.asarray(self._lk_ids),
                        jnp.asarray(self._rk_sorted), jnp.asarray(self._rk_ids),
                        jnp.asarray(self.first_kmers), jnp.asarray(self.last_kmers),
                    )
                    self._links = (
                        np.asarray(t), np.asarray(s),
                        np.asarray(f).astype(bool), np.asarray(found).astype(bool),
                    )
            t, s, f, found = self._links
            has = np.zeros_like(found)
            for d in (LEFT, RIGHT):
                for b in range(4):
                    has[:, d, b] = (self.exts >> (b + 4 * d)) & 1
            self._edges = (t, s, f, found & has)
        return self._edges

    @staticmethod
    def _byte_keys(arr: np.ndarray) -> np.ndarray:
        """(n, w) uint32 limbs -> (n,) fixed-width big-endian byte keys.

        Byte-lexicographic order == limb-lexicographic order, so a plain
        ``np.searchsorted`` replaces the per-element Python bisect
        (million-node graphs)."""
        w = arr.shape[1]
        return np.ascontiguousarray(arr.astype(">u4")).view(f"S{4 * w}").ravel()

    def search_kmer(self, kmer_limbs: np.ndarray, side: int) -> Optional[int]:
        """graph.rs:244-249: exact lookup of a node end kmer."""
        arr, ids = (
            (self._lk_sorted, self._lk_ids)
            if side == LEFT
            else (self._rk_sorted, self._rk_ids)
        )
        if len(arr) == 0:
            return None
        if side == LEFT:
            if self._lk_bytes is None:
                self._lk_bytes = self._byte_keys(arr)
            keys = self._lk_bytes
        else:
            if self._rk_bytes is None:
                self._rk_bytes = self._byte_keys(arr)
            keys = self._rk_bytes
        # numpy S-dtype strips trailing NULs but compares with NUL padding,
        # so order and equality match big-endian limb order as long as both
        # sides go through the same dtype conversion
        q = np.asarray(
            np.asarray(kmer_limbs, np.uint32).astype(">u4").tobytes(),
            dtype=keys.dtype,
        )
        lo = int(np.searchsorted(keys, q))
        if lo < len(arr) and keys[lo] == q:
            return int(ids[lo])
        return None

    def find_link(self, kmer_limbs: np.ndarray, d: int):
        """graph.rs:252-291 (host, single kmer)."""
        rck = np.asarray(
            KM.rc(self.spec, jnp.asarray(kmer_limbs)[None])
        )[0] if not self.stranded else None
        if d == LEFT:
            idx = self.search_kmer(kmer_limbs, RIGHT)
            if idx is not None:
                return idx, RIGHT, False
            if not self.stranded:
                idx = self.search_kmer(rck, LEFT)
                if idx is not None:
                    return idx, LEFT, True
        else:
            idx = self.search_kmer(kmer_limbs, LEFT)
            if idx is not None:
                return idx, LEFT, False
            if not self.stranded:
                idx = self.search_kmer(rck, RIGHT)
                if idx is not None:
                    return idx, RIGHT, True
        return None

    def find_edges(self, node_id: int, d: int) -> List[Tuple[int, int, bool]]:
        """graph.rs:223-241: edges leaving node in direction d.
        Extensions that leave the shard are silently skipped."""
        t, s, f, ex = self._edge_table()
        out = []
        for b in range(4):
            if ex[node_id, d, b]:
                out.append((int(t[node_id, d, b]), int(s[node_id, d, b]), bool(f[node_id, d, b])))
        return out

    # -- exts maintenance ------------------------------------------------
    def get_valid_exts(self, node_id: int, valid: Optional[np.ndarray]) -> int:
        """graph.rs:344-377."""
        t, s, f, ex = self._edge_table()
        new = 0
        for d in (LEFT, RIGHT):
            for b in range(4):
                if ex[node_id, d, b]:
                    tgt = int(t[node_id, d, b])
                    if valid is None or valid[tgt]:
                        new = E.set_ext(new, d, b)
        return new

    def fix_exts(self, valid: Optional[np.ndarray] = None) -> None:
        """graph.rs:337-342: drop extensions with no (valid) target."""
        t, s, f, ex = self._edge_table()
        keep = ex.copy()
        if valid is not None:
            keep &= np.asarray(valid, bool)[t]
        new = np.zeros(len(self), np.int32)
        for d in (LEFT, RIGHT):
            for b in range(4):
                new |= keep[:, d, b].astype(np.int32) << (b + 4 * d)
        self.exts = new
        self.base.exts = new
        self._edges = None  # edge existence depends on exts

    # -- checks ----------------------------------------------------------
    def is_compressed(self, join_test: Callable[[int, int], bool] = None):
        """graph.rs:296-334: find a collapsible node pair, or None.

        Fully vectorized over the cached edge table (one numpy pass plus
        one batched palindrome check) — million-node graphs check in well
        under a second; ``join_test`` runs only on surviving candidate
        pairs, in the reference's (node, dir) scan order.
        """
        n = len(self)
        if n == 0:
            return None
        k = self.spec.k
        t, s, f, ex = self._edge_table()
        deg = ex.sum(axis=2)  # (n, 2) edge count per (node, dir)
        # the unique edge per (node, dir) where deg == 1
        b = np.argmax(ex, axis=2)  # (n, 2)
        tgt = np.take_along_axis(t, b[:, :, None], axis=2)[:, :, 0]
        rdir = np.take_along_axis(s, b[:, :, None], axis=2)[:, :, 0]
        tgt_c = np.clip(tgt, 0, n - 1)
        # next node's edge count on its return side
        next_deg = deg[tgt_c, rdir]
        # K-length palindromic nodes never merge (graph.rs:311-318)
        node_len = np.asarray(self.base.sequences.length, np.int64)
        pal = np.zeros(n, bool)
        if k % 2 == 0 and (node_len == k).any():
            pal_all = np.asarray(
                KM.is_palindrome(self.spec, jnp.asarray(self.first_kmers))
            )
            pal = (node_len == k) & pal_all
        cand = (
            (deg == 1)
            & (next_deg == 1)
            & ~pal[:, None]
            & ~pal[tgt_c]
            & (tgt != np.arange(n)[:, None])
        )
        if not cand.any():
            return None
        if join_test is None:
            # first candidate in (node, dir) scan order
            flat = np.nonzero(cand.reshape(-1))[0]
            i0 = int(flat[0])
            return (i0 // 2, int(tgt.reshape(-1)[i0]))
        for i0 in np.nonzero(cand.any(axis=1))[0]:
            for d in (LEFT, RIGHT):
                if cand[i0, d] and join_test(
                    int(self.data[i0]), int(self.data[tgt[i0, d]])
                ):
                    return (int(i0), int(tgt[i0, d]))
        return None

    # -- paths -----------------------------------------------------------
    def sequence_of_path(self, path: Sequence[Tuple[int, int]]) -> DnaSeq:
        """graph.rs:471-491: stitch a node path, dropping K-1 overlaps."""
        k = self.spec.k
        out = []
        for idx, (node_id, d) in enumerate(path):
            seq = self.base.sequences.get_bases(node_id)
            if d == RIGHT:
                seq = (3 - seq[::-1]).astype(np.uint8)
            out.append(seq if idx == 0 else seq[k - 1 :])
        return DnaSeq.from_bases(
            np.concatenate(out) if out else np.zeros(0, np.uint8)
        )

    def max_path(self, score: Callable, solid_path: Callable):
        """Greedy bidirectional best-score walk (graph.rs:382-468)."""
        if len(self) == 0:
            return []
        scores = [score(int(d)) for d in self.data]
        best_node = int(np.argmax(scores))
        osc = lambda st: 0.0 if st is None else scores[st[0]]
        osolid = lambda st: False if st is None else solid_path(int(self.data[st[0]]))

        used = {best_node}
        from collections import deque

        path = deque([(best_node, LEFT)])
        for start_node, d, do_flip in [
            (best_node, LEFT, False),
            (best_node, RIGHT, True),
        ]:
            current = (start_node, d)
            while True:
                nxt = None
                cur_id, incoming = current
                edges = self.get_node(cur_id).edges(1 - incoming)
                solid = 0
                for (tid, tdir, _) in edges:
                    cand = (tid, tdir)
                    if osolid(cand):
                        solid += 1
                    if osc(cand) > osc(nxt):
                        nxt = cand
                if solid > 1:
                    break
                if nxt is not None and nxt[0] not in used:
                    if do_flip:
                        path.appendleft((nxt[0], 1 - nxt[1]))
                    else:
                        path.append(nxt)
                    used.add(nxt[0])
                    current = nxt
                else:
                    break
        return list(path)

    def max_path_beam(self, beam: int, score: Callable, solid_path: Callable):
        """Beam search from terminal nodes (graph.rs:712-841)."""
        if len(self) == 0:
            return []
        ACTIVE, END, CYCLE = 0, 1, 2
        states = []
        for i in range(len(self)):
            e = Exts(int(self.exts[i]))
            nl, nr = e.num_exts_l(), e.num_exts_r()
            if nl == 0 or nr == 0:
                d = RIGHT if nl > 0 else LEFT
                status = END if (nl == 0 and nr == 0) else ACTIVE
                states.append(([(i, d)], float(score(int(self.data[i]))), status))
        if not states:
            # no terminal nodes (fully cyclic graph): the reference seeds
            # the beam with (node 0, Left) too — "No end nodes -- just
            # start on the first node" (graph.rs:752-762); exercised by
            # test_max_path_beam_cyclic_terminates
            states.append(([(0, LEFT)], float(score(int(self.data[0]))), ACTIVE))

        active = True
        while active:
            new_states = []
            active = False
            for path, sc, status in states:
                if status != ACTIVE:
                    new_states.append((path, sc, status))
                    continue
                active = True
                node_id, d = path[-1]
                for (tid, tin, _) in self.get_node(node_id).edges(1 - d):
                    nsc = sc + float(score(int(self.data[tid])))
                    cycle = any(p == tid for p, _ in path)
                    if cycle:
                        st = CYCLE
                    elif not self.get_node(tid).edges(1 - tin):
                        st = END
                    else:
                        st = ACTIVE
                    new_states.append((path + [(tid, tin)], nsc, st))
            new_states.sort(key=lambda s: -s[1])
            states = new_states[:beam]
        return states[0][0]

    # -- exports (graph.rs:493-710) --------------------------------------
    def write_gfa(self, w) -> None:
        w.write("H\tVN:Z:tpu-debruijn\n")
        for i in range(len(self)):
            self._node_to_gfa(i, w, None)

    def to_gfa(self, path) -> None:
        """GFA export.  Byte-identical to write_gfa but built from ONE
        vectorized base->ASCII pass over the packed store plus bytes IO —
        million-node graphs export in seconds, not minutes."""
        n = len(self)
        flat_ascii = B.bases_to_ascii(self.base.sequences._flat())
        starts = np.asarray(self.base.sequences.start, np.int64)
        lens = np.asarray(self.base.sequences.length, np.int64)
        t, s, f, ex = self._edge_table()
        k1 = str(self.spec.k - 1).encode()
        import io as _io

        buf = _io.BytesIO()
        buf.write(b"H\tVN:Z:tpu-debruijn\n")
        mv = memoryview(flat_ascii)
        for i in range(n):
            buf.write(b"S\t%d\t" % i)
            buf.write(mv[starts[i] : starts[i] + lens[i]])
            buf.write(b"\n")
            for b in range(4):
                if ex[i, LEFT, b]:
                    tgt = int(t[i, LEFT, b])
                    if tgt >= i:
                        d = b"+" if s[i, LEFT, b] == LEFT else b"-"
                        buf.write(b"L\t%d\t-\t%d\t%s\t%sM\n" % (i, tgt, d, k1))
            for b in range(4):
                if ex[i, RIGHT, b]:
                    tgt = int(t[i, RIGHT, b])
                    if tgt > i:
                        d = b"+" if s[i, RIGHT, b] == LEFT else b"-"
                        buf.write(b"L\t%d\t+\t%d\t%s\t%sM\n" % (i, tgt, d, k1))
        with open(path, "wb") as fh:
            fh.write(buf.getvalue())

    def to_gfa_with_tags(self, path, tag_func) -> None:
        with open(path, "w") as f:
            f.write("H\tVN:Z:tpu-debruijn\n")
            for i in range(len(self)):
                self._node_to_gfa(i, f, tag_func)

    def _node_to_gfa(self, i: int, w, tag_func) -> None:
        node = self.get_node(i)
        seq = node.sequence().to_dna_string()
        if tag_func is not None:
            w.write(f"S\t{i}\t{seq}\t{tag_func(node)}\n")
        else:
            w.write(f"S\t{i}\t{seq}\n")
        k1 = self.spec.k - 1
        for (target, d, _) in node.l_edges():
            if target >= i:
                to_dir = "+" if d == LEFT else "-"
                w.write(f"L\t{i}\t-\t{target}\t{to_dir}\t{k1}M\n")
        for (target, d, _) in node.r_edges():
            if target > i:
                to_dir = "+" if d == LEFT else "-"
                w.write(f"L\t{i}\t+\t{target}\t{to_dir}\t{k1}M\n")

    def to_dot(self, path, node_label: Callable[[int], str]) -> None:
        with open(path, "w") as f:
            f.write("digraph {\n")
            for i in range(len(self)):
                node = self.get_node(i)
                f.write(
                    f'n{i} [label="id:{i} len:{node.len()}  '
                    f'{node_label(int(self.data[i]))}",style=filled]\n'
                )
                for (tid, d, _) in node.l_edges():
                    color = "blue" if d == LEFT else "red"
                    f.write(f"n{tid} -> n{i} [color={color}]\n")
                for (tid, d, _) in node.r_edges():
                    color = "blue" if d == LEFT else "red"
                    f.write(f"n{i} -> n{tid} [color={color}]\n")
            f.write("}\n")

    def to_json_rest(self, fmt_func, writer, rest: Optional[dict] = None) -> None:
        import json as _json

        writer.write('{\n"nodes": [\n')
        for i in range(len(self)):
            node = self.get_node(i)
            writer.write(
                '{"id":"%d","L":%d,"D":%s,"Se":"%s"}'
                % (i, node.len(), _json.dumps(fmt_func(int(self.data[i]))),
                   node.sequence().to_dna_string())
            )
            writer.write("\n" if i == len(self) - 1 else ",\n")
        writer.write('],\n"links": [\n')
        lines = []
        for i in range(len(self)):
            for (tid, d, _) in self.get_node(i).r_edges():
                lines.append(
                    '{"source":"%d","target":"%d","D":"%s"}'
                    % (i, tid, "L" if d == LEFT else "R")
                )
        writer.write(",\n".join(lines))
        writer.write("\n]")
        if rest:
            for key, val in rest.items():
                writer.write(',\n"%s": %s\n' % (key, _json.dumps(val)))
        else:
            writer.write("\n")
        writer.write("}\n")

    def to_json(self, fmt_func, writer) -> None:
        self.to_json_rest(fmt_func, writer, None)

    def print(self) -> None:
        print(f"DebruijnGraph {{ len: {len(self)}, K: {self.spec.k} }} :")
        for node in self.iter_nodes():
            print(node)

    def print_with_data(self) -> None:
        print(f"DebruijnGraph {{ len: {len(self)}, K: {self.spec.k} }} :")
        for node in self.iter_nodes():
            print(node, f"({int(self.data[node.node_id])})")

    # -- checkpoint (serde equivalent, SURVEY.md section 5) ---------------
    def save(self, path) -> None:
        """Checkpoint the graph (BaseGraph/DebruijnGraph Serialize,
        graph.rs:43,175).  A ``rich`` sidecar of int sequences (label
        sets / color vectors — the serializable D the reference's colored
        graphs carry) is stored as flat + split arrays; other object
        payloads are not serializable and raise."""
        extra = {}
        if self.rich is not None:
            # fast path: sequences of ints go in as flat + split arrays;
            # any other payload (tuples of strings, dicts, custom classes —
            # the reference serializes any serde-serializable D,
            # graph.rs:43,175) falls back to a pickled byte sidecar stored
            # as a uint8 array (no allow_pickle needed on load)
            def _int_seq(r):
                try:
                    return all(isinstance(x, (int, np.integer)) for x in r)
                except TypeError:
                    return False

            if all(r is None or _int_seq(r) for r in self.rich):
                flats, split = [], np.zeros(len(self) + 1, np.int64)
                for i, r in enumerate(self.rich):
                    if r is None:
                        r = ()
                    flats.append(np.asarray(list(r), np.int64))
                    split[i + 1] = split[i] + len(flats[-1])
                extra["rich_flat"] = (
                    np.concatenate(flats) if flats else np.zeros(0, np.int64)
                )
                extra["rich_split"] = split
            else:
                import pickle

                extra["rich_pickle"] = np.frombuffer(
                    pickle.dumps(list(self.rich), protocol=4), dtype=np.uint8
                )
        np.savez_compressed(
            path,
            k=self.spec.k,
            stranded=self.stranded,
            lengths=np.asarray(self.base.sequences.length, np.int64),
            # 2-bit packed words, 4x denser than uint8 codes — matches
            # the reference's packed serialization (dna_string.rs:72)
            bases_packed=self.base.sequences.packed_words(),
            exts=np.asarray(self.exts, np.int32),
            data=np.asarray(self.data, np.int32),
            **extra,
        )

    @staticmethod
    def load(path) -> "DebruijnGraph":
        from tpu_debruijn.dna import PackedSeqSet

        z = np.load(path)
        g = BaseGraph(int(z["k"]), bool(z["stranded"]))
        rich = None
        if "rich_pickle" in z:
            import pickle

            rich = pickle.loads(z["rich_pickle"].tobytes())
        elif "rich_flat" in z:
            flat, split = z["rich_flat"], z["rich_split"]
            rich = [
                tuple(int(x) for x in flat[split[i] : split[i + 1]])
                for i in range(len(split) - 1)
            ]
        if "bases_packed" in z:
            g.sequences = PackedSeqSet.from_packed(z["bases_packed"], z["lengths"])
            g._exts_chunks.append(np.asarray(z["exts"], np.int32))
            g._data_chunks.append(np.asarray(z["data"], np.int32))
            if rich is not None:
                g._rich = rich
        else:  # legacy unpacked checkpoints
            g.add_flat(z["bases"], z["lengths"], z["exts"], z["data"], rich=rich)
        return g.finish()


class Node:
    """View of one unitig (graph.rs:1009-1093)."""

    def __init__(self, node_id: int, graph: DebruijnGraph):
        self.node_id = node_id
        self.graph = graph

    def len(self) -> int:
        return int(self.graph.base.sequences.length[self.node_id])

    def sequence(self) -> DnaSeq:
        return self.graph.base.sequences.get(self.node_id)

    def data(self) -> int:
        return int(self.graph.data[self.node_id])

    def exts(self) -> Exts:
        return Exts(int(self.graph.exts[self.node_id]))

    def l_edges(self):
        return self.graph.find_edges(self.node_id, LEFT)

    def r_edges(self):
        return self.graph.find_edges(self.node_id, RIGHT)

    def edges(self, d: int):
        return self.graph.find_edges(self.node_id, d)

    def iter_kmers(self):
        return self.sequence().iter_kmers(self.graph.spec.k)

    def __repr__(self):
        return (
            f"Node {{ id:{self.node_id}, Exts: {self.exts()}, "
            f"L:{self.l_edges()} R:{self.r_edges()}, Seq: {self.len()} }}"
        )


# ---------------------------------------------------------------------------
# node-level re-compression (compression.rs:100-349)
# ---------------------------------------------------------------------------


def _node_partner_body(spec, stranded, use_join, lk_sorted, lk_ids, rk_sorted,
                       rk_ids, first_k, last_k, exts, node_len, valid, labels,
                       n_valid=None):
    """try_extend_node (compression.rs:115-205) as vector masks.

    Accepts padded node tables: ``valid`` masks live slots, ``n_valid``
    bounds the sorted indexes (the collective shard stitch passes
    allgathered padded tables; the host path passes exact arrays).
    """
    n = first_k.shape[0]
    idx_self = jnp.arange(n, dtype=jnp.int32)
    k = spec.k
    if not stranded:
        pal_self = (node_len == k) & KM.is_palindrome(spec, first_k)
    else:
        pal_self = jnp.zeros(n, bool)

    partners, ins = {}, {}
    for d in (LEFT, RIGHT):
        uniq, base = E.unique_extension(exts, d)
        term = first_k if d == LEFT else last_k
        cand = (
            KM.extend_left(spec, term, base.astype(jnp.uint32))
            if d == LEFT
            else KM.extend_right(spec, term, base.astype(jnp.uint32))
        )
        if not stranded:
            pal_next = KM.is_palindrome(spec, cand)
        else:
            pal_next = jnp.zeros(n, bool)
        j, side, flip, found = _find_link_device(
            spec, stranded, d, cand, lk_sorted, lk_ids, rk_sorted, rk_ids,
            n_valid,
        )
        jc = jnp.clip(j, 0, n - 1)
        incoming_cnt = E.num_ext_dir(exts[jc], side)
        ok = (
            valid
            & uniq
            & found
            & valid[jc]
            & (j != idx_self)
            & ~pal_self
            & ~pal_next
            & (incoming_cnt == 1)
        )
        if use_join:
            ok = ok & (labels[idx_self] == labels[jc])
        partners[d] = jnp.where(ok, j, -1)
        ins[d] = side.astype(jnp.int32)

    out = {}
    for d in (LEFT, RIGHT):
        j = partners[d]
        jc = jnp.clip(j, 0, n - 1)
        rev = jnp.where(ins[d] == LEFT, partners[LEFT][jc], partners[RIGHT][jc])
        ok = (j >= 0) & (rev == idx_self)
        out[d] = jnp.where(ok, j, -1)
    chains = C.link_chains(out[LEFT], out[RIGHT], ins[LEFT], ins[RIGHT], valid)
    u_exts = C.unitig_end_exts(exts, chains)
    return chains, u_exts


@partial(jax.jit, static_argnums=(0, 1, 2))
def _node_partner_jit(spec, stranded, use_join, lk_sorted, lk_ids, rk_sorted,
                      rk_ids, first_k, last_k, exts, node_len, valid, labels):
    return _node_partner_body(
        spec, stranded, use_join, lk_sorted, lk_ids, rk_sorted, rk_ids,
        first_k, last_k, exts, node_len, valid, labels,
    )


def compress_graph(
    graph: DebruijnGraph,
    censor_nodes: Optional[Sequence[int]] = None,
    *,
    data_reduce: str = "sum_sat_u16",
    join_on_data: bool = False,
    spec: "Optional[C.CompressionSpec]" = None,
    rich_reduce: Optional[Callable] = None,
) -> DebruijnGraph:
    """Merge adjacent unbranched nodes, optionally censoring some first.

    compress_graph equivalent (compression.rs:291-349): fix_exts against
    the valid set, chain-link the nodes, stitch sequences (dropping K-1
    overlaps), rebuild, and fix_exts again.  Policy comes from ``spec``
    (a :class:`tpu_debruijn.compress.CompressionSpec`) or the shorthand
    ``data_reduce``/``join_on_data`` knobs.

    When the graph carries a ``rich`` payload sidecar, ``rich_reduce``
    (an arbitrary non-mutating fold closure, associative + commutative)
    folds it per output node; the default merges int-sequence payloads as
    sorted set unions (the colored-graph pattern) and keeps the first
    payload otherwise.
    """
    n = len(graph)
    valid = np.ones(n, bool)
    if censor_nodes is not None:
        valid[np.asarray(list(censor_nodes), int)] = False
    graph.fix_exts(valid)

    k = graph.spec.k
    if n == 0:
        return BaseGraph(k, graph.stranded).finish()
    label_np = graph.data
    if spec is not None:
        data_reduce = spec.reduce
        la = spec.label_array(graph.data)
        join_on_data = la is not None
        if la is not None:
            label_np = la
    node_len = np.asarray(graph.base.sequences.length, np.int32)
    chains, u_exts = _node_partner_jit(
        graph.spec, graph.stranded, join_on_data,
        jnp.asarray(graph._lk_sorted), jnp.asarray(graph._lk_ids),
        jnp.asarray(graph._rk_sorted), jnp.asarray(graph._rk_ids),
        jnp.asarray(graph.first_kmers), jnp.asarray(graph.last_kmers),
        jnp.asarray(graph.exts), jnp.asarray(node_len),
        jnp.asarray(valid), jnp.asarray(np.asarray(label_np, np.int32)),
    )
    uid = np.asarray(chains.uid)
    pos = np.asarray(chains.pos)
    flip = np.asarray(chains.flip)
    nutg = int(chains.n_unitigs)
    u_exts = np.asarray(u_exts)[:nutg]

    live = uid >= 0
    if callable(data_reduce):
        data_red = C._fold_closure(
            data_reduce, graph.data[live], uid[live], pos[live], nutg
        )
    else:
        data_red = C._reduce_np(data_reduce, graph.data[live], uid[live], nutg)

    # stitch sequences: one vectorized ragged gather, no per-node loop
    lids = np.nonzero(live)[0]
    seqs = graph.base.sequences
    seq_flat, out_lengths = C.stitch_flat(
        k, seqs._flat(), seqs.start, seqs.length,
        lids, uid[live], pos[live], flip[live], nutg,
    )
    rich_out = None
    if graph.rich is not None:
        if rich_reduce is None:
            def rich_reduce(a, b):
                if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
                    return tuple(sorted(set(a) | set(b)))
                return a
        rich_out = C._fold_objects(
            rich_reduce, graph.rich, lids, uid[live], pos[live], nutg
        )
    out = BaseGraph(k, graph.stranded)
    out.add_flat(seq_flat, out_lengths, u_exts[:nutg], data_red, rich=rich_out)
    dbg = out.finish()
    dbg.fix_exts(None)
    return dbg
