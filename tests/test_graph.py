"""Graph layer tests: indexes, edges, fix_exts, is_compressed,
node-level re-compression, tip cleaning, walks, exports, checkpoint.

Mirrors simplify_from_kmers (test.rs:233-295), reassemble_sharded
(test.rs:418-504), and simple_tip_clean (test.rs:506-572).
"""

import io
import json

import numpy as np
import pytest

from tpu_debruijn import clean as CL
from tpu_debruijn import compress as C
from tpu_debruijn import filter as F
from tpu_debruijn import graph as G
from tpu_debruijn import kmer as KM
from tpu_debruijn import msp as M
from tpu_debruijn.oracle import ref as O


def _table_and_graph(contigs, k, stranded, minobs=1):
    seqs = [(np.array(c, dtype=np.uint8), 0, 0) for c in contigs if len(c) >= k]
    tab = F.filter_kmers(seqs + seqs, k, stranded=stranded, min_obs=minobs)
    nodes = C.compress_kmers(tab)
    return tab, G.from_compress_output(k, stranded, nodes).finish()


def _canon_nodes(g):
    """Graph as an orientation-canonical multiset of (seq, exts, data)."""
    out = []
    for i in range(len(g)):
        seq = g.base.sequences.get_bases(i)
        e = int(g.exts[i])
        rseq = tuple(int(x) for x in (3 - seq[::-1]))
        fseq = tuple(int(x) for x in seq)
        re = O.e_rc(e)
        d = int(g.data[i])
        out.append(min((fseq, e, d), (rseq, re, d)))
    return sorted(out)


def test_compressed_graph_is_compressed(rng):
    contigs = O.random_contigs(rng)
    for k, stranded in [(16, False), (16, True)]:
        tab, g = _table_and_graph(contigs, k, stranded)
        assert g.is_compressed() is None


def test_uncompressed_graph_recompresses_to_same(rng):
    # simplify_from_kmers (test.rs:233-295): build a 1-node-per-kmer graph,
    # compress_graph it, and compare with direct kmer-level compression
    contigs = O.simple_random_contigs(rng)
    for k, stranded in [(16, False), (31, False), (16, True)]:
        seqs = [(np.array(c, dtype=np.uint8), 0, 0) for c in contigs]
        tab = F.filter_kmers(seqs, k, stranded=stranded, min_obs=1)
        direct = C.compress_kmers(tab, data_reduce="sum_sat_u16")
        g1 = G.BaseGraph(k, stranded)
        for i in range(len(tab)):
            g1.add(KM.to_bases(tab.spec, tab.kmers[i]), int(tab.exts[i]),
                   int(tab.counts[i]))
        dbg = g1.finish()
        if len(tab) > 1:
            assert dbg.is_compressed() is not None  # collapsible pairs exist
        simp = G.compress_graph(dbg, None, data_reduce="sum_sat_u16")
        assert simp.is_compressed() is None
        want = G.from_compress_output(k, stranded, direct).finish()
        assert _canon_nodes(simp) == _canon_nodes(want)


def test_find_link_and_edges(rng):
    contigs = O.random_contigs(rng)
    k = 16
    tab, g = _table_and_graph(contigs, k, False)
    kmer_ids = {}
    for i in range(len(g)):
        kmer_ids[KM.to_int(g.spec, g.first_kmers[i])] = i
    # find_link on each node's own first kmer entering from the left
    for i in range(min(len(g), 20)):
        fk = g.first_kmers[i]
        res = g.find_link(fk, G.RIGHT)  # kmer appearing at left side of a node
        assert res is not None
        tid, side, flip = res
        if not flip:
            assert side == G.LEFT and tid == i
    # every listed edge is reciprocal: target lists us back (palindromic
    # single-kmer nodes may list the back edge on either side — the
    # reference's find_link has the same side collapse, graph.rs:252-257)
    for i in range(min(len(g), 30)):
        for d in (G.LEFT, G.RIGHT):
            for (tid, tin, flip) in g.get_node(i).edges(d):
                back = g.get_node(tid).edges(tin) + g.get_node(tid).edges(1 - tin)
                assert any(b[0] == i for b in back)


def test_fix_exts_drops_dangling(rng):
    contigs = O.random_contigs(rng)
    k = 16
    seqs = [(np.array(c, dtype=np.uint8), 0, 0) for c in contigs if len(c) >= k]
    # min_obs 2 with uneven coverage leaves dangling exts onto censored kmers
    tab = F.filter_kmers(seqs + seqs + [seqs[0]], k, stranded=False, min_obs=2)
    nodes = C.compress_kmers(tab)
    g = G.from_compress_output(k, False, nodes).finish()
    g.fix_exts(None)
    # after fix_exts every ext must resolve to an edge
    t, s, f, ex = g._edge_table()
    for i in range(len(g)):
        e = int(g.exts[i])
        for d in (0, 1):
            for b in range(4):
                if O.e_dir_bits(e, d) & (1 << b):
                    assert ex[i, d, b]


def test_sequence_of_path_and_max_path(rng):
    # linear genome -> one unitig; max_path returns it
    genome = rng.integers(0, 4, 300)
    k = 21
    tab = F.filter_kmers([(genome, 0, 0)], k, stranded=True, min_obs=1)
    nodes = C.compress_kmers(tab)
    g = G.from_compress_output(k, True, nodes).finish()
    assert len(g) == 1
    path = g.max_path(lambda d: float(d), lambda d: True)
    assert [p for p, _ in path] == [0]
    seq = g.sequence_of_path(path)
    assert np.array_equal(seq.bases(), genome) or np.array_equal(
        seq.rc().bases(), genome
    )
    beam = g.max_path_beam(4, lambda d: float(d), lambda d: True)
    assert [p for p, _ in beam] == [0]


def test_tip_cleaning(rng):
    # test.rs:506-572: 5x clean coverage + junk-truncated reads -> tips
    k = 16
    contigs = [rng.integers(0, 4, 200), rng.integers(0, 4, 200)]
    clean_seqs, all_seqs = [], []
    for c in contigs:
        for _ in range(5):
            clean_seqs.append((c, 0, 0))
            all_seqs.append((c, 0, 0))
        junk = rng.integers(0, 4, 5)
        err = np.concatenate([c[: len(c) // 2], junk])
        all_seqs.append((err, 0, 0))
        all_seqs.append((err, 0, 0))
    tab_clean = F.filter_kmers(clean_seqs, k, stranded=False, min_obs=2)
    g_clean = G.from_compress_output(
        k, False, C.compress_kmers(tab_clean)
    ).finish()
    tab_all = F.filter_kmers(all_seqs, k, stranded=False, min_obs=2)
    g_all = G.from_compress_output(k, False, C.compress_kmers(tab_all)).finish()
    fixed = CL.clean_tips(g_all, lambda node: node.len() < k * 2)
    assert fixed.is_compressed() is None
    # cleaned graph's kmer set is contained in the dirty one and contains
    # the clean one up to junction splitting
    def kmers_of(g):
        out = set()
        for i in range(len(g)):
            s = g.base.sequences.get_bases(i)
            v = O.OKmer.from_bases(s[:k])
            out.add(O.OKmer.min_rc(k, v))
            for b in s[k:]:
                v = O.OKmer.extend_right(k, v, int(b))
                out.add(O.OKmer.min_rc(k, v))
        return out
    assert kmers_of(fixed) <= kmers_of(g_all)


def test_sharded_reassembly_matches_unsharded(rng):
    # reassemble_sharded (test.rs:418-504) via MSP buckets
    k, p = 16, 6
    contigs = O.simple_random_contigs(rng)
    # truth: unsharded
    seqs = [(np.array(c, np.uint8), 0, 0) for c in contigs]
    tab = F.filter_kmers(seqs + seqs, k, stranded=False, min_obs=2)
    truth = G.from_compress_output(
        k, False, C.compress_kmers(tab, data_reduce="max")
    ).finish()
    truth_set = _canon_kmer_set(truth, k)

    # sharded: msp partition -> per-bucket filter+compress -> combine -> stitch
    shards = {}
    for c in contigs:
        for bucket, exts, sub in M.msp_sequence(np.array(c, np.uint8), k, p, None, True):
            shards.setdefault(bucket, []).append((sub, exts, 0))
            shards.setdefault(bucket, []).append((sub, exts, 0))
    shard_graphs = []
    for bucket, ss in sorted(shards.items()):
        st = F.filter_kmers(ss, k, stranded=False, min_obs=2)
        if len(st) == 0:
            continue
        nodes = C.compress_kmers(st, data_reduce="max")
        shard_graphs.append(G.from_compress_output(k, False, nodes))
    combined = G.BaseGraph.combine(shard_graphs).finish()
    stitched = G.compress_graph(combined, None, data_reduce="max")
    assert stitched.is_compressed() is None
    assert _canon_kmer_set(stitched, k) == truth_set
    assert _canon_nodes(stitched) == _canon_nodes(truth)


def _canon_kmer_set(g, k):
    out = set()
    for i in range(len(g)):
        s = g.base.sequences.get_bases(i)
        v = O.OKmer.from_bases(s[:k])
        out.add(O.OKmer.min_rc(k, v))
        for b in s[k:]:
            v = O.OKmer.extend_right(k, v, int(b))
            out.add(O.OKmer.min_rc(k, v))
    return out


def test_gfa_dot_json_export(tmp_path, rng):
    contigs = O.simple_random_contigs(rng)
    _, g = _table_and_graph(contigs, 16, False)
    gfa = tmp_path / "g.gfa"
    g.to_gfa(gfa)
    lines = gfa.read_text().splitlines()
    assert lines[0].startswith("H\t")
    s_lines = [l for l in lines if l.startswith("S\t")]
    l_lines = [l for l in lines if l.startswith("L\t")]
    assert len(s_lines) == len(g)
    for l in s_lines:
        parts = l.split("\t")
        assert set(parts[2]) <= set("ACGT")
    for l in l_lines:
        parts = l.split("\t")
        assert parts[5] == "15M"  # K-1 overlap
    dot = tmp_path / "g.dot"
    g.to_dot(dot, lambda d: str(d))
    assert dot.read_text().startswith("digraph {")
    buf = io.StringIO()
    g.to_json(lambda d: d, buf)
    j = json.loads(buf.getvalue())
    assert len(j["nodes"]) == len(g)
    # tags export
    tagged = tmp_path / "t.gfa"
    g.to_gfa_with_tags(tagged, lambda node: f"RC:i:{node.data()}")
    assert "RC:i:" in tagged.read_text()


def test_checkpoint_roundtrip(tmp_path, rng):
    contigs = O.simple_random_contigs(rng)
    _, g = _table_and_graph(contigs, 16, False)
    p = tmp_path / "graph.npz"
    g.save(p)
    g2 = G.DebruijnGraph.load(p)
    assert _canon_nodes(g2) == _canon_nodes(g)
    assert g2.spec.k == g.spec.k and g2.stranded == g.stranded


def test_combine_rejects_mixed_strandedness():
    a = G.BaseGraph(16, True)
    b = G.BaseGraph(16, False)
    with pytest.raises(ValueError):
        G.BaseGraph.combine([a, b])


def test_max_path_beam_multi_node(rng):
    # beam search walks a multi-node chain end to end (graph.rs:712-841).
    # Label breaks (ScmapCompress join) split one linear genome into
    # several nodes; the beam must stitch them back.
    k = 15
    genome = rng.integers(0, 4, 200)
    reads = [
        (genome[:80], 0, 1),
        (genome[60:140], 0, 2),
        (genome[120:], 0, 3),
    ]
    tab = F.filter_kmers(reads, k, stranded=True, min_obs=1, data_reduce="min")
    nodes = C.compress_kmers(
        tab, data_reduce="first", join_on_data=True, data_field="data"
    )
    g = G.from_compress_output(k, True, nodes).finish()
    assert len(g) >= 3
    path = g.max_path_beam(8, lambda d: 1.0, lambda d: True)
    assert len(path) == len(g)  # linear graph: best path covers all nodes
    seq = g.sequence_of_path(path).bases()
    assert np.array_equal(seq, genome) or np.array_equal(
        (3 - seq[::-1]).astype(seq.dtype), genome
    )


def test_stitch_flat_matches_naive(rng):
    """stitch_flat == per-node Python stitch on a random chain layout."""
    k = 7
    n = 40
    lens = rng.integers(k, k + 12, n).astype(np.int64)
    starts = np.zeros(n, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    flat = rng.integers(0, 4, int(lens.sum())).astype(np.uint8)
    # random chain structure: unitigs of 1-4 nodes
    uid, pos = [], []
    u = 0
    i = 0
    while i < n:
        m = int(rng.integers(1, 5))
        m = min(m, n - i)
        uid += [u] * m
        pos += list(range(m))
        u += 1
        i += m
    uid = np.array(uid, np.int32)
    pos = np.array(pos, np.int32)
    flip = rng.random(n) < 0.5
    node_ids = rng.permutation(n)  # arbitrary order
    got_flat, got_lens = C.stitch_flat(
        k, flat, starts, lens, node_ids, uid[node_ids], pos[node_ids],
        flip[node_ids], u,
    )
    # naive
    want = []
    for uu in range(u):
        cur = []
        for i in np.nonzero(uid == uu)[0][np.argsort(pos[uid == uu])]:
            seq = flat[starts[i] : starts[i] + lens[i]]
            if flip[i]:
                seq = (3 - seq[::-1]).astype(np.uint8)
            cur.append(seq if not cur else seq[k - 1 :])
        want.append(np.concatenate(cur))
    assert np.array_equal(got_lens, np.array([len(w) for w in want]))
    assert np.array_equal(got_flat, np.concatenate(want))


def test_million_node_combine_and_stitch_fast(rng):
    """1M-unitig combine + stitch must be vectorized (seconds,
    not the minutes a per-node Python loop takes)."""
    import time

    k = 16
    n = 1_000_000
    lens = np.full(n, k, np.int64)
    starts = np.arange(n, dtype=np.int64) * k
    flat = rng.integers(0, 4, n * k).astype(np.uint8)
    exts = rng.integers(0, 256, n).astype(np.int32)
    data = np.ones(n, np.int32)

    t0 = time.perf_counter()
    g1 = G.BaseGraph(k, False)
    g1.add_flat(flat[: (n // 2) * k], lens[: n // 2], exts[: n // 2], data[: n // 2])
    g2 = G.BaseGraph(k, False)
    g2.add_flat(flat[(n // 2) * k :], lens[n // 2 :], exts[n // 2 :], data[n // 2 :])
    combined = G.BaseGraph.combine([g1, g2])
    assert len(combined) == n
    assert np.array_equal(combined.exts, exts)
    t_combine = time.perf_counter() - t0

    uid = (np.arange(n) // 2).astype(np.int32)
    pos = (np.arange(n) % 2).astype(np.int32)
    flip = np.zeros(n, bool)
    t0 = time.perf_counter()
    out_flat, out_lens = C.stitch_flat(
        k, combined.sequences._flat(), combined.sequences.start,
        combined.sequences.length, np.arange(n), uid, pos, flip, n // 2,
    )
    t_stitch = time.perf_counter() - t0
    assert len(out_lens) == n // 2 and int(out_lens[0]) == k + 1
    # generous bound: a per-node Python loop takes minutes; the vectorized
    # path takes ~1s alone but can see 5-10x slowdown under full-suite load
    assert t_combine < 30.0, f"combine took {t_combine:.1f}s"
    assert t_stitch < 30.0, f"stitch took {t_stitch:.1f}s"


def test_max_path_beam_branchy_bubble(rng):
    """Beam search on a BRANCHY graph: a bubble — two
    alternative middles between shared flanks — must resolve to the
    higher-coverage branch, and the beam must consider both."""
    k = 15
    flank_a = rng.integers(0, 4, 60)
    flank_b = rng.integers(0, 4, 60)
    mid_hi = rng.integers(0, 4, 40)
    mid_lo = rng.integers(0, 4, 40)
    hi = np.concatenate([flank_a, mid_hi, flank_b]).astype(np.uint8)
    lo = np.concatenate([flank_a, mid_lo, flank_b]).astype(np.uint8)
    # hi path observed 3x, lo path once -> counts differ per branch node
    reads = [(hi, 0, 0)] * 3 + [(lo, 0, 0)]
    tab = F.filter_kmers(reads, k, stranded=True, min_obs=1)
    nodes = C.compress_kmers(tab)
    g = G.from_compress_output(k, True, nodes).finish()
    # bubble shape: flank, two middles, flank (possibly split further)
    assert len(g) >= 4
    branchy = [
        i for i in range(len(g))
        if len(g.get_node(i).l_edges()) > 1 or len(g.get_node(i).r_edges()) > 1
    ]
    assert branchy, "expected at least one branch node"

    path = g.max_path_beam(8, lambda d: float(d), lambda d: True)
    seq = g.sequence_of_path(path).bases()
    want = hi
    assert np.array_equal(seq, want) or np.array_equal(
        (3 - seq[::-1]).astype(seq.dtype), want
    )
    # the losing branch's middle kmers must NOT appear in the chosen path
    mid_lo_str = "".join("ACGT"[b] for b in lo[60:100])
    got_str = "".join("ACGT"[b] for b in seq)
    assert mid_lo_str not in got_str


def test_max_path_beam_cyclic_terminates(rng):
    """Beam search on a CYCLIC graph: a smooth circle has no terminal
    node; the walk must detect the revisit (Cycle state, graph.rs:844-856)
    and terminate with a path that covers the cycle exactly once."""
    k = 15
    core = rng.integers(0, 4, 120).astype(np.uint8)
    # wrap k bases so the boundary kmers carry the closing extensions
    # (k-1 would cover the kmer set but leave the exts chain open)
    circular = np.concatenate([core, core[:k]])
    tab = F.filter_kmers([(circular, 0, 0)], k, stranded=True, min_obs=1)
    nodes = C.compress_kmers(tab)
    g = G.from_compress_output(k, True, nodes).finish()
    assert len(g) == 1
    # the single node loops onto itself
    assert any(t == 0 for t, _, _ in g.get_node(0).r_edges())

    path = g.max_path_beam(4, lambda d: 1.0, lambda d: True)
    # reference semantics (graph.rs:816-833): the cycle-closing revisit IS
    # appended to the path before the state is frozen as Cycle
    assert [p for p, _ in path] == [0, 0]

    # branchy + cyclic: a tail entering the cycle
    tail = rng.integers(0, 4, 50).astype(np.uint8)
    entry = np.concatenate([tail, core[:40]])
    tab2 = F.filter_kmers(
        [(circular, 0, 0), (entry.astype(np.uint8), 0, 0)], k,
        stranded=True, min_obs=1,
    )
    g2 = G.from_compress_output(k, True, C.compress_kmers(tab2)).finish()
    assert len(g2) >= 2
    path2 = g2.max_path_beam(8, lambda d: 1.0, lambda d: True)
    ids = [p for p, _ in path2]
    # terminates, visits >= 2 nodes, and at most one node repeats (the
    # cycle closer)
    assert len(ids) >= 2
    assert len(ids) - len(set(ids)) <= 1


def test_is_compressed_join_test(rng):
    """is_compressed's spec.join_test hook (graph.rs:296-334): a pair that
    is mergeable topologically but fails the join test is NOT reported."""
    k = 16
    seq = rng.integers(0, 4, 40).astype(np.uint8)
    tab = F.filter_kmers([(seq, 0, 0)], k, stranded=True, min_obs=1)
    # per-kmer graph with alternating labels: every adjacent pair differs
    base = G.BaseGraph(k, True)
    for i in range(len(tab)):
        base.add(KM.to_bases(tab.spec, tab.kmers[i]), int(tab.exts[i]), i % 2)
    g = base.finish()
    assert g.is_compressed() is not None
    # a join test that rejects every pair suppresses the report
    assert g.is_compressed(join_test=lambda a, b: False) is None
    # an accepting join test reports the same first pair as the default
    assert g.is_compressed(join_test=lambda a, b: True) == g.is_compressed()


def test_to_gfa_bulk_matches_write_gfa(rng, tmp_path):
    """The vectorized to_gfa fast path must be byte-identical to the
    per-node write_gfa (node_to_gfa dedup rules, graph.rs:601-635)."""
    import io as _io

    k = 16
    contigs = O.random_contigs(rng)
    tab = F.filter_kmers(
        [(np.asarray(c, np.uint8), 0, 0) for c in contigs if len(c) >= k],
        k, stranded=False, min_obs=1,
    )
    g = G.from_compress_output(k, False, C.compress_kmers(tab)).finish()
    sio = _io.StringIO()
    g.write_gfa(sio)
    p = str(tmp_path / "g.gfa")
    g.to_gfa(p)
    assert open(p).read() == sio.getvalue()
