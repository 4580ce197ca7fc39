"""Generic per-kmer data D through compression.

The reference's CompressionSpec<D> is generic over ARBITRARY payload types
with an arbitrary join_test predicate (compression.rs:34-38); e.g.
CountFilterSet's Vec<u8> color sets (filter.rs:68-101) fold along unitigs
with SimpleCompress(|mut a, b| { a.extend(b); a }).  These tests drive the
engine's rich path (compress_kmers_rich / compress_kmers_color_sets /
BaseGraph rich sidecar) against the oracle running the same spec.
"""

import numpy as np
import pytest

from tpu_debruijn import compress as C
from tpu_debruijn import filter as F
from tpu_debruijn import graph as G
from tpu_debruijn.oracle import ref as O


def _labeled_reads(rng, n_labels=3, n_reads=30, read_len=60):
    contigs = O.simple_random_contigs(rng)
    pool = [np.asarray(c, np.uint8) for c in contigs if len(c) >= read_len]
    reads = []
    for i in range(n_reads):
        c = pool[int(rng.integers(0, len(pool)))]
        s = int(rng.integers(0, len(c) - read_len + 1))
        r = c[s : s + read_len].copy()
        if rng.random() < 0.5:
            r = (3 - r[::-1]).astype(np.uint8)
        reads.append((r, 0, int(rng.integers(0, n_labels))))
    return reads


def _norm_nodes(nodes, data_fn):
    out = sorted(
        (tuple(int(x) for x in s), int(e), data_fn(d)) for s, e, d in nodes
    )
    return out


@pytest.mark.parametrize("stranded,min_obs", [(False, 1), (True, 1), (False, 2)])
def test_colors_through_compression_vs_oracle(rng, stranded, min_obs):
    """CountFilterSet colors flow through compress_kmers_rich and match
    the oracle running SimpleCompress(extend) + sort/dedup."""
    k = 16
    reads = _labeled_reads(rng)
    table, sets = F.filter_kmers_set(reads, k, stranded=stranded, min_obs=min_obs)

    otab, _ = O.filter_kmers(
        [(list(r[0]), 0, r[2]) for r in reads], k,
        O.CountFilterSet(min_obs), stranded,
    )
    ospec = O.SimpleCompress(lambda a, b: sorted(set(list(a) + list(b))))
    onodes = O.compress_kmers(stranded, ospec, otab, k)

    gnodes = C.compress_kmers_rich(
        table, sets, reduce=lambda a, b: tuple(sorted(set(a) | set(b)))
    )
    ow = _norm_nodes(onodes, lambda d: tuple(sorted(set(d))))
    gw = _norm_nodes(gnodes, lambda d: tuple(sorted(set(d))))
    assert ow == gw
    assert len(gnodes) >= 1


def test_color_sets_scale_path_matches_rich(rng):
    """compress_kmers_color_sets (array-native, no Python objects) gives
    the same unitigs + per-unitig unions as the rich object path."""
    k = 16
    reads = _labeled_reads(rng, n_labels=4, n_reads=40)
    table, sets = F.filter_kmers_set(reads, k, stranded=False, min_obs=1)
    table2, pair_label, split = F.filter_kmers_set_arrays(
        reads, k, stranded=False, min_obs=1
    )
    assert np.array_equal(table.kmers, table2.kmers)

    gnodes = C.compress_kmers_rich(
        table, sets, reduce=lambda a, b: tuple(sorted(set(a) | set(b)))
    )
    anodes, out_labels, out_split = C.compress_kmers_color_sets(
        table2, pair_label, split
    )
    assert len(anodes) == len(gnodes)
    got = sorted(
        (
            tuple(int(x) for x in s),
            int(e),
            tuple(int(x) for x in out_labels[out_split[u] : out_split[u + 1]]),
        )
        for u, (s, e, _) in enumerate(anodes)
    )
    want = _norm_nodes(gnodes, lambda d: tuple(sorted(d)))
    assert got == want


def test_color_sets_join_on_sets_vs_oracle_scmap(rng):
    """join_on_sets=True == ScmapCompress<Vec<u8>> (merge only equal
    color sets, compression.rs:68-98), checked against the oracle."""
    k = 16
    reads = _labeled_reads(rng, n_labels=2, n_reads=24)
    table2, pair_label, split = F.filter_kmers_set_arrays(
        reads, k, stranded=False, min_obs=1
    )
    anodes, out_labels, out_split = C.compress_kmers_color_sets(
        table2, pair_label, split, join_on_sets=True
    )

    otab, _ = O.filter_kmers(
        [(list(r[0]), 0, r[2]) for r in reads], k, O.CountFilterSet(1), False
    )
    onodes = O.compress_kmers(False, O.ScmapCompress(), otab, k)
    got = sorted(
        (
            tuple(int(x) for x in s),
            int(e),
            tuple(int(x) for x in out_labels[out_split[u] : out_split[u + 1]]),
        )
        for u, (s, e, _) in enumerate(anodes)
    )
    want = _norm_nodes(onodes, lambda d: tuple(sorted(set(d))))
    assert got == want


def test_rich_arbitrary_join_predicate(rng):
    """An arbitrary symmetric NON-equality join_test (|d1 - d2| <= 1)
    produces the same breaks as the oracle's sequential walk — the full
    join_test power the trait allows (compression.rs:37)."""

    class NearJoin:
        def reduce(self, a, b):
            return min(a, b)

        def join_test(self, d1, d2):
            return abs(d1 - d2) <= 1

    k = 16
    reads = _labeled_reads(rng, n_labels=5, n_reads=30)
    table, _ = F.filter_kmers_set(reads, k, stranded=False, min_obs=1)
    # payload: smallest label each kmer was seen with (deterministic)
    _, sets = F.filter_kmers_set(reads, k, stranded=False, min_obs=1)
    payloads = [min(s) for s in sets]

    otab, _ = O.filter_kmers(
        [(list(r[0]), 0, r[2]) for r in reads], k, O.CountFilterSet(1), False
    )
    otab = [(kv, e, min(d)) for kv, e, d in otab]
    onodes = O.compress_kmers(False, NearJoin(), otab, k)

    gnodes = C.compress_kmers_rich(table, payloads, spec=NearJoin())
    assert _norm_nodes(onodes, int) == _norm_nodes(gnodes, int)


def test_graph_rich_sidecar_roundtrip(rng, tmp_path):
    """Rich payloads ride BaseGraph/DebruijnGraph: from_compress_output,
    combine, compress_graph set-union fold, and save/load (the
    serializable-D checkpoint the reference gets from serde,
    graph.rs:43-50)."""
    k = 16
    reads = _labeled_reads(rng, n_labels=3, n_reads=30)
    table, sets = F.filter_kmers_set(reads, k, stranded=False, min_obs=1)
    nodes = C.compress_kmers_rich(
        table, sets, reduce=lambda a, b: tuple(sorted(set(a) | set(b)))
    )
    g = G.from_compress_output(k, False, nodes).finish()
    assert g.rich is not None and len(g.rich) == len(g)
    assert all(isinstance(r, tuple) for r in g.rich)

    # save/load preserves the sidecar exactly
    p = str(tmp_path / "colored.npz")
    g.save(p)
    g2 = G.DebruijnGraph.load(p)
    assert list(g2.rich) == list(g.rich)
    assert np.array_equal(g2.exts, g.exts)

    # combine keeps sidecars aligned
    comb = G.BaseGraph.combine([g.base, g2.base])
    assert comb.rich == list(g.rich) + list(g2.rich)

    # node-split + recompress: rebuild a 1-node-per-kmer graph with
    # per-kmer color sets, compress at graph level, and check the unions
    per_kmer = G.BaseGraph(k, False)
    for i in range(len(table)):
        from tpu_debruijn import kmer as KM

        per_kmer.add(
            KM.to_bases(table.spec, table.kmers[i]),
            int(table.exts[i]),
            0,
            rich=tuple(sets[i]),
        )
    pg = per_kmer.finish()
    cg = G.compress_graph(pg)
    want = {
        (tuple(int(x) for x in s), tuple(sorted(set(d)))) for s, e, d in nodes
    }
    got = {
        (
            tuple(int(x) for x in cg.base.sequences.get_bases(i)),
            tuple(sorted(cg.rich[i])),
        )
        for i in range(len(cg))
    }
    assert got == want


def test_graph_arbitrary_payload_checkpoint(rng, tmp_path):
    """Checkpoints round-trip ARBITRARY rich payloads, not just int
    sequences — the reference serializes any serde-serializable D
    (graph.rs:43,175).  Non-int payloads take a pickled byte sidecar;
    int-sequence payloads keep the compact flat+split arrays."""
    k = 16
    reads = _labeled_reads(rng, n_labels=3, n_reads=30)
    table, sets = F.filter_kmers_set(reads, k, stranded=False, min_obs=1)
    name = {0: "alpha", 1: "beta", 2: "gamma"}
    payloads = [tuple(name[x] for x in s) for s in sets]
    nodes = C.compress_kmers_rich(
        table, payloads, reduce=lambda a, b: tuple(sorted(set(a) | set(b)))
    )
    g = G.from_compress_output(k, False, nodes).finish()
    assert any(isinstance(x, str) for r in g.rich for x in r)

    p = str(tmp_path / "strcolors.npz")
    g.save(p)
    g2 = G.DebruijnGraph.load(p)
    assert list(g2.rich) == list(g.rich)
    assert np.array_equal(g2.exts, g.exts)
    assert np.array_equal(
        np.asarray(g2.base.sequences.length), np.asarray(g.base.sequences.length)
    )

    # non-sequence payloads (plain objects) also round-trip — previously
    # raised TypeError from the int-sequence validation (ADVICE r4)
    g.base._rich = [{"id": i, "tag": "x"} for i in range(len(g))]
    p2 = str(tmp_path / "objpayload.npz")
    g.save(p2)
    g3 = G.DebruijnGraph.load(p2)
    assert list(g3.rich) == list(g.rich)
