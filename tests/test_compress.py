"""Exact parity of pointer-doubling compression vs the oracle's sequential
reimplementation of CompressFromHash (compression.rs:355-615).

Checks unitig sequences, end-Exts, reduced data, and node order on the
reference's fixture generators plus degenerate cases (palindromic repeats,
homopolymers/self-loops, circular period-2 repeats).
"""

import numpy as np
import pytest

from tpu_debruijn import compress as C
from tpu_debruijn import filter as F
from tpu_debruijn.oracle import ref as O


def _run_case(contigs, k, stranded, minobs=1):
    seqs = [(np.array(c, dtype=np.uint8), 0, 0) for c in contigs if len(c) >= k]
    seqs = seqs + seqs
    tab = F.filter_kmers(seqs, k, stranded=stranded, min_obs=minobs)
    otab, _ = O.filter_kmers(
        [(list(s[0]), 0, 0) for s in seqs], k, O.CountFilter(minobs), stranded
    )
    assert tab.to_tuples() == [(kv, e, c) for kv, e, c in otab]
    spec = O.SimpleCompress(lambda a, b: min(a + b, 0xFFFF))
    onodes = O.compress_kmers(stranded, spec, otab, k)
    gnodes = C.compress_kmers(tab, data_reduce="sum_sat_u16")
    ow = [(tuple(s), e, d) for s, e, d in onodes]
    gw = [(tuple(int(x) for x in s), e, d) for s, e, d in gnodes]
    assert ow == gw
    return gnodes


def test_degenerate_palindromic_repeat():
    # test.rs:170-193 (degen_seq_asm) at K31
    ctg = [{"A": 0, "C": 1, "G": 2, "T": 3}[c]
           for c in "AAAAATAAAATAAAATAAAATAAAATAAAATAAAATAAAATAAAA"]
    nodes = _run_case([ctg, ctg], 31, stranded=False)
    assert len(nodes) == 2


def test_homopolymer_self_loop():
    homo = [0] * 50
    _run_case([homo], 16, stranded=False)
    _run_case([homo], 16, stranded=True)


def test_period2_circular():
    _run_case([[0, 1] * 40], 16, stranded=False)
    _run_case([[2, 3] * 40], 16, stranded=True)


def test_embedded_palindrome(rng):
    # simple_random_contigs embeds a 66bp palindrome (test.rs:81-91)
    for trial in range(2):
        contigs = O.simple_random_contigs(rng)
        for k, stranded in [(16, False), (16, True), (31, False)]:
            _run_case(contigs, k, stranded)


def test_complex_repeats(rng):
    # random_contigs: Gamma-distributed chunk reuse (test.rs:98-132)
    for trial in range(2):
        contigs = O.random_contigs(rng)
        for k, stranded in [(16, False), (31, False), (32, False)]:
            _run_case(contigs, k, stranded)


def test_unitig_kmers_partition_kmer_set(rng):
    # reassemble_contigs final invariant (test.rs:392-413): the union of
    # unitig kmers equals the input kmer set, each kmer in exactly one node
    k = 16
    contigs = O.random_contigs(rng)
    seqs = [(np.array(c, dtype=np.uint8), 0, 0) for c in contigs if len(c) >= k]
    tab = F.filter_kmers(seqs, k, stranded=False, min_obs=1)
    kmer_set = set(tab.kmer_ints())
    nodes = C.compress_kmers(tab)
    seen = {}
    for seq, exts, _ in nodes:
        assert len(seq) >= k
        v = O.OKmer.from_bases(seq[:k])
        ks = [O.OKmer.min_rc(k, v)]
        for b in seq[k:]:
            v = O.OKmer.extend_right(k, v, int(b))
            ks.append(O.OKmer.min_rc(k, v))
        for x in ks:
            seen[x] = seen.get(x, 0) + 1
        # end exts reach valid kmers
        f = O.OKmer.from_bases(seq[:k])
        l = O.OKmer.from_bases(seq[-k:])
        for b in range(4):
            if O.e_dir_bits(exts, 0) & (1 << b):
                assert O.OKmer.min_rc(k, O.OKmer.extend_left(k, f, b)) in kmer_set
            if O.e_dir_bits(exts, 1) & (1 << b):
                assert O.OKmer.min_rc(k, O.OKmer.extend_right(k, l, b)) in kmer_set
    assert set(seen) == kmer_set
    assert all(c == 1 for c in seen.values())


def test_scmap_join_test(rng):
    # ScmapCompress (compression.rs:84-98): different data may not merge
    k = 16
    c = list(rng.integers(0, 4, 80))
    # two reads with different labels overlapping in the middle
    seqs = [(np.array(c[:50], dtype=np.uint8), 0, 1),
            (np.array(c[30:], dtype=np.uint8), 0, 2)]
    tab = F.filter_kmers(seqs, k, stranded=False, min_obs=1, data_reduce="min")
    otab, _ = O.filter_kmers(
        [(list(s[0]), 0, s[2]) for s in seqs], k,
        _MinLabel(1), False,
    )
    assert [(kv, e) for kv, e, _ in tab.to_tuples()] == [(kv, e) for kv, e, _ in otab]
    onodes = O.compress_kmers(False, O.ScmapCompress(), otab, k)
    # engine: join only equal labels, keep label
    gnodes = C.compress_kmers(tab, data_reduce="first", join_on_data=True,
                              data_field="data")
    ow = [(tuple(s), e, d) for s, e, d in onodes]
    gw = [(tuple(int(x) for x in s), e, d) for s, e, d in gnodes]
    assert ow == gw


class _MinLabel:
    """Oracle summarizer: data = min label (to match engine data_reduce=min)."""

    def __init__(self, min_kmer_obs):
        self.min_kmer_obs = min_kmer_obs

    def summarize(self, items):
        all_exts = 0
        labels = []
        for _, exts, d in items:
            labels.append(d)
            all_exts |= exts
        return len(labels) >= self.min_kmer_obs, all_exts, min(labels)


def test_compress_kmers_no_exts(rng):
    """compress_kmers_no_exts (compression.rs:619-659): exts inferred from
    set membership produce unitigs whose kmers partition the input set."""
    from tpu_debruijn import kmer as KM
    from tpu_debruijn.kmer import KmerSpec

    k = 16
    spec = KmerSpec(k)
    contigs = O.simple_random_contigs(rng)
    reads = [(np.asarray(c, np.uint8), 0, 0) for c in contigs]
    for stranded in (False, True):
        table = F.filter_kmers(reads, k, stranded=stranded, min_obs=1)
        nodes = C.compress_kmers_no_exts(
            k, table.kmers, stranded=stranded
        )
        # inferred-ext graph must cover exactly the input kmer set
        want = {KM.to_int(spec, table.kmers[i]) for i in range(len(table))}
        got = []
        for seq, _, _ in nodes:
            s = np.asarray(seq)
            for i in range(len(s) - k + 1):
                km = KM.from_bases(spec, s[i : i + k])
                if not stranded:
                    km = np.asarray(
                        KM.min_rc(spec, km[None])[0]
                    )
                got.append(KM.to_int(spec, km))
        assert sorted(got) == sorted(want)
        # each kmer appears exactly once across unitigs
        assert len(got) == len(want)


def test_compression_spec_classes(rng):
    """CompressionSpec / SimpleCompress / ScmapCompress (compression.rs:34-98)."""
    from tpu_debruijn.compress import ScmapCompress, SimpleCompress

    k = 16
    c = list(rng.integers(0, 4, 80))
    seqs = [(np.array(c[:50], dtype=np.uint8), 0, 1),
            (np.array(c[30:], dtype=np.uint8), 0, 2)]
    tab = F.filter_kmers(seqs, k, stranded=False, min_obs=1, data_reduce="min")

    # ScmapCompress == the shorthand (join on equal data, keep it)
    want = C.compress_kmers(tab, data_reduce="first", join_on_data=True,
                            data_field="data")
    got = C.compress_kmers(tab, spec=ScmapCompress(), data_field="data")
    assert [(tuple(int(x) for x in s), e, d) for s, e, d in want] == \
           [(tuple(int(x) for x in s), e, d) for s, e, d in got]

    # SimpleCompress with a closure == the named segmented op
    want = C.compress_kmers(tab, data_reduce="sum_sat_u16")
    got = C.compress_kmers(tab, spec=SimpleCompress(lambda a, b: min(a + b, 0xFFFF)))
    assert [(tuple(int(x) for x in s), e, d) for s, e, d in want] == \
           [(tuple(int(x) for x in s), e, d) for s, e, d in got]

    # custom join_labels callable: parity (all labels equal) == no join test
    got = C.compress_kmers(tab, data_field="data",
                           spec=C.CompressionSpec(reduce="min",
                                                  join_labels=lambda d: 0))
    want = C.compress_kmers(tab, data_reduce="min", data_field="data")
    assert [(tuple(int(x) for x in s), e, d) for s, e, d in want] == \
           [(tuple(int(x) for x in s), e, d) for s, e, d in got]


def test_compression_spec_in_compress_graph(rng):
    """compress_graph accepts a CompressionSpec (compression.rs:291-349)."""
    from tpu_debruijn.compress import SimpleCompress
    from tpu_debruijn.graph import BaseGraph, compress_graph

    k = 16
    contigs = O.simple_random_contigs(rng)
    seqs = [(np.asarray(c, np.uint8), 0, 0) for c in contigs if len(c) >= k]
    tab = F.filter_kmers(seqs, k, stranded=False, min_obs=1)
    # 1-node-per-kmer graph, then re-compress with a closure spec
    g = BaseGraph(k, False)
    for i in range(len(tab)):
        import tpu_debruijn.kmer as KM
        g.add(KM.to_bases_batch_np(tab.spec, tab.kmers[i : i + 1])[0],
              int(tab.exts[i]), int(tab.counts[i]))
    dbg = g.finish()
    out = compress_graph(dbg, spec=SimpleCompress(lambda a, b: min(a + b, 0xFFFF)))
    ref = compress_graph(dbg, data_reduce="sum_sat_u16")
    assert len(out) == len(ref)
    assert out.is_compressed() is None
    got = sorted((tuple(out.base.sequences.get_bases(i)), int(out.data[i]))
                 for i in range(len(out)))
    want = sorted((tuple(ref.base.sequences.get_bases(i)), int(ref.data[i]))
                  for i in range(len(ref)))
    assert got == want


def test_high_k_end_to_end(rng):
    """High-K regime: canonical build at K=47 plus the dual-lane
    edges K=33 and K=63 (multi-limb extend/rc/searchsorted through the FULL
    filter+compress pipeline; kmer.rs:51-57 u128 analog)."""
    contigs = O.simple_random_contigs(rng)
    for k in (33, 47, 63):
        _run_case(contigs, k, stranded=False)
        _run_case(contigs, k, stranded=True)


def test_high_k_tip_cleaning(rng):
    """Tip cleaning at K=47 canonical (clean_graph at high K); invariant: cleaned graph re-compresses to a fixed point."""
    from tpu_debruijn import clean as CL
    from tpu_debruijn import graph as G

    k = 47
    contigs = [rng.integers(0, 4, 300), rng.integers(0, 4, 300)]
    all_seqs = []
    for c in contigs:
        for _ in range(5):
            all_seqs.append((c, 0, 0))
        junk = rng.integers(0, 4, 8)
        err = np.concatenate([c[: len(c) // 2], junk])
        all_seqs.append((err, 0, 0))
        all_seqs.append((err, 0, 0))
    tab = F.filter_kmers(all_seqs, k, stranded=False, min_obs=2)
    g = G.from_compress_output(k, False, C.compress_kmers(tab)).finish()
    fixed = CL.clean_tips(g, lambda node: node.len() < k * 2)
    assert fixed.is_compressed() is None
    # exactly the two clean 300bp contigs survive; a no-op clean would
    # leave the short junk tips (len < 2k) in the graph
    assert len(fixed) == 2
    assert all(fixed.get_node(i).len() == 300 for i in range(len(fixed)))


@pytest.mark.parametrize("stranded", [False, True])
def test_device_assembly_matches_host(rng, stranded):
    """assemble_unitigs_device builds the SAME flat layout as the host
    assembler (offsets, head kmer orientation, tail contribs, u16 count
    sums) -- the route compress_kmers takes for its default policy."""
    k = 16
    contigs = O.random_contigs(rng)
    seqs = [(np.asarray(c, np.uint8), 0, 0) for c in contigs if len(c) >= k]
    tab = F.filter_kmers(seqs + seqs, k, stranded=stranded, min_obs=2)
    # an explicit spec sends compress_kmers through the host assembler
    want_nodes = C.compress_kmers(tab, spec=C.SimpleCompress("sum_sat_u16"))

    seq_flat, out_lengths, u_exts, data = C.compress_kmers_flat_device(tab)
    # rebuild the ragged list and compare node-for-node
    off = np.zeros(len(out_lengths) + 1, np.int64)
    np.cumsum(out_lengths, out=off[1:])
    got = [
        (tuple(int(x) for x in seq_flat[off[u] : off[u + 1]]),
         int(u_exts[u]), int(data[u]))
        for u in range(len(out_lengths))
    ]
    want = [(tuple(int(x) for x in s), int(e), int(d)) for s, e, d in want_nodes]
    assert got == want


def test_device_assembly_overflow_grows(rng):
    """cap_bases overflow is detected and retried with a larger cap."""
    k = 16
    seq = rng.integers(0, 4, 400).astype(np.uint8)
    tab = F.filter_kmers([(seq, 0, 0)], k, stranded=True, min_obs=1)
    small = C.compress_kmers_flat_device(tab, cap_bases=64)
    full = C.compress_kmers_flat_device(tab)
    assert np.array_equal(small[0], full[0])
    assert np.array_equal(small[1], full[1])


def _chains_tuple(ch):
    import numpy as np

    nu = int(ch.n_unitigs)
    return (
        np.asarray(ch.uid).tolist(),
        np.asarray(ch.pos).tolist(),
        np.asarray(ch.flip).tolist(),
        nu,
        np.asarray(ch.length)[:nu].tolist(),
        np.asarray(ch.first_item)[:nu].tolist(),
        np.asarray(ch.last_item)[:nu].tolist(),
        np.asarray(ch.first_flip)[:nu].tolist(),
        np.asarray(ch.last_flip)[:nu].tolist(),
    )


@pytest.mark.parametrize("stranded", [False, True])
def test_link_chains_ordered_matches_plain(rng, stranded):
    """link_chains_ordered == link_chains EXACTLY (uid order, positions,
    orientations, per-unitig metadata) on read corpora, both with the
    real first-occurrence order and with adversarial junk first_pos
    (correctness must not depend on the ordering hint)."""
    import jax.numpy as jnp

    from tpu_debruijn import filter as F

    k = 21
    contigs = O.random_contigs(rng)
    reads = []
    for c in contigs:
        c = np.asarray(c, np.uint8)
        for s in range(0, max(len(c) - 60, 1), 13):
            r = c[s : s + 60]
            if len(r) < k:
                continue
            if rng.random() < 0.5:
                r = (3 - r[::-1]).astype(np.uint8)
            reads.append((r, 0, 0))
    table = F.filter_kmers(reads, k, stranded=stranded, min_obs=1,
                           data_reduce="obs_min")
    n = len(table.kmers)
    assert n > 100
    kmers = jnp.asarray(table.kmers)
    exts = jnp.asarray(table.exts)
    plain = C._compress_jit(
        C.KmerSpec(k), stranded, False, kmers, exts, jnp.int32(n),
        jnp.zeros(n, jnp.int32),
    )
    for fp, cap in (
        (np.asarray(table.data, np.int32), 1 << 12),  # real order: contracts
        (rng.permutation(n).astype(np.int32), n),     # junk: ~no contraction
        (np.zeros(n, np.int32), n),                   # all ties
    ):
        ordered = C._compress_ordered_jit(
            C.KmerSpec(k), stranded, cap, kmers, exts, jnp.int32(n),
            jnp.asarray(fp),
        )
        assert not bool(ordered[3]), "contracted cap overflowed in test"
        assert _chains_tuple(ordered[0]) == _chains_tuple(plain[0])
        nu = int(plain[0].n_unitigs)
        assert np.array_equal(
            np.asarray(ordered[1])[:nu], np.asarray(plain[1])[:nu]
        )
        assert np.array_equal(np.asarray(ordered[2]), np.asarray(plain[2]))


def test_link_chains_ordered_overflow_flag(rng):
    """A too-small contracted cap reports overflow instead of silently
    truncating."""
    import jax.numpy as jnp

    from tpu_debruijn import filter as F

    reads = [(O.random_dna(rng, 80), 0, 0) for _ in range(40)]
    table = F.filter_kmers(reads, 31, stranded=False, min_obs=1,
                           data_reduce="obs_min")
    n = len(table.kmers)
    ordered = C._compress_ordered_jit(
        C.KmerSpec(31), False, 4, jnp.asarray(table.kmers),
        jnp.asarray(table.exts), jnp.int32(n), jnp.asarray(table.data),
    )
    assert bool(ordered[3])
