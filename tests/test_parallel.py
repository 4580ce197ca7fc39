"""Multi-chip sharded assembly == single-chip assembly (the reference's
reassemble_sharded oracle, test.rs:418-504), on a virtual 8-device mesh.
"""

import numpy as np
import pytest

from tpu_debruijn import compress as C
from tpu_debruijn import filter as F
from tpu_debruijn.graph import from_compress_output
from tpu_debruijn.oracle import ref as O
from tpu_debruijn.parallel import assemble_sharded, make_mesh

import os

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the virtual 8-device CPU mesh of conftest; fewer where fewer devices exist
_NDEV = min(8, jax.device_count())




def _reads_from_contigs(rng, contigs, n_reads=80, read_len=60, rc=True):
    reads = []
    pool = [np.asarray(c, np.uint8) for c in contigs if len(c) >= read_len]
    for _ in range(n_reads):
        c = pool[int(rng.integers(0, len(pool)))]
        s = int(rng.integers(0, len(c) - read_len + 1))
        r = c[s : s + read_len].copy()
        if rc and rng.random() < 0.5:
            r = (3 - r[::-1]).astype(np.uint8)
        reads.append(r)
    return reads


def _canon_node_set(graph):
    out = []
    for i in range(len(graph)):
        b = graph.base.sequences.get_bases(i)
        r = (3 - b[::-1]).astype(np.uint8)
        out.append(min(tuple(int(x) for x in b), tuple(int(x) for x in r)))
    return sorted(out)


@pytest.mark.parametrize("min_obs", [1, 2])
def test_sharded_equals_unsharded(rng, min_obs):
    """Exact N-shard == 1-shard equality.  Like the reference's
    reassemble_sharded (test.rs:443-444, which pushes every sequence twice
    so min_count=2 censors nothing), reads are duplicated: with censoring,
    shard-merge and kmer-level compression legitimately differ (the final
    compress_graph fix_exts drops censored exts that the kmer-level pass
    treats as branch evidence)."""
    k, p = 31, 8
    contigs = O.random_contigs(rng)
    reads = _reads_from_contigs(rng, contigs)
    reads = reads + reads
    mesh = make_mesh(_NDEV)
    g_sh = assemble_sharded(reads, k, p, stranded=False, min_obs=min_obs, mesh=mesh)

    table = F.filter_kmers([(r, 0, 0) for r in reads], k, stranded=False, min_obs=min_obs)
    nodes = C.compress_kmers(table)
    g_pl = from_compress_output(k, False, nodes).finish()

    assert _canon_node_set(g_sh) == _canon_node_set(g_pl)


def test_sharded_censoring_invariants(rng):
    """With genuine censoring (min_obs=2, singleton reads), assert the
    reference's invariants (test.rs:480-504): every unitig kmer is a raw
    kmer, and every end extension lands on a raw kmer."""
    from tpu_debruijn import kmer as KM

    k, p = 31, 8
    contigs = O.random_contigs(rng)
    reads = _reads_from_contigs(rng, contigs, n_reads=120)
    mesh = make_mesh(_NDEV)
    g = assemble_sharded(reads, k, p, stranded=False, min_obs=2, mesh=mesh)

    raw = set()
    for r in reads:
        v = O.OKmer.from_bases(r[:k])
        raw.add(O.OKmer.min_rc(k, v))
        for b in r[k:]:
            v = O.OKmer.extend_right(k, v, int(b))
            raw.add(O.OKmer.min_rc(k, v))

    for i in range(len(g)):
        seq = [int(x) for x in g.base.sequences.get_bases(i)]
        exts = int(g.exts[i])
        v = O.OKmer.from_bases(seq[:k])
        assert O.OKmer.min_rc(k, v) in raw
        for b in seq[k:]:
            v = O.OKmer.extend_right(k, v, int(b))
            assert O.OKmer.min_rc(k, v) in raw
        first = O.OKmer.from_bases(seq[:k])
        last = O.OKmer.from_bases(seq[-k:])
        for b in range(4):
            if O.e_dir_bits(exts, 0) & (1 << b):
                assert O.OKmer.min_rc(k, O.OKmer.extend_left(k, first, b)) in raw
            if O.e_dir_bits(exts, 1) & (1 << b):
                assert O.OKmer.min_rc(k, O.OKmer.extend_right(k, last, b)) in raw


def test_sharded_kmer_counts_exact(rng):
    """MSP guarantees all observations of a kmer land in one shard, so the
    union of shard tables must equal the global filter_kmers table."""
    from tpu_debruijn.parallel.shard import sharded_tables

    k, p = 31, 8
    contigs = O.random_contigs(rng)
    reads = _reads_from_contigs(rng, contigs, n_reads=40)
    mesh = make_mesh(_NDEV)
    plan, table, chains, u_exts, contrib = sharded_tables(
        reads, k, p, stranded=False, min_obs=1, mesh=mesh
    )
    kmers = np.asarray(table.kmers)
    counts = np.asarray(table.counts)
    nv = np.asarray(table.n_valid)
    got = {}
    from tpu_debruijn import kmer as KM

    for s in range(plan.n_shards):
        for i in range(int(nv[s])):
            v = KM.to_int(plan.spec, kmers[s, i])
            assert v not in got, "kmer appeared in two shards"
            got[v] = int(counts[s, i])

    ref = F.filter_kmers([(r, 0, 0) for r in reads], k, stranded=False, min_obs=1)
    want = {KM.to_int(ref.spec, ref.kmers[i]): int(ref.counts[i]) for i in range(len(ref))}
    assert got == want


def test_graft_entry_points():
    import sys

    sys.path.insert(0, REPO)
    import __graft_entry__ as G
    import jax

    fn, args = G.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert int(out[3]) > 0
    G.dryrun_multichip(8)


def test_auto_cap_skewed_minimizers(rng):
    """Count-then-allocate buffer sizing (SURVEY hard part 4): low-entropy
    reads concentrate all MSP intervals on a couple of destinations.  The
    legacy slack heuristic overflows there; the default histogram pass
    sizes the buffers exactly and the result still equals unsharded."""
    from tpu_debruijn.parallel.shard import sharded_tables

    k, p = 16, 15
    mesh = make_mesh(_NDEV)
    base = np.tile([0, 3], 40).astype(np.uint8)  # ATAT... (2 minimizers)
    reads = []
    for _ in range(32):
        r = base.copy()
        r[int(rng.integers(0, len(r)))] = int(rng.integers(0, 4))
        reads.append(r)

    # the fraction heuristic undersizes on this skew
    with pytest.raises(RuntimeError, match="overflowed"):
        sharded_tables(reads, k, p, mesh=mesh, slack=0.05)

    # the default count-then-allocate path sizes exactly
    g_sh = assemble_sharded(reads, k, p, stranded=False, min_obs=1, mesh=mesh)
    table = F.filter_kmers([(r, 0, 0) for r in reads], k, stranded=False, min_obs=1)
    nodes = C.compress_kmers(table)
    g_pl = from_compress_output(k, False, nodes).finish()
    assert _canon_node_set(g_sh) == _canon_node_set(g_pl)


def test_collective_stitch_equals_host_path(rng):
    """The on-device boundary-stitch collective
    (allgather of shard unitig end-kmer tables + one global node-level
    pointer-doubling round, SURVEY §7.6) must produce the SAME graph as
    the legacy host combine + compress_graph path — node-for-node,
    including exts and folded data."""
    k, p = 31, 8
    contigs = O.random_contigs(rng)
    reads = _reads_from_contigs(rng, contigs, n_reads=100)
    reads = reads + reads
    mesh = make_mesh(_NDEV)
    g_dev = assemble_sharded(
        reads, k, p, stranded=False, min_obs=2, mesh=mesh, collective=True
    )
    g_host = assemble_sharded(
        reads, k, p, stranded=False, min_obs=2, mesh=mesh, collective=False
    )

    def rows(g):
        out = []
        for i in range(len(g)):
            b = g.base.sequences.get_bases(i)
            r = (3 - b[::-1]).astype(np.uint8)
            fwd = tuple(int(x) for x in b)
            rev = tuple(int(x) for x in r)
            e = int(g.exts[i])
            if rev < fwd:
                fwd, rev = rev, fwd
                e = O.e_rc(e)
            out.append((fwd, e, int(g.data[i])))
        return sorted(out)

    assert rows(g_dev) == rows(g_host)


def test_permutation_balances_skewed_minimizers(rng):
    """The load-balancing minimizer permutation
    threaded through the sharded path (msp.rs:57-59, :298-311).  A
    poly-A-rich corpus makes the lexicographically-smallest p-mer the
    minimizer of most windows; the inverse-frequency score table must
    (a) cut the max/mean destination-load ratio and (b) leave the
    assembled graph IDENTICAL (bucketing is a partition choice, not a
    semantic one)."""
    import numpy as np

    from tpu_debruijn import msp as M
    from tpu_debruijn.parallel import sharded_tables
    from tpu_debruijn.parallel.shard import _dest_histogram_fn
    from tpu_debruijn import filter as F

    k, p = 31, 6
    # skewed corpus: every read carries poly-A runs -> AAAAAA dominates
    reads = []
    for _ in range(160):
        r = rng.integers(0, 4, 90).astype(np.uint8)
        s = int(rng.integers(0, 60))
        r[s : s + 24] = 0
        reads.append(r)
    bases, lengths = F.pad_reads(reads, min_len=k, pad_to=16)
    mesh = make_mesh(_NDEV)

    perm = M.inverse_frequency_score_table(p, bases, lengths)

    import jax.numpy as jnp

    h0 = np.asarray(
        _dest_histogram_fn(k, p, _NDEV, False, mesh)(
            jnp.asarray(bases), jnp.asarray(lengths)
        )
    ).sum(axis=0)
    h1 = np.asarray(
        _dest_histogram_fn(k, p, _NDEV, False, mesh, jnp.asarray(perm))(
            jnp.asarray(bases), jnp.asarray(lengths)
        )
    ).sum(axis=0)
    r0 = h0.max() / max(h0.mean(), 1)
    r1 = h1.max() / max(h1.mean(), 1)
    if _NDEV >= 8:
        assert r1 < r0, (r0, r1)

    g_perm = assemble_sharded(
        reads, k, p, stranded=False, min_obs=1, mesh=mesh, permutation=perm
    )
    g_plain = assemble_sharded(
        reads, k, p, stranded=False, min_obs=1, mesh=mesh
    )
    assert _canon_node_set(g_perm) == _canon_node_set(g_plain)
