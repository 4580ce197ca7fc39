"""DnaSeq / PackedSeqSet container tests (dna_string.rs:824-1112 suite
equivalents: push/extend layouts, slicing, rc, hamming, kmer iteration)."""

import numpy as np
import pytest

from tpu_debruijn import kmer as KM
from tpu_debruijn.dna import DnaSeq, PackedSeqSet, pack_bases, unpack_bases
from tpu_debruijn.kmer import KmerSpec


def test_pack_unpack_roundtrip(rng):
    for n in [0, 1, 15, 16, 17, 100, 1000]:
        b = rng.integers(0, 4, n).astype(np.uint8)
        assert np.array_equal(unpack_bases(pack_bases(b), n), b)


def test_from_dna_string_roundtrip(rng):
    s = "".join("ACGT"[i] for i in rng.integers(0, 4, 123))
    d = DnaSeq.from_dna_string(s)
    assert d.to_dna_string() == s
    assert len(d) == 123


def test_from_dna_only_string():
    segs = DnaSeq.from_dna_only_string("ACGTNNGGTT-CC")
    assert [s.to_dna_string() for s in segs] == ["ACGT", "GGTT", "CC"]


def test_from_acgt_bytes():
    d = DnaSeq.from_acgt_bytes(b"ACGTNacgtn")
    assert d.to_dna_string() == "ACGTAACGTA"  # non-ACGT -> A


def test_from_acgt_bytes_hashn():
    a = DnaSeq.from_acgt_bytes_hashn(b"ACNNGT", b"read1")
    b = DnaSeq.from_acgt_bytes_hashn(b"ACNNGT", b"read1")
    c = DnaSeq.from_acgt_bytes_hashn(b"ACNNGT", b"read2")
    assert a == b  # repeatable per name
    assert a.bases()[0] == 0 and a.bases()[1] == 1
    assert len(c) == 6  # different name: still valid, possibly different


def test_slices_and_rc(rng):
    b = rng.integers(0, 4, 77).astype(np.uint8)
    d = DnaSeq.from_bases(b)
    assert np.array_equal(d.prefix(10).bases(), b[:10])
    assert np.array_equal(d.suffix(13).bases(), b[-13:])
    assert np.array_equal(d.slice(5, 40).bases(), b[5:40])
    assert np.array_equal(d.rc().bases(), 3 - b[::-1])
    assert np.array_equal(d.reverse().bases(), b[::-1])
    assert d.rc().rc() == d


def test_get_kmer_matches_slices(rng):
    k = 21
    spec = KmerSpec(k)
    b = rng.integers(0, 4, 60).astype(np.uint8)
    d = DnaSeq.from_bases(b)
    for pos in range(60 - k + 1):
        want = KM.from_bases(spec, b[pos : pos + k])
        assert np.array_equal(d.get_kmer(k, pos), want)
    assert np.array_equal(d.first_kmer(k), KM.from_bases(spec, b[:k]))
    assert np.array_equal(d.last_kmer(k), KM.from_bases(spec, b[-k:]))
    ks = list(d.iter_kmers(k))
    assert len(ks) == 60 - k + 1


def test_hamming(rng):
    b = rng.integers(0, 4, 100).astype(np.uint8)
    c = b.copy()
    idx = rng.choice(100, 7, replace=False)
    for i in idx:
        c[i] = (c[i] + 1) % 4
    assert DnaSeq.from_bases(b).hamming_distance(DnaSeq.from_bases(c)) == 7


def test_packed_seq_set(rng):
    seqs = [rng.integers(0, 4, int(rng.integers(1, 50))).astype(np.uint8)
            for _ in range(20)]
    s = PackedSeqSet.from_arrays(seqs)
    assert len(s) == 20
    assert s.total_bases() == sum(len(q) for q in seqs)
    for i, q in enumerate(seqs):
        assert np.array_equal(s.get_bases(i), q)
        assert s.get(i) == DnaSeq.from_bases(q)


def test_set_base(rng):
    # MerImmut::set (lib.rs:331-346)
    b = rng.integers(0, 4, 45).astype(np.uint8)
    s = DnaSeq.from_bases(b)
    for _ in range(20):
        pos = int(rng.integers(0, 45))
        val = int(rng.integers(0, 4))
        s2 = s.set(pos, val)
        want = b.copy()
        want[pos] = val
        assert np.array_equal(s2.bases(), want)
        assert np.array_equal(s.bases(), b)  # original untouched


def test_ndiffs_matches_naive(rng):
    # dna_string.rs:1071-1089: ndiffs == elementwise count, over many lengths
    for L in [1, 5, 16, 17, 31, 32, 100, 333]:
        a = rng.integers(0, 4, L).astype(np.uint8)
        b = a.copy()
        flips = rng.random(L) < 0.15
        b[flips] = (b[flips] + 1 + rng.integers(0, 3, int(flips.sum()))) % 4
        sa, sb = DnaSeq.from_bases(a), DnaSeq.from_bases(b)
        assert sa.ndiffs(sb) == int((a != b).sum())
        assert sa.ndiffs(sb) == sa.hamming_distance(sb)


def test_at_gc_counts(rng):
    b = rng.integers(0, 4, 77).astype(np.uint8)
    s = DnaSeq.from_bases(b)
    assert s.at_count() == int(((b == 0) | (b == 3)).sum())
    assert s.gc_count() == int(((b == 1) | (b == 2)).sum())
    assert s.at_count() + s.gc_count() == len(s)


def test_iter_kmer_exts_vs_oracle(rng):
    # Vmer::iter_kmer_exts (lib.rs:408-421, KmerExtsIter lib.rs:809-842)
    from tpu_debruijn.oracle import ref as O

    k = 8
    spec = KmerSpec(k)
    b = rng.integers(0, 4, 30).astype(np.uint8)
    seq_exts = 0b0010_0100  # left ext G, right ext C
    s = DnaSeq.from_bases(b)
    got = [(KM.to_int(spec, km), e) for km, e in s.iter_kmer_exts(k, seq_exts)]
    want = list(O.iter_kmer_exts(list(b), k, seq_exts))
    assert got == want


def test_kmers_from_bytes_and_ascii(rng):
    # Kmer::kmers_from_bytes / kmers_from_ascii (lib.rs:288-327)
    k = 11
    spec = KmerSpec(k)
    b = rng.integers(0, 4, 40).astype(np.uint8)
    ks = KM.kmers_from_bytes(spec, b)
    assert ks.shape == (40 - k + 1, spec.w)
    for i in range(len(ks)):
        assert KM.to_int(spec, ks[i]) == KM.to_int(spec, KM.from_bases(spec, b[i:i+k]))
    from tpu_debruijn.bases import bases_to_str
    ka = KM.kmers_from_ascii(spec, bases_to_str(b))
    assert np.array_equal(ks, ka)
    assert KM.kmers_from_bytes(spec, b[: k - 1]).shape == (0, spec.w)


def test_seq_slice_view_basic(rng):
    """Zero-copy SeqSlice: get/bases/rc match the copying DnaSeq ops
    (DnaStringSlice, dna_string.rs:541-626)."""
    from tpu_debruijn.dna import SeqSlice

    b = rng.integers(0, 4, 97).astype(np.uint8)
    d = DnaSeq.from_bases(b)
    v = d.slice_view(10, 40)
    assert len(v) == 30
    assert np.array_equal(v.bases(), b[10:40])
    assert all(v.get(i) == int(b[10 + i]) for i in range(30))
    # rc() flips the flag only; bases are remapped on access
    r = v.rc()
    assert r.is_rc and r.parent is d and r.start == 10
    assert np.array_equal(r.bases(), (3 - b[10:40][::-1]))
    assert all(r.get(i) == int(3 - b[39 - i]) for i in range(30))
    # rc is an involution
    assert np.array_equal(r.rc().bases(), v.bases())
    assert v.to_owned() == DnaSeq.from_bases(b[10:40])


def test_seq_slice_of_rc_slice(rng):
    """Re-slicing under rc remaps parent coordinates
    (dna_string.rs:668-695; test dna_string.rs:882-903)."""
    b = rng.integers(0, 4, 64).astype(np.uint8)
    d = DnaSeq.from_bases(b)
    v = d.slice_view(4, 60).rc()          # 56 bases, rc view
    naive = (3 - b[4:60][::-1]).astype(np.uint8)
    for s, e in [(0, 56), (3, 50), (10, 11), (20, 20)]:
        sub = v.slice(s, e)
        assert np.array_equal(sub.bases(), naive[s:e])
        # double rc + re-slice still lands on the same bases
        assert np.array_equal(sub.rc().rc().bases(), naive[s:e])
    assert np.array_equal(v.prefix(7).bases(), naive[:7])
    assert np.array_equal(v.suffix(7).bases(), naive[-7:])


def test_seq_slice_kmers_match_owned(rng):
    k = 9
    b = rng.integers(0, 4, 40).astype(np.uint8)
    v = DnaSeq.from_bases(b).slice_view(2, 35).rc()
    owned = v.to_owned()
    assert np.array_equal(v.first_kmer(k), owned.first_kmer(k))
    assert np.array_equal(v.last_kmer(k), owned.last_kmer(k))
    got = [KM.to_int(KmerSpec(k), x) for x in v.iter_kmers(k)]
    want = [KM.to_int(KmerSpec(k), x) for x in owned.iter_kmers(k)]
    assert got == want


def test_packed_seqset_density_and_roundtrip(rng):
    """PackedSeqSet stores 2-bit packed words (dna_string.rs:72 parity):
    resident storage is ~4x smaller than uint8 codes
    and every accessor matches the unpacked truth."""
    from tpu_debruijn.dna import PackedSeqSet

    seqs = [rng.integers(0, 4, int(rng.integers(1, 100))).astype(np.uint8)
            for _ in range(200)]
    s = PackedSeqSet.from_arrays(seqs)
    total = sum(len(q) for q in seqs)
    assert s.total_bases() == total
    # resident packed words: 2 bits/base
    assert s.packed_words().nbytes <= (total // 16 + 2) * 4
    for i in (0, 1, 57, 199):
        assert np.array_equal(s.get_bases(i), seqs[i])
    assert np.array_equal(s._flat(), np.concatenate(seqs))

    # incremental consolidation across add_flat boundaries (mid-word tail)
    s2 = PackedSeqSet()
    s2.add_flat(np.concatenate(seqs[:3]), [len(q) for q in seqs[:3]])
    _ = s2.length  # force consolidation mid-stream
    s2.add_flat(np.concatenate(seqs[3:7]), [len(q) for q in seqs[3:7]])
    for i in range(7):
        assert np.array_equal(s2.get_bases(i), seqs[i])

    # packed <-> from_packed roundtrip
    s3 = PackedSeqSet.from_packed(s.packed_words(), [len(q) for q in seqs])
    for i in (0, 42, 199):
        assert np.array_equal(s3.get_bases(i), seqs[i])
    # appends after a packed load keep alignment
    s3.add(seqs[0])
    assert np.array_equal(s3.get_bases(200), seqs[0])


def test_incremental_builders(rng):
    """push / extend / push_bytes builders (dna_string.rs:303-380)."""
    from tpu_debruijn.dna import DnaSeq, DnaSeqBuilder

    s = DnaSeq.from_dna_string("ACG")
    s2 = s.push(3)
    assert s2.to_dna_string() == "ACGT"
    s3 = s2.extend([0, 1, 2, 3])
    assert s3.to_dna_string() == "ACGTACGT"

    # push_bytes: 2-bit packed, LSB-first within each byte
    # (dna_string.rs:937-951 layout: byte 0b11100100 -> A,C,G,T)
    s4 = DnaSeq.from_bases(np.zeros(0, np.uint8)).push_bytes(
        bytes([0b11100100]), 4
    )
    assert s4.to_dna_string() == "ACGT"
    with pytest.raises(ValueError):
        s4.push_bytes(bytes([0]), 5)

    b = DnaSeqBuilder()
    want = rng.integers(0, 4, 100).astype(np.uint8)
    for x in want[:50]:
        b.push(int(x))
    b.extend(want[50:])
    assert len(b) == 100
    assert np.array_equal(b.build().bases(), want)
    b.clear()
    assert len(b.build()) == 0
