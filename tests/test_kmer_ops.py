"""Property tests for kmer limb ops, mirroring kmer.rs:826-1165.

Every op is checked against the plain-Python oracle (int-rank arithmetic)
over random kmers for every supported K class (1-limb, 2-limb aligned,
2-limb padded, 3- and 4-limb).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_debruijn import kmer as KM
from tpu_debruijn.kmer import KmerSpec
from tpu_debruijn.oracle import ref as O

KS = [2, 3, 5, 8, 15, 16, 17, 24, 31, 32, 33, 47, 48, 63, 64]
N = 256  # per-item big-int oracle loop; bulk invariants below run 4096


@pytest.mark.parametrize("k", KS)
def test_kmer_ops_vs_oracle(k, rng):
    spec = KmerSpec(k)
    B = rng.integers(0, 4, (N, k))
    limbs = np.stack([KM.from_bases(spec, B[i]) for i in range(N)])
    vals = [O.OKmer.from_bases(B[i]) for i in range(N)]
    a = jnp.asarray(limbs)

    rcs = np.asarray(KM.rc(spec, a))
    rcrc = np.asarray(KM.rc(spec, jnp.asarray(rcs)))
    nb = rng.integers(0, 4, N)
    ers = np.asarray(KM.extend_right(spec, a, jnp.asarray(nb, jnp.uint32)))
    els = np.asarray(KM.extend_left(spec, a, jnp.asarray(nb, jnp.uint32)))
    mk, fl = KM.min_rc_flip(spec, a)
    mk, fl = np.asarray(mk), np.asarray(fl)
    pal = np.asarray(KM.is_palindrome(spec, a))
    ats = np.asarray(KM.at_count(spec, a))
    gcs = np.asarray(KM.gc_count(spec, a))
    hd = np.asarray(
        KM.hamming_dist(spec, a, jnp.asarray(np.roll(limbs, 1, axis=0)))
    )

    for i in range(N):
        v = vals[i]
        assert KM.to_int(spec, limbs[i]) == v
        # rc involution + value (kmer.rs:848-930)
        assert KM.to_int(spec, rcs[i]) == O.OKmer.rc(k, v)
        assert KM.to_int(spec, rcrc[i]) == v
        # per-base complement mirror
        rb = KM.to_bases(spec, rcs[i])
        assert all(int(rb[j]) == 3 - int(B[i][k - 1 - j]) for j in range(k))
        # extend semantics
        assert KM.to_int(spec, ers[i]) == O.OKmer.extend_right(k, v, int(nb[i]))
        assert KM.to_int(spec, els[i]) == O.OKmer.extend_left(k, v, int(nb[i]))
        # canonicalization incl. flip flag
        ok, ofl = O.OKmer.min_rc_flip(k, v)
        assert KM.to_int(spec, mk[i]) == ok and bool(fl[i]) == ofl
        assert bool(pal[i]) == O.OKmer.is_palindrome(k, v)
        # base counts
        assert ats[i] == sum(1 for x in B[i] if x in (0, 3))
        assert gcs[i] == sum(1 for x in B[i] if x in (1, 2))
        # hamming vs naive
        prev = B[(i - 1) % N] if k == len(B[(i - 1) % N]) else None
        naive = sum(1 for x, y in zip(B[i], B[(i - 1) % N]) if x != y)
        assert hd[i] == naive


@pytest.mark.parametrize("k", [2, 4, 16, 32, 48, 64])
def test_palindrome_positive(k, rng):
    spec = KmerSpec(k)
    half = rng.integers(0, 4, (N, k // 2))
    palB = np.concatenate([half, (3 - half)[:, ::-1]], axis=1)
    pl = np.stack([KM.from_bases(spec, palB[i]) for i in range(N)])
    assert np.asarray(KM.is_palindrome(spec, jnp.asarray(pl))).all()


@pytest.mark.parametrize("k", [5, 16, 31, 33])
def test_get_set_roundtrip(k, rng):
    spec = KmerSpec(k)
    B = rng.integers(0, 4, (N, k))
    limbs = jnp.asarray(np.stack([KM.from_bases(spec, B[i]) for i in range(N)]))
    for pos in range(0, k, max(1, k // 5)):
        got = np.asarray(KM.get_base(spec, limbs, pos))
        assert (got == B[:, pos]).all()
        newv = rng.integers(0, 4, N)
        setk = KM.set_base(spec, limbs, pos, jnp.asarray(newv, jnp.uint32))
        assert (np.asarray(KM.get_base(spec, setk, pos)) == newv).all()
        # dynamic-position gather agrees with static
        gd = np.asarray(
            KM.get_base_dyn(spec, limbs, jnp.full(N, pos, jnp.int32))
        )
        assert (gd == B[:, pos]).all()


def test_ordering_is_lexicographic(rng):
    # integer compare of limbs == string compare (kmer.rs doc invariant)
    k = 33
    spec = KmerSpec(k)
    B = rng.integers(0, 4, (N, k))
    limbs = [KM.from_bases(spec, B[i]) for i in range(N)]
    strs = [KM.to_string(spec, l) for l in limbs]
    ints = [KM.to_int(spec, l) for l in limbs]
    assert sorted(range(N), key=lambda i: strs[i]) == sorted(
        range(N), key=lambda i: ints[i]
    )


def test_hamming_neighbors(rng):
    # neighbors.rs:54-75: exactly 3K distinct HD-1 neighbors
    k = 12
    spec = KmerSpec(k)
    B = rng.integers(0, 4, (4, k))
    limbs = jnp.asarray(np.stack([KM.from_bases(spec, B[i]) for i in range(4)]))
    cands, mask = KM.hamming_neighbors(spec, limbs)
    cands, mask = np.asarray(cands), np.asarray(mask)
    for i in range(4):
        sel = {KM.to_int(spec, cands[i, j]) for j in range(4 * k) if mask[i, j]}
        assert len(sel) == 3 * k
        v = KM.to_int(spec, np.asarray(limbs[i]))
        for u in sel:
            assert (
                int(
                    np.asarray(
                        KM.hamming_dist(
                            spec,
                            jnp.asarray(KM.from_int(spec, u))[None],
                            limbs[i][None],
                        )
                    )[0]
                )
                == 1
            )


NB = 4096  # bulk rep count (reference runs 10,000/type, kmer.rs:1012-1164)


@pytest.mark.parametrize("k", KS)
def test_kmer_ops_bulk_invariants(k, rng):
    """Vectorized high-rep sweep: every limb op checked
    against base-matrix semantics in pure numpy over NB random kmers —
    no big-int loop, so reps are cheap."""
    spec = KmerSpec(k)
    B = rng.integers(0, 4, (NB, k)).astype(np.uint8)
    limbs = KM.from_bases_batch_np(spec, B)
    a = jnp.asarray(limbs)

    # roundtrip
    assert np.array_equal(KM.to_bases_batch_np(spec, limbs), B)

    # rc: bases reversed and complemented; involution
    rcs = np.asarray(KM.rc(spec, a))
    assert np.array_equal(KM.to_bases_batch_np(spec, rcs), 3 - B[:, ::-1])
    assert np.array_equal(np.asarray(KM.rc(spec, jnp.asarray(rcs))), limbs)

    # extend: shift in a base on either side (lib.rs:204-215)
    nb = rng.integers(0, 4, NB).astype(np.uint32)
    ers = KM.to_bases_batch_np(spec, np.asarray(KM.extend_right(spec, a, jnp.asarray(nb))))
    els = KM.to_bases_batch_np(spec, np.asarray(KM.extend_left(spec, a, jnp.asarray(nb))))
    assert np.array_equal(ers, np.concatenate([B[:, 1:], nb[:, None].astype(np.uint8)], axis=1))
    assert np.array_equal(els, np.concatenate([nb[:, None].astype(np.uint8), B[:, :-1]], axis=1))

    # canonicalization: min by base-lexicographic compare, flip flag matches
    mk, fl = KM.min_rc_flip(spec, a)
    mk, fl = np.asarray(mk), np.asarray(fl)
    fwd_lt = _rows_lt(B, 3 - B[:, ::-1])
    assert np.array_equal(fl, ~fwd_lt)  # flipped when not (kmer < rc)
    exp = np.where(fwd_lt[:, None], B, 3 - B[:, ::-1])
    assert np.array_equal(KM.to_bases_batch_np(spec, mk), exp)

    # palindrome / counts / hamming
    assert np.array_equal(
        np.asarray(KM.is_palindrome(spec, a)), (B == 3 - B[:, ::-1]).all(axis=1)
    )
    assert np.array_equal(np.asarray(KM.at_count(spec, a)), ((B == 0) | (B == 3)).sum(axis=1))
    assert np.array_equal(np.asarray(KM.gc_count(spec, a)), ((B == 1) | (B == 2)).sum(axis=1))
    other = np.roll(limbs, 1, axis=0)
    hd = np.asarray(KM.hamming_dist(spec, a, jnp.asarray(other)))
    assert np.array_equal(hd, (B != np.roll(B, 1, axis=0)).sum(axis=1))

    # ordering: limb-lex compare == string compare (kmer.rs layout contract)
    perm = rng.permutation(NB)[:512]
    A2, B2 = limbs[perm], np.roll(limbs, 7, axis=0)[perm]
    lt_limb = _rows_lt(A2.astype(np.uint64), B2.astype(np.uint64))
    lt_base = _rows_lt(KM.to_bases_batch_np(spec, A2), KM.to_bases_batch_np(spec, B2))
    assert np.array_equal(lt_limb, lt_base)



def _rows_lt(A, B):
    """Vectorized lexicographic row compare A < B."""
    A = np.asarray(A); B = np.asarray(B)
    ne = A != B
    first = np.argmax(ne, axis=1)
    any_ne = ne.any(axis=1)
    r = np.arange(A.shape[0])
    return any_ne & (A[r, first] < B[r, first])
