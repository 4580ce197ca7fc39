"""The count program's front end (plain XLA) against the sequential oracle:
``canonicalize`` alone at every limb width, and ``extract_kmers`` +
``canonicalize`` over whole reads, stranded and not."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_debruijn import filter as F
from tpu_debruijn import kmer as KM
from tpu_debruijn.kmer import KmerSpec
from tpu_debruijn.oracle import ref as O


@pytest.mark.parametrize("k", [4, 15, 16, 31, 32, 47, 48, 63, 64])
def test_canonicalize_vs_oracle(rng, k):
    spec = KmerSpec(k)
    n = 300
    bases = rng.integers(0, 4, (n, k))
    kmers = jnp.asarray(KM.from_bases_batch_np(spec, bases))
    exts = rng.integers(0, 256, n).astype(np.int32)

    ck, ce, fl = F.canonicalize(spec, kmers, jnp.asarray(exts), False)
    ck, ce, fl = np.asarray(ck), np.asarray(ce), np.asarray(fl)
    for i in range(n):
        v = KM.to_int(spec, np.asarray(kmers[i]))
        want_v, want_flip = O.OKmer.min_rc_flip(k, v)
        assert KM.to_int(spec, ck[i]) == want_v
        assert bool(fl[i]) == want_flip
        assert ce[i] == (O.e_rc(int(exts[i])) if want_flip else exts[i])


@pytest.mark.parametrize("stranded", [False, True])
@pytest.mark.parametrize("k", [16, 31, 47, 63])
def test_extract_canonicalize_vs_oracle(rng, k, stranded):
    spec = KmerSpec(k)
    lens = rng.integers(k, k + 50, 6)
    seqs = [rng.integers(0, 4, int(n)) for n in lens]
    ses = rng.integers(0, 256, len(seqs)).astype(np.int32)
    bases, lengths = F.pad_reads(seqs, min_len=k, pad_to=16)
    km, ex, vd = F.extract_kmers(
        spec, jnp.asarray(bases), jnp.asarray(lengths), jnp.asarray(ses)
    )
    km, ex, _ = F.canonicalize(spec, km, ex, stranded)
    km, ex, vd = np.asarray(km), np.asarray(ex), np.asarray(vd)
    for r, (seq, se) in enumerate(zip(seqs, ses)):
        want = []
        for v, e in O.iter_kmer_exts(list(seq), k, int(se)):
            if not stranded:
                v, flip = O.OKmer.min_rc_flip(k, v)
                e = O.e_rc(e) if flip else e
            want.append((v, e))
        assert int(vd[r].sum()) == len(want)
        got = [(KM.to_int(spec, km[r, s]), int(ex[r, s]))
               for s in range(len(want))]
        assert got == want
