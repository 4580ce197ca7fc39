"""Card-only tests: the count and compress programs as compiled for a GPU
against the sequential oracle.  They skip where JAX's first device is not
a GPU (the ``gpu`` fixture); ``chip_smoke.py`` runs them on the card:

    python -m pytest -m gpu tests/test_gpu.py
"""

import numpy as np
import pytest

from tpu_debruijn import compress as C
from tpu_debruijn import filter as F
from tpu_debruijn.oracle import ref as O

pytestmark = pytest.mark.gpu


def _reads(rng, n=64, length=100, genome=600):
    g = rng.integers(0, 4, genome).astype(np.uint8)
    out = []
    for _ in range(n):
        s = int(rng.integers(0, genome - length))
        r = g[s : s + length].copy()
        if rng.random() < 0.5:
            r = (3 - r[::-1]).astype(np.uint8)
        out.append((r, 0, 0))
    return out


@pytest.mark.parametrize("k,stranded", [(16, True), (31, False), (47, False),
                                        (63, False)])
def test_filter_kmers_on_gpu_matches_oracle(gpu, rng, k, stranded):
    seqs = _reads(rng)
    tab = F.filter_kmers(seqs, k, stranded=stranded, min_obs=2)
    otab, _ = O.filter_kmers([(list(s), e, d) for s, e, d in seqs], k,
                             O.CountFilter(2), stranded)
    assert len(tab) > 0
    assert tab.to_tuples() == [(kv, e, c) for kv, e, c in otab]


@pytest.mark.parametrize("k", [16, 31])
def test_compress_kmers_on_gpu_matches_oracle(gpu, rng, k):
    contigs = O.random_contigs(rng)
    seqs = [(np.asarray(c, np.uint8), 0, 0) for c in contigs if len(c) >= k]
    seqs = seqs + seqs
    tab = F.filter_kmers(seqs, k, stranded=False, min_obs=1)
    otab, _ = O.filter_kmers([(list(s), 0, 0) for s, _, _ in seqs], k,
                             O.CountFilter(1), False)
    onodes = O.compress_kmers(
        False, O.SimpleCompress(lambda a, b: min(a + b, 0xFFFF)), otab, k
    )
    got = [(tuple(int(x) for x in s), e, d) for s, e, d in C.compress_kmers(tab)]
    assert got == [(tuple(s), e, d) for s, e, d in onodes]


def test_streaming_device_merge_on_gpu_equals_in_memory(gpu, rng):
    seqs = _reads(rng, n=512)
    want = F.filter_kmers(seqs, 31, stranded=False, min_obs=2)
    got = F.filter_kmers_streaming(seqs, 31, stranded=False, min_obs=2,
                                   merge="device", data_reduce="none",
                                   chunk_reads=256)
    assert got.to_tuples() == want.to_tuples()
