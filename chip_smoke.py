"""End-to-end smoke test of the assembly path on an NVIDIA GPU.

The corpus is a bacterial isolate (GAGE, Salzberg et al. 2012): a random
~4.6 Mb genome (E. coli scale) read at ~30x by 150 bp reads, half of them
reverse-complemented, with 0.5 % substitution errors, all generated from
``--seed``.  That is ~920k reads and ~110M k=31 observations; the errors
make ``min_obs=2`` censoring and censored-extension repair do real work.

Phases (each prints its set-up time — first call minus second call:
compiles and first-use costs — and its run time):

* A: the README quick start, line for line, from a FASTQ file:
  ``read_fastq`` -> ``filter_kmers`` -> ``compress_kmers`` ->
  ``from_compress_output(...).finish()`` -> ``to_gfa``.  The table must
  equal an independent NumPy reference exactly (keys, saturated counts,
  exts, and exts after censored-extension repair); every table k-mer must
  appear exactly once across the unitigs; unitigs that are exact
  substrings of the genome (or its reverse complement) must cover >= 95 %
  of it.
* B: the out-of-core path, ``filter_kmers_streaming(merge="device")`` over
  the same FASTQ; its table must equal phase A's, and its unitigs must
  partition it.
* gpu tests: ``pytest -m gpu`` over ``tests/test_gpu.py``, in process.
* C (only with ``--four-cards``, and then alone): ``assemble_sharded``
  over a mesh of four GPUs against the one-card assembly, by canonical
  node set, with censoring inert and with censoring active.

Every comparison is exact: the engine is integer-only, with no
floating-point matrix product, so TF32 and summation order do not arise.

The last line of standard output is ``{"ok": true, "device": {...}}``,
printed only when every check passed on a GPU.  Without one the script
exits non-zero before any phase; ``--rehearse`` runs the phases on any
backend (e.g. the CPU at ``--corpus-scale 0.002``) and still fails the
final device check.

    python chip_smoke.py                  # phases A, B, gpu tests; one card
    python chip_smoke.py --four-cards     # phase C only; four cards
    python chip_smoke.py --compile-only   # compile at full size, print
                                          # memory_analysis(), stop
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

GENOME_LEN = 4_600_000
READ_LEN = 150
COVERAGE = 30
ERROR_IN = 200  # one substitution per 200 bases: 0.5 %
K = 31
MIN_OBS = 2
# phase C's corpus, as a fraction of phase A's: its one-card comparator,
# assemble_sharded on a 1-device mesh, pads its tables to every
# observation slot of every MSP interval; at full size its sort-join
# exceeds 2^29 rows, and at 0.1 it held 11.4 GB of an H100 and took 89 s
PHASE_C_SCALE = 0.1


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)
    print(f"  check passed: {what}", flush=True)


# ---------------------------------------------------------------------------
# corpus
# ---------------------------------------------------------------------------


def make_corpus(seed: int, scale: float):
    """(genome (G,) uint8, reads (n, READ_LEN) uint8), 2-bit codes."""
    rng = np.random.default_rng(seed)
    g = max(4 * READ_LEN, int(GENOME_LEN * scale))
    genome = rng.integers(0, 4, g, dtype=np.uint8)
    n = int(COVERAGE * g / READ_LEN)
    starts = rng.integers(0, g - READ_LEN + 1, n)
    reads = genome[starts[:, None] + np.arange(READ_LEN)]
    err = rng.integers(0, ERROR_IN, reads.shape, dtype=np.uint16) == 0
    reads[err] = (reads[err] + rng.integers(1, 4, int(err.sum()),
                                            dtype=np.uint8)) & 3
    flip = rng.random(n) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    return genome, reads


def write_fastq(path: str, reads: np.ndarray) -> None:
    n, ln = reads.shape
    rec = np.empty((n, 2 * ln + 7), np.uint8)
    rec[:, 0:3] = np.frombuffer(b"@r\n", np.uint8)
    rec[:, 3 : 3 + ln] = np.frombuffer(b"ACGT", np.uint8)[reads]
    rec[:, 3 + ln : 6 + ln] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 6 + ln : 6 + 2 * ln] = ord("I")
    rec[:, 6 + 2 * ln] = ord("\n")
    rec.tofile(path)


# ---------------------------------------------------------------------------
# NumPy reference (independent of the engine: k-mers as uint64)
# ---------------------------------------------------------------------------


def _rc64(v: np.ndarray, k: int) -> np.ndarray:
    from bench import numpy_rc

    return numpy_rc(v, k)


def _ext_rc(e: np.ndarray) -> np.ndarray:
    """Exts::rc on uint8 bytes: swap nibbles, complement each base bit."""
    e = ((e & 0x0F) << 4) | (e >> 4)
    e = ((e & 0x55) << 1) | ((e >> 1) & 0x55)
    return ((e & 0x33) << 2) | ((e >> 2) & 0x33)


def _canon(v: np.ndarray, k: int):
    r = _rc64(v, k)
    return np.minimum(v, r), r < v


def window_kmers(seq: np.ndarray, k: int) -> np.ndarray:
    """uint64 value of every k-window of a 1-D code array."""
    n = len(seq) - k + 1
    b = seq.astype(np.uint64)
    v = np.zeros(max(n, 0), np.uint64)
    for j in range(k):
        v = (v << np.uint64(2)) | b[j : j + n]
    return v


def reference_table(reads: np.ndarray, k: int, min_obs: int, rows=1 << 17):
    """Canonical k-mer table of fixed-length reads: (keys uint64 sorted,
    counts saturated at 65535, exts uint8), keeping count >= min_obs."""
    n, ln = reads.shape
    lk = ln - k + 1
    keys, exts = [], []
    for lo in range(0, n, rows):
        b = reads[lo : lo + rows]
        b64 = b.astype(np.uint64)
        v = np.zeros((len(b), lk), np.uint64)
        for j in range(k):
            v = (v << np.uint64(2)) | b64[:, j : j + lk]
        one = np.uint8(1)
        left = np.zeros((len(b), lk), np.uint8)
        left[:, 1:] = one << b[:, : lk - 1]
        right = np.zeros((len(b), lk), np.uint8)
        right[:, : lk - 1] = one << b[:, k:]
        e = left | (right << 4)
        c, flip = _canon(v.reshape(-1), k)
        e = e.reshape(-1)
        keys.append(c)
        exts.append(np.where(flip, _ext_rc(e), e))
    keys = np.concatenate(keys)
    exts = np.concatenate(exts)
    order = np.argsort(keys)
    keys, exts = keys[order], exts[order]
    start = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    counts = np.diff(np.r_[start, len(keys)])
    uexts = np.bitwise_or.reduceat(exts, start)
    keep = counts >= min_obs
    return (keys[start][keep], np.minimum(counts[keep], 65535),
            uexts[keep])


def reference_repair(keys: np.ndarray, exts: np.ndarray, k: int):
    """Global censored-extension repair (filter.rs:280-306): keep an
    extension bit only if its canonical target is in the table."""
    mask = np.uint64((1 << (2 * k)) - 1)
    out = np.zeros_like(exts)
    for b in range(4):
        bb = np.uint64(b)
        targets = {
            4 + b: ((keys << np.uint64(2)) | bb) & mask,  # right ext
            b: (keys >> np.uint64(2)) | (bb << np.uint64(2 * (k - 1))),
        }
        for bit, t in targets.items():
            t, _ = _canon(t, k)
            i = np.minimum(np.searchsorted(keys, t), len(keys) - 1)
            found = keys[i] == t
            has = (exts >> bit) & 1 == 1
            out |= np.where(has & found, np.uint8(1 << bit), 0).astype(np.uint8)
    return out


def table_keys(table) -> np.ndarray:
    """uint64 values of a KmerTable's limbs (k <= 32: two limbs)."""
    kk = np.asarray(table.kmers, np.uint32)
    return (kk[:, 0].astype(np.uint64) << np.uint64(32)) | kk[:, 1]


def check_table(table, ref) -> None:
    keys, counts, exts = ref
    got = table_keys(table)
    check(len(got) == len(keys),
          f"table holds {len(keys)} k-mers, as the NumPy reference")
    check(np.array_equal(got, keys), "table keys equal the reference")
    check(np.array_equal(np.asarray(table.counts), counts),
          "table counts (saturated at 65535) equal the reference")
    check(np.array_equal(np.asarray(table.exts), exts),
          "table exts equal the reference")


def check_unitigs(graph, keys: np.ndarray, k: int) -> None:
    seqs = graph.base.sequences
    flat = seqs._flat()
    starts = np.asarray(seqs.start, np.int64)
    lens = np.asarray(seqs.length, np.int64)
    v = window_kmers(flat, k)
    # windows that start inside one unitig and do not cross its end
    nwin = lens - k + 1
    first = np.repeat(starts, nwin)
    pos = np.arange(int(nwin.sum())) - np.repeat(np.cumsum(nwin) - nwin, nwin)
    got, _ = _canon(v[first + pos], k)
    got.sort()
    check(len(got) == len(keys) and np.array_equal(got, keys),
          f"every table k-mer appears exactly once across {len(lens)} unitigs")


def genome_coverage(graph, genome: np.ndarray, k: int) -> float:
    """Share of the genome covered by unitigs that are exact substrings of
    the genome or of its reverse complement."""
    g = len(genome)
    rcg = (3 - genome[::-1]).astype(np.uint8)
    idx = []
    for s in (genome, rcg):
        v = window_kmers(s, k)
        o = np.argsort(v)
        idx.append((v[o], o))
    seqs = graph.base.sequences
    flat = seqs._flat()
    starts = np.asarray(seqs.start, np.int64)
    lens = np.asarray(seqs.length, np.int64)
    head = window_kmers(flat, k)[starts]
    cov = np.zeros(g + 1, np.int64)
    for which, (sv, so) in enumerate(idx):
        i = np.minimum(np.searchsorted(sv, head), len(sv) - 1)
        hit = np.flatnonzero(sv[i] == head)
        src = genome if which == 0 else rcg
        for u in hit:
            p = int(so[i[u]])
            ln = int(lens[u])
            st = int(starts[u])
            if p + ln <= g and np.array_equal(src[p : p + ln], flat[st : st + ln]):
                lo, hi = (p, p + ln) if which == 0 else (g - p - ln, g - p)
                cov[lo] += 1
                cov[hi] -= 1
    return float((np.cumsum(cov[:g]) > 0).mean())


def canonical_nodes(graph):
    out = []
    for i in range(len(graph)):
        b = np.asarray(graph.base.sequences.get_bases(i), np.uint8)
        out.append(min(b.tobytes(), (3 - b[::-1]).astype(np.uint8).tobytes()))
    return sorted(out)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def timed_twice(name: str, fn):
    """Run ``fn`` twice; report set-up (first minus second) and run time.
    Returns the second result."""
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    out = fn()
    t2 = time.perf_counter()
    cold, warm = t1 - t0, t2 - t1
    print(f"{name}: set-up {cold - warm:.3f} s (first call {cold:.3f} s), "
          f"run {warm:.3f} s", flush=True)
    return out


def phase_a(fastq: str, gfa: str):
    from tpu_debruijn import compress as C, filter as F, io as IO
    from tpu_debruijn.graph import from_compress_output

    def run():
        # --- the README quick start, line for line ---
        reads = IO.read_fastq(fastq)
        table = F.filter_kmers([(r, 0, 0) for r in reads], k=31,
                               stranded=False, min_obs=2)
        nodes = C.compress_kmers(table)
        graph = from_compress_output(31, False, nodes).finish()
        graph.to_gfa(gfa)
        # --- end quick start ---
        return table, graph

    return timed_twice("phase A (README quick start)", run)


def phase_b(fastq: str, cap: int):
    from tpu_debruijn import compress as C, filter as F, io as IO
    from tpu_debruijn.graph import from_compress_output

    def run():
        table = F.filter_kmers_streaming(
            IO.stream_fastx_blocks(fastq, block_reads=1 << 18), 31,
            stranded=False, min_obs=2, merge="device", data_reduce="none",
            memory_gb=1.0, read_len_cap=READ_LEN,
            init_capacity=cap, unique_capacity=cap // 4,
        )
        graph = from_compress_output(31, False, C.compress_kmers(table)).finish()
        return table, graph

    return timed_twice("phase B (streaming count, device merge)", run)


def phase_gpu_tests() -> None:
    import pytest

    class Tally:
        passed = failed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.failed:
                self.failed += 1

    tally = Tally()
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests", "test_gpu.py")],
                     plugins=[tally])
    print(f"gpu tests: {tally.passed} passed, {tally.failed} failed, "
          f"{time.perf_counter() - t0:.3f} s (compiles included)", flush=True)
    check(rc == 0 and tally.passed > 0 and tally.failed == 0,
          "pytest -m gpu passed on the card")


def phase_c(reads: np.ndarray, n_cards: int) -> None:
    from tpu_debruijn import compress as C, filter as F
    from tpu_debruijn.graph import from_compress_output
    from tpu_debruijn.parallel import assemble_sharded, make_mesh

    mesh = make_mesh(n_cards)
    rows = list(reads)

    # censoring inert: every read twice, so every k-mer passes min_obs=2
    dup = rows + rows
    sharded = timed_twice(
        f"phase C inert: assemble_sharded on {n_cards} cards",
        lambda: assemble_sharded(dup, K, 8, stranded=False, min_obs=MIN_OBS,
                                 mesh=mesh, collective=True),
    )
    t0 = time.perf_counter()
    table = F.filter_kmers([(r, 0, 0) for r in dup], K, stranded=False,
                           min_obs=MIN_OBS)
    one = from_compress_output(K, False, C.compress_kmers(table)).finish()
    print(f"phase C inert: one-card filter_kmers + compress_kmers "
          f"{time.perf_counter() - t0:.3f} s (first call)", flush=True)
    cs, c1 = canonical_nodes(sharded), canonical_nodes(one)
    check(len(cs) > 0 and cs == c1,
          f"censoring inert: {n_cards}-card node set == one-card "
          f"({len(cs)} nodes)")

    # censoring active: the error k-mers seen once are censored
    t0 = time.perf_counter()
    g_n = assemble_sharded(rows, K, 8, stranded=False, min_obs=MIN_OBS,
                           mesh=mesh, collective=True)
    t1 = time.perf_counter()
    g_1 = assemble_sharded(rows, K, 8, stranded=False, min_obs=MIN_OBS,
                           mesh=make_mesh(1), collective=True)
    t2 = time.perf_counter()
    print(f"phase C active: {n_cards} cards {t1 - t0:.3f} s, one card "
          f"{t2 - t1:.3f} s (first calls)", flush=True)
    cn, c1 = canonical_nodes(g_n), canonical_nodes(g_1)
    check(len(cn) > 0 and cn == c1,
          f"censoring active: {n_cards}-card node set == one-card "
          f"({len(cn)} nodes)")


def compile_only(reads: np.ndarray, cap: int) -> None:
    """Compile the count, merge and compress programs at full size and
    print what each needs of device memory."""
    import jax
    import jax.numpy as jnp

    from tpu_debruijn import compress as C, filter as F
    from tpu_debruijn.kmer import KmerSpec

    spec = KmerSpec(K)

    def report(name, lowered):
        t0 = time.perf_counter()
        comp = lowered.compile()
        print(f"{name}: compiled in {time.perf_counter() - t0:.3f} s; "
              f"{comp.memory_analysis()}", flush=True)
        return comp

    bases, lengths = F.pad_reads(list(reads), min_len=K, pad_to=16)
    z = np.zeros(len(reads), np.int32)
    count = report("count (filter_kmers)", F._count_kmers_jit.lower(
        spec, False, MIN_OBS, "label_first", False, bases, lengths, z, z))
    dev = count(bases, lengths, z, z)
    n = int(dev.n_valid)
    ncap = 1 << max(10, (n - 1).bit_length())
    kmers = jax.ShapeDtypeStruct((ncap, spec.w), jnp.uint32)
    col = jax.ShapeDtypeStruct((ncap,), jnp.int32)
    report(f"compress ({n} k-mers, padded to {ncap})", C._compress_jit.lower(
        spec, False, False, kmers, col, jnp.int32(n), col))
    # streaming programs at phase B's shapes: chunk of 2^18 reads, 160 wide
    rows = 1 << 18
    out_cols = (cap // 4) // 256
    report("streaming count (count_kmers_blocks)",
           F._count_kmers_blocks_packed_jit.lower(
               spec, False, out_cols, 160,
               jax.ShapeDtypeStruct((rows, 40), jnp.uint8),
               jax.ShapeDtypeStruct((rows,), jnp.int32),
               jax.ShapeDtypeStruct((rows,), jnp.int32)))
    st_k = jax.ShapeDtypeStruct((cap, spec.w), jnp.uint32)
    st_p = jax.ShapeDtypeStruct((cap,), jnp.int32)
    ch_k = jax.ShapeDtypeStruct((256 * out_cols, spec.w), jnp.uint32)
    ch_p = jax.ShapeDtypeStruct((256 * out_cols,), jnp.int32)
    ok = jax.ShapeDtypeStruct((), jnp.bool_)
    report("streaming merge (dense)", F._merge_blocks_dense_jit.lower(
        spec, st_k, st_p, ch_k, ch_p, ok))
    report("streaming merge (block)", F._merge_blocks_jit.lower(
        spec, st_k, st_p, ch_k, ch_p, 128, ok))


def card_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exn:
        return f"nvidia-smi unavailable ({exn})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--corpus-scale", type=float, default=None,
                    help="genome length as a fraction of 4.6 Mb (reads "
                         f"follow); default 1, or {PHASE_C_SCALE} with "
                         "--four-cards")
    ap.add_argument("--out", default=os.path.join(REPO, "out", "smoke"),
                    help="directory for the FASTQ and GFA files")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only phase C: assemble_sharded on four cards")
    ap.add_argument("--compile-only", action="store_true",
                    help="compile at full size, print memory use, stop")
    ap.add_argument("--rehearse", action="store_true",
                    help="run the phases on any backend; the final device "
                         "check still fails off a GPU")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: no GPU (JAX's first device is {dev.platform})",
              file=sys.stderr)
        return 2
    n_cards = 4 if args.four_cards else 1
    if len(jax.devices()) < n_cards:
        print(f"chip_smoke: needs {n_cards} devices, JAX has "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2

    from tpu_debruijn import compile_cache
    from tpu_debruijn.io import native_available

    print(f"card: {card_line()}", flush=True)
    print(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind} "
          f"({dev.platform}); compile cache {compile_cache.configure()}",
          flush=True)
    print("host codec: " + ("native C++ built from native/debruijn_native.cpp"
                            if native_available() else "NumPy fallback"),
          flush=True)

    scale = args.corpus_scale
    if scale is None:
        scale = PHASE_C_SCALE if args.four_cards else 1.0
    t0 = time.perf_counter()
    genome, reads = make_corpus(args.seed, scale)
    n_obs = reads.shape[0] * (READ_LEN - K + 1)
    print(f"corpus: genome {len(genome)} bp, {reads.shape[0]} reads x "
          f"{READ_LEN} bp, {n_obs} k={K} observations, seed {args.seed}, "
          f"scale {scale} of the 4.6 Mb corpus "
          f"({time.perf_counter() - t0:.3f} s)",
          flush=True)
    # streaming state capacity: a power of two >= 2x the expected uniques
    # (genome k-mers + ~k per substitution error)
    uniques = len(genome) + reads.size // ERROR_IN * K
    cap = 1 << max(14, (2 * uniques - 1).bit_length())

    if args.compile_only:
        compile_only(reads, cap)
        return 3
    if args.four_cards:
        phase_c(reads, n_cards)
    else:
        os.makedirs(args.out, exist_ok=True)
        fastq = os.path.join(args.out, "reads.fq")
        gfa = os.path.join(args.out, "assembly.gfa")
        write_fastq(fastq, reads)

        table_a, graph_a = phase_a(fastq, gfa)
        t0 = time.perf_counter()
        ref = reference_table(reads, K, MIN_OBS)
        print(f"NumPy reference table: {len(ref[0])} k-mers "
              f"({time.perf_counter() - t0:.3f} s)", flush=True)
        check_table(table_a, ref)
        from tpu_debruijn import filter as F

        repaired = dataclasses.replace(table_a)
        F.remove_censored_exts(repaired)
        check(np.array_equal(np.asarray(repaired.exts),
                             reference_repair(ref[0], ref[2], K)),
              "exts after censored-extension repair equal the reference")
        check_unitigs(graph_a, ref[0], K)
        with open(gfa, "rb") as f:
            n_s = sum(1 for line in f if line.startswith(b"S\t"))
        check(n_s == len(graph_a), f"GFA holds {n_s} segments, one per unitig")
        cov = genome_coverage(graph_a, genome, K)
        check(cov >= 0.95, f"exact-substring unitigs cover {cov:.4%} of the "
                           f"genome (>= 95 %)")

        table_b, graph_b = phase_b(fastq, cap)
        check(all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in (
                  (table_b.kmers, table_a.kmers),
                  (table_b.counts, table_a.counts),
                  (table_b.exts, table_a.exts))),
              "streaming table equals phase A's table")
        check_unitigs(graph_b, ref[0], K)
        if dev.platform == "gpu":
            phase_gpu_tests()
        else:
            print("gpu tests: not run off a GPU", flush=True)

    if dev.platform != "gpu":
        print(f"chip_smoke: every phase passed, but on {dev.platform}, "
              f"not a GPU", file=sys.stderr)
        return 1
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
