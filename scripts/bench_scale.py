"""Scale demonstration: streaming counting of 100M+ kmers.

Streams >= 100M kmers (default: 1M synthetic 160bp reads, k=31) through
``filter_kmers_streaming`` under a ``memory_gb`` device bound, then
path-compresses the resulting table.  Records wall time, throughput, and
peak host RSS into out/scale_run.json.

Reads are generated on the fly from a multi-megabase genome (chunked
generator — the full read set is never materialized), which is exactly
the iterator contract the streaming API supports.

Run:  python scripts/bench_scale.py [--reads 1000000] [--genome 10000000]
      [--cpu] [--memory-gb 2]
"""

import argparse
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def read_stream(n_reads, read_len, genome, seed=0, batch=8192):
    rng = np.random.default_rng(seed)
    done = 0
    while done < n_reads:
        m = min(batch, n_reads - done)
        starts = rng.integers(0, len(genome) - read_len, m)
        idx = starts[:, None] + np.arange(read_len)[None, :]
        block = genome[idx]
        flip = rng.random(m) < 0.5
        block[flip] = (3 - block[flip, ::-1]).astype(np.uint8)
        # pre-batched 2-D block: filter_kmers_streaming's fast path —
        # no per-read Python staging
        yield (block, 0, 0)
        done += m


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--read-len", type=int, default=160)
    ap.add_argument("--genome", type=int, default=1_000_000,
                    help="sized so corpus uniques (~0.95M) sit at ~45% "
                         "of the default 2^21 block-gapped state, which "
                         "needs slack per 8192-slot block.  The STREAMED "
                         "volume stays 100M+ regardless")
    ap.add_argument("--block", type=int, default=8192,
                    help="reads per generated block (bounds the merge "
                         "program's size)")
    ap.add_argument("--k", type=int, default=31)
    ap.add_argument("--memory-gb", type=float, default=2.0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--min-obs", type=int, default=2)
    ap.add_argument("--repeat-rich", action="store_true",
                    help="tile the genome from a small chunk pool "
                         "(test.rs:98-132 analog): a branchy repeat graph "
                         "with >= 10^4 unitigs, so compression does real "
                         "work at scale")
    ap.add_argument("--fasta", default=None,
                    help="stream reads from this FASTA/FASTQ file via the "
                         "native batched scanner (io.stream_fastx_blocks) "
                         "instead of the synthetic generator")
    ap.add_argument("--write-fasta", action="store_true",
                    help="write the synthetic corpus to a FASTA first, "
                         "then stream THAT file through the native "
                         "scanner (end-to-end file ingestion at scale)")
    ap.add_argument("--merge", default="device", choices=["device", "host"],
                    help="device: table accumulates on-device, one final "
                         "transfer (the fast path); host: per-chunk table "
                         "pulls + LSM numpy merge")
    ap.add_argument("--init-capacity", type=int, default=1 << 21)
    ap.add_argument("--unique-capacity", type=int, default=1 << 20,
                    help="chunk-unique cap U: the device merge program is "
                         "C + U rows")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from tpu_debruijn import compile_cache

    compile_cache.configure(".jax_cache_cpu" if args.cpu else ".jax_cache")

    from tpu_debruijn import compress as C
    from tpu_debruijn import filter as F
    from tpu_debruijn.graph import from_flat_output

    k = args.k
    n_kmers = args.reads * (args.read_len - k + 1)
    rng = np.random.default_rng(7)
    if args.repeat_rich:
        pool = [rng.integers(0, 4, 300).astype(np.uint8) for _ in range(256)]
        parts = [pool[int(rng.integers(0, len(pool)))]
                 for _ in range(args.genome // 300 + 1)]
        genome = np.concatenate(parts)[: args.genome]
    else:
        genome = rng.integers(0, 4, args.genome).astype(np.uint8)

    if args.write_fasta and not args.fasta:
        from tpu_debruijn.bases import bases_to_str

        os.makedirs(os.path.join(repo, "out"), exist_ok=True)
        args.fasta = os.path.join(repo, "out", "scale_reads.fa")
        print(f"writing {args.reads} reads to {args.fasta}", flush=True)
        with open(args.fasta, "w") as f:
            for blk in read_stream(args.reads, args.read_len, genome,
                                   batch=args.block):
                for i, row in enumerate(blk[0]):
                    f.write(">r\n")
                    f.write(bases_to_str(row))
                    f.write("\n")

    def corpus_stream(n):
        if args.fasta:
            from tpu_debruijn.io import stream_fastx_blocks

            count = 0
            for pb in stream_fastx_blocks(args.fasta,
                                          block_reads=args.block):
                yield pb
                count += pb.packed.shape[0]
                if count >= n:
                    return
        else:
            yield from read_stream(n, args.read_len, genome,
                                   batch=args.block)

    # warm pass: 2 blocks through the same code path, compiling every
    # program (compiles are set-up, not throughput; production streams
    # amortize them)
    t0 = time.time()
    F.filter_kmers_streaming(
        corpus_stream(2 * args.block),
        k,
        stranded=False,
        min_obs=args.min_obs,
        read_len_cap=args.read_len,
        memory_gb=args.memory_gb,
        data_reduce="none" if args.merge == "device" else "label_first",
        merge=args.merge,
        init_capacity=args.init_capacity,
        unique_capacity=args.unique_capacity,
    )
    warm_s = time.time() - t0
    print(f"warm pass {warm_s:.1f}s", flush=True)

    t0 = time.time()
    table = F.filter_kmers_streaming(
        corpus_stream(args.reads),
        k,
        stranded=False,
        min_obs=args.min_obs,
        read_len_cap=args.read_len,
        memory_gb=args.memory_gb,
        data_reduce="none" if args.merge == "device" else "label_first",
        merge=args.merge,
        init_capacity=args.init_capacity,
        unique_capacity=args.unique_capacity,
    )
    t_count = time.time() - t0
    # repeat-rich runs keep their own artifact so the two scale shapes
    # (HBM-bound plain corpus, compression-heavy repeat corpus) coexist
    artifact = ("scale_run_repeat_rich.json" if args.repeat_rich
                else "scale_run.json")
    # partial artifact first: if the compress below fails, the counting
    # result survives
    os.makedirs(os.path.join(repo, "out"), exist_ok=True)
    with open(os.path.join(repo, "out", artifact), "w") as f:
        json.dump({
            "n_reads": args.reads, "read_len": args.read_len, "k": k,
            "n_kmers_streamed": n_kmers, "n_valid_kmers": len(table),
            "count_wall_s": round(t_count, 1), "merge": args.merge,
            "partial": "counting only; compress pending",
            "device": str(jax.devices()[0]),
        }, f, indent=1)
    print(f"counting done: {len(table)} kmers in {t_count:.1f}s "
          f"({n_kmers/t_count/1e6:.1f}M kmers/s)", flush=True)

    spec = table.spec

    # pad the table to a pow2 row count: a padded shape reuses the
    # persistent compile cache across runs.  Compression AND sequence
    # assembly run on device (compress_kmers_flat_device), so only
    # ~1 byte/base + O(n_unitigs) cross to the host instead of the
    # ~8 x n x 4B chain-label pull.
    n = len(table)
    cap = 1 << 13
    while cap < n:
        cap *= 2
    pk = np.zeros((cap, spec.w), np.uint32)
    pk[:n] = table.kmers
    pe = np.zeros(cap, np.int32)
    pe[:n] = table.exts
    pc = np.zeros(cap, np.int32)
    pc[:n] = table.counts
    import jax.numpy as jnp

    kdev = jnp.asarray(pk)
    edev = jnp.asarray(pe)
    counts_j = jnp.asarray(pc)

    def run_compress():
        chains, u_exts, contrib = C._compress_jit(
            spec, False, False, kdev, edev, jnp.int32(n),
            jnp.zeros(cap, jnp.int32),
        )
        base_cap = 1 << max(13, int(cap + spec.k).bit_length())
        while True:
            seq, total, out_len, data_sum, overflow = C._assemble_dev_jit(
                spec, kdev, chains, contrib, counts_j, base_cap
            )
            if not bool(overflow):
                break
            base_cap *= 2
        nutg = int(np.asarray(chains.n_unitigs))
        tot = int(total)
        nb = 256
        while nb < tot:
            nb *= 2
        nb = min(nb, base_cap)
        seq_np = np.asarray(seq[:nb])[:tot]
        ub = 256
        while ub < nutg:
            ub *= 2
        ub = min(ub, cap)
        return (
            seq_np,
            np.asarray(out_len[:ub])[:nutg].astype(np.int64),
            np.asarray(u_exts[:ub])[:nutg].astype(np.int32),
            np.asarray(data_sum[:ub])[:nutg].astype(np.int32),
        )

    # first call loads/compiles the compress + assembly executables (the
    # per-process cost the warm pass cannot reach, since cap depends on
    # the unique count); the second call is the steady-state time
    t0 = time.time()
    run_compress()
    t_compress_first = time.time() - t0
    t0 = time.time()
    flat = run_compress()
    g = from_flat_output(k, False, *flat)
    t_compress = time.time() - t0

    peak_rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    result = {
        "n_reads": args.reads,
        "repeat_rich": bool(args.repeat_rich),
        "fasta_input": args.fasta or None,
        "read_len": args.read_len,
        "k": k,
        "n_kmers_streamed": n_kmers,
        "n_valid_kmers": len(table),
        "n_unitigs": len(g),
        "memory_gb_bound": args.memory_gb,
        "count_wall_s": round(t_count, 1),
        "compress_wall_s": round(t_compress, 1),
        "kmers_per_s_end_to_end": round(n_kmers / (t_count + t_compress), 1),
        "peak_host_rss_gb": round(peak_rss_gb, 2),
        "host_budget_gb": 8.0,
        "rss_under_budget": bool(peak_rss_gb <= 8.0),
        "merge": args.merge,
        "warmup_s_excluded": round(warm_s, 1),
        "compress_first_call_s": round(t_compress_first, 1),
        "device": str(jax.devices()[0]),
    }
    with open(os.path.join(repo, "out", artifact), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
