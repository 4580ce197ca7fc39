"""Colored (multi-sample) assembly throughput on the live backend.

The colored pipeline runs through the DEVICE streaming merge — (kmer, label) pairs ride the block
count/merge programs as one extra sort key — and the per-unitig color
union folds on device (compress._fold_pairs_device).  The r4 path
(filter_kmers_set_arrays + host np.unique fold) is the slower one;
this path streams pre-batched read blocks and keeps the pair table
device-resident until one final pull.

Two configs: ~1.05M obs (out/colored_run.json) and a 10M+ obs scale run
(--scale, out/colored_scale_run.json).  Wall times EXCLUDE compile (one
warm-up pass on a small prefix) but include all host staging and
host-device transfers.

Run: python scripts/bench_colored.py [--cpu] [--scale]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build_corpus(rng, samples, reads_per_sample, L):
    core = rng.integers(0, 4, 60_000).astype(np.uint8)
    blocks = []
    for s in range(samples):
        flank_l = rng.integers(0, 4, 20_000).astype(np.uint8)
        flank_r = rng.integers(0, 4, 20_000).astype(np.uint8)
        g = np.concatenate([flank_l, core, flank_r])
        starts = rng.integers(0, len(g) - L, reads_per_sample)
        b = g[starts[:, None] + np.arange(L)[None, :]]
        flip = rng.random(reads_per_sample) < 0.5
        b[flip] = (3 - b[flip, ::-1]).astype(np.uint8)
        blocks.append(b)
    return blocks


def run(blocks, k, L, min_obs, chunk_reads):
    from tpu_debruijn import filter as F

    stream = [
        (b, 0, s) for s, b in enumerate(blocks)
    ]  # pre-batched block items: (bases (m, L), seq_exts, label)
    return F.filter_kmers_streaming(
        iter(stream), k, stranded=False, min_obs=min_obs,
        merge="device", colored=True, data_reduce="none",
        chunk_reads=chunk_reads, init_capacity=1 << 19,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads-per-sample", type=int, default=2700)
    ap.add_argument("--read-len", type=int, default=160)
    ap.add_argument("--samples", type=int, default=3)
    ap.add_argument("--k", type=int, default=31)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--scale", action="store_true",
                    help="10M+ obs scale artifact (colored_scale_run.json)")
    args = ap.parse_args()
    if args.scale:
        # multiple of the 8192-read chunk: a remainder chunk would run a
        # fresh (pow2-rounded) program shape the warm-up never reaches,
        # putting a compile inside the timed region
        args.reads_per_sample = 32768

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from tpu_debruijn import compile_cache

    compile_cache.configure(".jax_cache_cpu" if args.cpu else ".jax_cache")

    from tpu_debruijn import compress as C
    from tpu_debruijn.graph import from_compress_output

    rng = np.random.default_rng(11)
    blocks = build_corpus(rng, args.samples, args.reads_per_sample,
                          args.read_len)
    n_reads = args.samples * args.reads_per_sample
    n_obs = n_reads * (args.read_len - args.k + 1)
    chunk_reads = 8192

    # warm-up: compile every program shape on a small prefix
    warm = [b[: min(chunk_reads, len(b))] for b in blocks]
    run(warm, args.k, args.read_len, 2, chunk_reads)
    _pre = [b[: min(256, len(b))] for b in blocks]
    tb, plb, spb = run(_pre, args.k, args.read_len, 2, chunk_reads)
    if len(tb):
        C.compress_kmers_color_sets(tb, plb, spb)

    t0 = time.time()
    table, pair_label, split = run(blocks, args.k, args.read_len, 2,
                                   chunk_reads)
    t_filter = time.time() - t0

    # the tiny-prefix warm-up cannot reach the real table's padded
    # shapes, so the first compress call carries their compiles; time
    # the steady state (second call), exactly
    # like bench_scale does, and record the first-call cost separately
    t0 = time.time()
    C.compress_kmers_color_sets(table, pair_label, split)
    t_compress_first = time.time() - t0
    t0 = time.time()
    nodes, out_labels, out_split = C.compress_kmers_color_sets(
        table, pair_label, split
    )
    t_compress = time.time() - t0

    graph = from_compress_output(args.k, False, [
        (s, e, 0) for s, e, _ in nodes
    ]).finish()

    set_sizes = np.diff(out_split)
    from collections import Counter

    dist = Counter(
        tuple(int(x) for x in out_labels[out_split[u] : out_split[u + 1]])
        for u in range(len(nodes))
    )
    result = {
        "device": str(jax.devices()[0]),
        "pipeline": "colored streaming device merge (r5) + device pair fold",
        "samples": args.samples,
        "n_reads": n_reads,
        "n_kmer_obs": n_obs,
        "n_valid_kmers": len(table),
        "n_color_pairs": len(pair_label),
        "n_unitigs": len(nodes),
        "n_graph_nodes": len(graph),
        "filter_wall_s": round(t_filter, 2),
        "compress_wall_s": round(t_compress, 2),
        "compress_first_call_s": round(t_compress_first, 2),
        "obs_per_s": round(n_obs / (t_filter + t_compress), 1),
        "unitig_color_set_histogram": {
            str(kset): cnt
            for kset, cnt in sorted(dist.items())[:20]
        },
        "mean_colors_per_unitig": round(float(set_sizes.mean()), 2)
        if len(set_sizes)
        else 0,
    }
    print(json.dumps(result, indent=1))
    name = "colored_scale_run.json" if args.scale else "colored_run.json"
    os.makedirs(os.path.join(repo, "out"), exist_ok=True)
    with open(os.path.join(repo, "out", name), "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
