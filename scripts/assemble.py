"""End-to-end assembly driver: FASTA/FASTQ -> unitig GFA.

Usage:

    python scripts/assemble.py reads.fq[.gz] -o out.gfa \
        [-k 31] [--min-obs 2] [--stranded] [--clean-tips] [--json out.json]

This is the canonical-workflow driver (lib.rs:9-14): read sequences,
filter_kmers, compress to unitigs, optionally clean tips, export.
The reference ships no CLI (it is a library); this script is the usage
example for ours.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("reads", help="FASTA/FASTQ path (.gz ok)")
    ap.add_argument("-o", "--gfa", required=True, help="output GFA path")
    ap.add_argument("-k", type=int, default=31)
    ap.add_argument("--min-obs", type=int, default=2)
    ap.add_argument("--stranded", action="store_true")
    ap.add_argument("--clean-tips", action="store_true",
                    help="remove tips shorter than 2K and re-compress")
    ap.add_argument("--json", help="also write node/link JSON here")
    ap.add_argument("--max-records", type=int, default=None)
    ap.add_argument("--sharded", action="store_true",
                    help="MSP-shard over all devices of the mesh "
                         "(all_to_all exchange + on-device boundary stitch)")
    ap.add_argument("-p", type=int, default=8,
                    help="minimizer length for --sharded (default 8)")
    ap.add_argument("--streaming", action="store_true",
                    help="memory-bounded streaming counting (filter.rs:151-183)")
    ap.add_argument("--memory-gb", type=float, default=4.0,
                    help="device working-set bound for --streaming")
    args = ap.parse_args()

    from tpu_debruijn import compile_cache

    compile_cache.configure()
    from tpu_debruijn import compress as C
    from tpu_debruijn import filter as F
    from tpu_debruijn import io as IO
    from tpu_debruijn.clean import clean_tips
    from tpu_debruijn.graph import from_compress_output

    reads = IO.read_fastx(args.reads, max_records=args.max_records)
    reads = [r for r in reads if len(r) >= args.k]
    if not reads:
        print("no reads of length >= K", file=sys.stderr)
        return 1
    n_bases = sum(len(r) for r in reads)
    print(f"{len(reads)} reads, {n_bases} bases", file=sys.stderr)

    if args.sharded:
        from tpu_debruijn.parallel import assemble_sharded, make_mesh

        mesh = make_mesh()
        print(f"sharding over {mesh.devices.size} devices", file=sys.stderr)
        graph = assemble_sharded(
            reads, args.k, args.p,
            stranded=args.stranded, min_obs=args.min_obs, mesh=mesh,
        )
    else:
        if args.streaming:
            maxlen = max(len(r) for r in reads)
            table = F.filter_kmers_streaming(
                ((r, 0, 0) for r in reads), args.k,
                stranded=args.stranded, min_obs=args.min_obs,
                read_len_cap=maxlen, memory_gb=args.memory_gb,
            )
        else:
            table = F.filter_kmers(
                [(r, 0, 0) for r in reads], args.k,
                stranded=args.stranded, min_obs=args.min_obs,
            )
        print(f"{len(table)} filtered kmers", file=sys.stderr)
        nodes = C.compress_kmers(table)
        graph = from_compress_output(args.k, args.stranded, nodes).finish()
    if args.clean_tips:
        graph = clean_tips(graph, lambda node: node.len() < 2 * args.k)
    print(f"{len(graph)} unitigs", file=sys.stderr)

    graph.to_gfa(args.gfa)
    if args.json:
        with open(args.json, "w") as f:
            graph.to_json(lambda d: d, f)
    lens = np.array([graph.get_node(i).len() for i in range(len(graph))])
    if len(lens):
        srt = np.sort(lens)[::-1]
        half = lens.sum() / 2
        n50 = int(srt[np.cumsum(srt) >= half][0]) if len(srt) else 0
        print(
            f"total {int(lens.sum())}bp, max {int(lens.max())}bp, N50 {n50}bp",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
