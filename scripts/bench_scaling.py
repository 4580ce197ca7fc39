"""Weak-scaling benchmark of the sharded MSP pipeline over a device mesh.

Runs the full SPMD step (per-device MSP scan -> all_to_all bucket exchange
-> per-shard count/filter -> per-shard pointer-doubling compression) at a
fixed per-device workload while growing the mesh, and reports throughput
plus weak-scaling efficiency vs the 1-device run.

By default this exercises a *virtual CPU mesh*
(XLA_FORCE_HOST_PLATFORM_DEVICE_COUNT); with JAX_REAL=1 the same
shard_map program runs over the real devices, e.g. four GPUs joined by
NVLink (the collective pattern is identical; see parallel/shard.py).

Usage:
    python scripts/bench_scaling.py                # CPU mesh, 1/2/4/8
    JAX_REAL=1 python scripts/bench_scaling.py     # whatever jax.devices() has
"""

import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

if not os.environ.get("JAX_REAL"):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    cache = ".jax_cache_cpu"
else:
    import jax

    cache = ".jax_cache"
from tpu_debruijn import compile_cache

compile_cache.configure(cache)

import numpy as np
import jax.numpy as jnp

from tpu_debruijn.parallel.mesh import make_mesh
from tpu_debruijn.parallel.shard import ShardPlan, _shard_map_fn

K, P = 31, 8
READS_PER_DEV = int(os.environ.get("READS_PER_DEV", 256))
READ_LEN = 128


def run(n_dev: int):
    mesh = make_mesh(n_dev)
    r = READS_PER_DEV * n_dev
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, 20_000).astype(np.uint8)
    starts = rng.integers(0, len(genome) - READ_LEN, r)
    bases = genome[starts[:, None] + np.arange(READ_LEN)[None, :]]
    lengths = np.full(r, READ_LEN, np.int32)
    labels = np.zeros(r, np.int32)

    cap = READS_PER_DEV * (READ_LEN - K + 1)
    plan = ShardPlan(
        k=K, p=P, stranded=False, min_obs=1, n_shards=n_dev,
        cap_per_dest=min(cap, max(64, 2 * cap // n_dev)),
    )
    fn = _shard_map_fn(plan, mesh)
    args = (jnp.asarray(bases), jnp.asarray(lengths), jnp.asarray(labels))
    out = fn(*args)
    jax.block_until_ready(out)  # compile + warm
    # out[-1] is the per-device overflow count: intervals silently dropped
    # when a destination's cap_per_dest filled.  Any overflow would inflate
    # the reported throughput (we divide the nominal kmer count by time).
    dropped = int(np.asarray(out[-1]).sum())
    if dropped:
        raise RuntimeError(
            f"{dropped} MSP intervals overflowed cap_per_dest at n_dev={n_dev};"
            " raise the cap (lower READS_PER_DEV or increase slack)"
        )
    iters = 5
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    n_kmers = r * (READ_LEN - K + 1)
    return n_kmers / best, best


def main():
    n_avail = len(jax.devices())
    if jax.devices()[0].platform == "cpu":
        print(
            "# NOTE: virtual CPU mesh — all 'devices' share one host's cores,"
            "\n# so weak-scaling efficiency here measures correctness of the"
            "\n# SPMD program, not hardware scaling. Run on a real slice"
            "\n# (JAX_REAL=1) for meaningful efficiency numbers."
        )
    sizes = [n for n in (1, 2, 4, 8) if n <= n_avail]
    base_rate = None
    print(f"{'devs':>5} {'kmers/s':>14} {'s/step':>10} {'weak-eff':>9}")
    for n in sizes:
        rate, t = run(n)
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * n)
        print(f"{n:>5} {rate:>14.3e} {t:>10.5f} {eff:>8.1%}")


if __name__ == "__main__":
    main()
