"""Multi-host orchestration: the same MSP-bucket pipeline across hosts.

The single-host pipeline (shard.py) is already SPMD over a 1-D mesh; on
several hosts the identical program runs under ``jax.distributed`` —
the mesh spans every host's devices and the ``all_to_all`` bucket exchange
rides the intra-host interconnect (NVLink between GPUs) within a host and
the network across hosts.  Reads are fed
process-local (each host reads its own FASTQ chunk), which is exactly the
data-parallel input sharding the plan's ``in_specs=P(SHARDS)`` expects.

Exercised by tests/test_multihost.py: two real OS processes under
``jax.distributed.initialize`` (CPU backend, Gloo collectives) assemble a
split corpus and must produce the single-process result bit-for-bit.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import jax
import numpy as np

log = logging.getLogger("tpu_debruijn.multihost")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed bootstrap (no-op when single-process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def local_read_slice(paths: Sequence[str]) -> List[str]:
    """Partition input files round-robin over processes (host-local IO)."""
    pid = jax.process_index()
    n = jax.process_count()
    return [p for i, p in enumerate(paths) if i % n == pid]


def global_mesh():
    """1-D mesh over every device of every process, in process order (the
    shard axis crosses the network at host boundaries)."""
    from tpu_debruijn.parallel.mesh import SHARDS
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (SHARDS,))


def _replicate(tree, mesh):
    """Reshard a (possibly multi-process global) pytree to fully
    replicated, making every leaf addressable on every process."""
    import jax.numpy as jnp  # noqa: F401
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = NamedSharding(mesh, P())
    return jax.jit(lambda x: x, out_shardings=rep)(tree)


def assemble_multiprocess(
    local_reads: Sequence[np.ndarray],
    k: int,
    p: int,
    *,
    stranded: bool = False,
    min_obs: int = 1,
    mesh=None,
    cap_per_dest: Optional[int] = None,
    data_reduce_compress: str = "sum_sat_u16",
):
    """SPMD assembly across ``jax.distributed`` processes.

    Every process calls this with its OWN reads; the union is assembled
    over the global mesh (MSP scatter = all_to_all across all hosts,
    boundary stitch = the allgather collective) and the identical final
    DebruijnGraph is returned on every process.

    Works single-process too (degenerates to :func:`assemble_sharded`'s
    collective path with extra replication no-ops).
    """
    from jax.experimental import multihost_utils as MH
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpu_debruijn import compress as C
    from tpu_debruijn import filter as F
    from tpu_debruijn.graph import BaseGraph
    from tpu_debruijn.parallel.mesh import SHARDS
    from tpu_debruijn.parallel.shard import (
        ShardPlan, _dest_histogram_fn, _shard_map_fn,
    )

    if mesh is None:
        mesh = global_mesh()
    nproc = jax.process_count()
    ndev_local = jax.local_device_count()
    n_shards = int(mesh.devices.size)

    # --- agree on global static shapes across processes ------------------
    items = [np.asarray(r, np.uint8) for r in local_reads if len(r) >= k]
    lmax = max([len(r) for r in items] or [k])
    dims = MH.process_allgather(np.array([lmax, len(items)], np.int64))
    dims = dims.reshape(nproc, 2)
    L = -(-max(int(dims[:, 0].max()), k) // 16) * 16
    rows_local = -(-max(int(dims[:, 1].max()), 1) // ndev_local) * ndev_local

    bases = np.zeros((rows_local, L), np.uint8)
    lengths = np.zeros(rows_local, np.int32)
    labels = np.zeros(rows_local, np.int32)
    for i, r in enumerate(items):
        bases[i, : len(r)] = r
        lengths[i] = len(r)

    sh = NamedSharding(mesh, P(SHARDS))
    gshape = (rows_local * nproc, L)
    g_bases = jax.make_array_from_process_local_data(sh, bases, gshape)
    g_lengths = jax.make_array_from_process_local_data(sh, lengths, gshape[:1])
    g_labels = jax.make_array_from_process_local_data(sh, labels, gshape[:1])

    # --- count-then-allocate exchange sizing (replicated result) ---------
    r_loc = gshape[0] // n_shards
    cap = r_loc * (L - k + 1)

    def _hist_cap():
        hist_fn = _dest_histogram_fn(k, p, n_shards, stranded, mesh)
        hist = np.asarray(_replicate(hist_fn(g_bases, g_lengths), mesh))
        return min(cap, max(128, -(-int(hist.max()) // 128) * 128))

    user_cap = cap_per_dest
    if cap_per_dest is None:
        cap_per_dest = _hist_cap()

    # --- the SPMD step (scatter/count/compress/stitch collectives) -------
    # a user-supplied cap that overflows is retried ONCE with the exact
    # histogram size (matching the single-process count-then-allocate
    # default) before giving up
    for attempt in (0, 1):
        plan = ShardPlan(k, p, stranded, min_obs, n_shards, cap_per_dest)
        fn = _shard_map_fn(plan, mesh, stitch=True)
        out = fn(g_bases, g_lengths, g_labels)
        table, chains, u_exts, contrib, overflow, gchains, final_exts = out

        # --- bring every shard's outputs to every host --------------------
        (table, chains, u_exts, contrib, overflow, gchains, final_exts) = (
            jax.tree.map(
                np.asarray,
                _replicate(
                    (table, chains, u_exts, contrib, overflow, gchains,
                     final_exts),
                    mesh,
                ),
            )
        )
        if not int(overflow.sum()):
            break
        if attempt == 0 and user_cap is not None:
            log.warning(
                "assemble_multiprocess: %d MSP intervals overflowed "
                "cap_per_dest=%d; resizing via histogram and retrying",
                int(overflow.sum()), cap_per_dest,
            )
            cap_per_dest = _hist_cap()
            continue
        raise RuntimeError(
            f"{int(overflow.sum())} MSP intervals overflowed even at the "
            f"histogram-derived cap_per_dest={cap_per_dest}"
        )

    # --- identical deterministic host assembly on every process ----------
    spec = plan.spec
    nu = chains.n_unitigs
    combined = BaseGraph(plan.k, stranded)
    for s in range(plan.n_shards):
        combined.add_flat(
            *C.assemble_unitigs_flat(
                spec,
                table.kmers[s],
                chains.uid[s], chains.pos[s], chains.flip[s],
                chains.length[s], chains.first_item[s], chains.first_flip[s],
                int(nu[s]), u_exts[s], contrib[s], table.counts[s],
                data_reduce=data_reduce_compress,
            )
        )
    g_uid, g_pos, g_flip = gchains.uid[0], gchains.pos[0], gchains.flip[0]
    g_n = int(gchains.n_unitigs[0])
    f_exts = final_exts[0]

    capk = table.kmers.shape[1]
    m = plan.n_shards * capk
    offsets = np.zeros(plan.n_shards, np.int64)
    offsets[1:] = np.cumsum(nu[:-1].astype(np.int64))
    gi = np.arange(m)
    live = g_uid >= 0
    node_ids = (offsets[gi[live] // capk] + gi[live] % capk).astype(np.int64)
    seqs = combined.sequences
    seq_flat, out_lengths = C.stitch_flat(
        plan.k, seqs._flat(), seqs.start, seqs.length,
        node_ids, g_uid[live], g_pos[live], g_flip[live], g_n,
    )
    data_red = C._reduce_np(
        data_reduce_compress, combined.data[node_ids], g_uid[live], g_n
    )
    final = BaseGraph(plan.k, stranded)
    final.add_flat(seq_flat, out_lengths, f_exts[:g_n], data_red)
    return final.finish()


def assemble_multihost(paths: Sequence[str], k: int, p: int, **kwargs):
    """Read this host's file slice and run the sharded assembly over the
    global mesh.  Each process must call this with the same arguments."""
    from tpu_debruijn.io import read_fastx

    reads: List[np.ndarray] = []
    for path in local_read_slice(paths):
        reads.extend(read_fastx(path))
    return assemble_multiprocess(reads, k, p, **kwargs)
