"""SPMD MSP-bucket sharding over a device mesh (the "distributed" layer).

Equivalent of the reference's caller-side sharded workflow
(/root/reference/src/test.rs:418-504): msp_sequence per read -> bucket ->
per-bucket filter_kmers + compress -> BaseGraph::combine -> global
compress_graph.  Here the scatter is a real ``all_to_all`` collective over
the mesh and every per-shard phase is the jitted vector pipeline.

Because MSP guarantees that *all* occurrences of a kmer land in the same
bucket, per-shard counting gives exact global counts; only unitigs that
cross bucket boundaries need the final global stitch (dangling-extension
tolerance per filter.rs:241-243, graph.rs:235-236).
"""

from __future__ import annotations

import dataclasses
import logging
from functools import partial

log = logging.getLogger("tpu_debruijn.parallel")
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from tpu_debruijn import compress as C
from tpu_debruijn import exts as E
from tpu_debruijn import filter as F
from tpu_debruijn import kmer as KM
from tpu_debruijn import msp as M
from tpu_debruijn import sorting as S
from tpu_debruijn.filter import KmerTable
from tpu_debruijn.kmer import KmerSpec
from tpu_debruijn.parallel.mesh import SHARDS, make_mesh


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Static shapes/policies of one sharded run (closed over by jit)."""

    k: int
    p: int
    stranded: bool
    min_obs: int
    n_shards: int
    cap_per_dest: int  # interval slots per (src, dst) device pair

    @property
    def spec(self) -> KmerSpec:
        return KmerSpec(self.k)

    @property
    def interval_len(self) -> int:
        return 2 * self.k - self.p  # msp.rs:292 bound


def _scatter_intervals(plan: ShardPlan, bases, lengths, labels,
                       permutation=None):
    """Local MSP scan + all_to_all bucket exchange.

    ``permutation`` is an optional (4^p,) minimizer score table (e.g.
    msp.inverse_frequency_score_table) threaded into the scan — the
    reference's load-balancing permutation (msp.rs:57-59, :298-311).

    Returns received (sub_bases, sub_len, sub_exts, sub_labels) arrays of
    leading dim n_shards * cap_per_dest, plus the local overflow count
    (intervals dropped because a destination's slots filled up).
    """
    k, p, ns, cap_d = plan.k, plan.p, plan.n_shards, plan.cap_per_dest
    iv = M.msp_intervals_device(k, p, bases, lengths, permutation,
                                rc=not plan.stranded)
    sub = M.gather_interval_bases(k, p, bases, iv)  # (cap, 2k-p)
    cap = sub.shape[0]
    valid = jnp.arange(cap, dtype=jnp.int32) < iv["n_intervals"]
    dest = jnp.where(valid, iv["bucket"] % ns, ns)
    lab = jnp.asarray(labels, jnp.int32)[iv["read"]]

    # rank each interval within its destination group (stable, sort-based —
    # scales to any n_shards without unrolled loops)
    hist = jnp.zeros(ns + 1, jnp.int32).at[dest].add(1)
    offsets = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(hist)[:-1]])
    order = jnp.argsort(dest, stable=True)
    rank = jnp.zeros(cap, jnp.int32).at[order].set(jnp.arange(cap, dtype=jnp.int32))
    within = rank - offsets[dest]

    ok = valid & (within < cap_d)
    slot = jnp.where(ok, dest * cap_d + within, ns * cap_d)
    overflow = (valid & ~ok).sum().astype(jnp.int32)

    nslots = ns * cap_d
    send_sub = jnp.zeros((nslots, plan.interval_len), jnp.int32).at[slot].set(
        sub, mode="drop"
    )
    send_len = jnp.zeros(nslots, jnp.int32).at[slot].set(iv["length"], mode="drop")
    send_exts = jnp.zeros(nslots, jnp.int32).at[slot].set(iv["exts"], mode="drop")
    send_lab = jnp.zeros(nslots, jnp.int32).at[slot].set(lab, mode="drop")

    a2a = partial(
        jax.lax.all_to_all, axis_name=SHARDS, split_axis=0, concat_axis=0, tiled=True
    )
    return (
        a2a(send_sub),
        a2a(send_len),
        a2a(send_exts),
        a2a(send_lab),
        overflow,
    )


def sharded_count_step(plan: ShardPlan, data_reduce: str = "label_first",
                       stitch: bool = False, permutation=None):
    """Build the per-device step function (to be wrapped in shard_map).

    Returns fn(bases, lengths, labels) -> (KmerTableDev, chains, u_exts,
    contrib, overflow[, gchains, final_exts]): the complete sharded
    count+compress forward step; with ``stitch``, also the global
    boundary-stitch collective (replicated node-level chain labels +
    final unitig exts).
    """

    def step(bases, lengths, labels):
        sub, slen, sexts, slab, overflow = _scatter_intervals(
            plan, bases, lengths, labels, permutation
        )
        table = F.count_kmers(
            plan.spec,
            sub,
            slen,
            sexts,
            slab,
            stranded=plan.stranded,
            min_obs=plan.min_obs,
            data_reduce=data_reduce,
            report_all=plan.min_obs > 1,
        )
        if plan.min_obs > 1:
            # per-shard censored-ext repair BEFORE compression
            # (filter.rs:238-276): drop extensions whose target is in
            # this shard's census but censored; keep cross-shard
            # unknowns (the stitch's fix_exts resolves those globally).
            # Without this, same-shard censored exts would survive as
            # branch evidence into the per-shard compression.
            repaired = F.remove_censored_exts_device(
                plan.spec, plan.stranded, table.kmers, table.exts,
                table.n_valid, table.all_kmers, table.all_n,
            )
            table = dataclasses.replace(table, exts=repaired)
        chains, u_exts, contrib = C.compress_kmer_table_device(
            plan.spec, plan.stranded, table.kmers, table.exts, table.n_valid
        )
        out = (table, chains, u_exts, contrib, overflow)
        if stitch:
            gchains, final_exts = _global_stitch_device(
                plan, table.kmers, chains, u_exts
            )
            out = out + (gchains, final_exts)
        # leading singleton axis on every leaf so the out_specs concat
        # yields clean (n_shards, ...) per-shard stacks (the replicated
        # stitch outputs stack identically; hosts read row 0)
        return jax.tree.map(lambda x: x[None], out)

    return step


def _global_stitch_device(plan: ShardPlan, kmers, chains, u_exts):
    """The SURVEY §7.6 boundary-stitch collective.

    After per-shard kmer-level compression, allgather every shard's unitig
    end-kmer/end-exts/length table over the mesh and run ONE global
    node-level pointer-doubling round ON DEVICE — the designed replacement
    for the host-side BaseGraph.combine + compress_graph path (reference
    contract: compression.rs:291-349, filter.rs:238-276).  Runs inside
    shard_map; all outputs are replicated across shards.

    Returns (gchains, final_exts, final_first_item/flip lookup data) over
    the GLOBAL padded node index g = shard * cap + local_slot.
    """
    from tpu_debruijn.graph import _fix_exts_device, _node_partner_body

    spec = plan.spec
    n = kmers.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    valid_u = idx < chains.n_unitigs
    ff = chains.first_flip.astype(bool)[:, None]
    lf = chains.last_flip.astype(bool)[:, None]
    fk = jnp.where(ff, KM.rc(spec, kmers[chains.first_item]), kmers[chains.first_item])
    lk = jnp.where(lf, KM.rc(spec, kmers[chains.last_item]), kmers[chains.last_item])

    ag = partial(jax.lax.all_gather, axis_name=SHARDS, tiled=True)
    g_fk, g_lk, g_exts, g_len, g_valid = (
        ag(fk), ag(lk), ag(u_exts), ag(chains.length), ag(valid_u)
    )

    # global sorted end-kmer indexes (the DebruijnGraph finish step,
    # graph.rs:117-141, as one device sort over the padded gathered table)
    m = g_fk.shape[0]
    ids = jnp.arange(m, dtype=jnp.int32)
    inv = (~g_valid).astype(jnp.uint32)
    lkeys, (lk_ids,) = S.sort_with_payload([inv] + S.limbs_to_keys(g_fk), [ids])
    rkeys, (rk_ids,) = S.sort_with_payload([inv] + S.limbs_to_keys(g_lk), [ids])
    lk_sorted = S.keys_to_limbs(lkeys[1:])
    rk_sorted = S.keys_to_limbs(rkeys[1:])
    nv = g_valid.sum().astype(jnp.int32)

    # 1. fix_exts against the global node set: cross-shard dangling exts
    #    either resolve (target is another shard's unitig end) or drop
    fixed = _fix_exts_device(
        spec, plan.stranded, lk_sorted, lk_ids, rk_sorted, rk_ids,
        g_fk, g_lk, g_exts, g_valid, nv,
    )
    # 2. node-level partners + pointer doubling (try_extend_node rules)
    node_len = g_len + spec.k - 1
    gchains, gu_exts = _node_partner_body(
        spec, plan.stranded, False, lk_sorted, lk_ids, rk_sorted, rk_ids,
        g_fk, g_lk, fixed, node_len, g_valid, jnp.zeros(m, jnp.int32), nv,
    )
    # 3. final unitig end kmers -> final fix_exts(None) round entirely on
    #    device (compress_graph's closing fix_exts, compression.rs:332)
    fi, li = gchains.first_item, gchains.last_item
    ffl = gchains.first_flip.astype(bool)[:, None]
    lfl = gchains.last_flip.astype(bool)[:, None]
    final_fk = jnp.where(ffl, KM.rc(spec, g_lk[fi]), g_fk[fi])
    final_lk = jnp.where(lfl, KM.rc(spec, g_fk[li]), g_lk[li])
    final_valid = ids < gchains.n_unitigs
    finv = (~final_valid).astype(jnp.uint32)
    flkeys, (flk_ids,) = S.sort_with_payload(
        [finv] + S.limbs_to_keys(final_fk), [ids]
    )
    frkeys, (frk_ids,) = S.sort_with_payload(
        [finv] + S.limbs_to_keys(final_lk), [ids]
    )
    fnv = final_valid.sum().astype(jnp.int32)
    final_exts = _fix_exts_device(
        spec, plan.stranded,
        S.keys_to_limbs(flkeys[1:]), flk_ids,
        S.keys_to_limbs(frkeys[1:]), frk_ids,
        final_fk, final_lk, gu_exts, final_valid, fnv,
    )
    return gchains, final_exts


def _dest_histogram_fn(k: int, p: int, n_shards: int, stranded: bool, mesh,
                       permutation=None):
    """Cheap first pass for count-then-allocate buffer sizing (SURVEY §7
    hard part 4): per-device histogram of MSP intervals by destination.

    Returns fn(bases, lengths) -> (n_shards, n_shards) counts where
    row s, col d = intervals source device s will send to destination d.
    """

    def step(bases, lengths):
        iv = M.msp_intervals_device(k, p, bases, lengths, permutation,
                                    rc=not stranded)
        cap = iv["bucket"].shape[0]
        valid = jnp.arange(cap, dtype=jnp.int32) < iv["n_intervals"]
        dest = jnp.where(valid, iv["bucket"] % n_shards, n_shards)
        hist = jnp.zeros(n_shards + 1, jnp.int32).at[dest].add(1)
        return hist[None, :n_shards]

    return jax.jit(
        jax.shard_map(
            step,
            mesh=mesh,
            in_specs=(P(SHARDS), P(SHARDS)),
            out_specs=P(SHARDS),
            check_vma=False,
        )
    )


def _shard_map_fn(plan: ShardPlan, mesh, data_reduce: str = "label_first",
                  stitch: bool = False, permutation=None):
    step = sharded_count_step(plan, data_reduce, stitch, permutation)
    return jax.jit(
        jax.shard_map(
            step,
            mesh=mesh,
            in_specs=(P(SHARDS), P(SHARDS), P(SHARDS)),
            out_specs=P(SHARDS),
            # the sort/search primitives initialize loop carries from
            # constants; skip the varying-manual-axes consistency check
            check_vma=False,
        )
    )


def _pad_rows(bases, lengths, labels, n_shards):
    r = bases.shape[0]
    rpad = (-r) % n_shards
    if rpad:
        bases = np.pad(bases, ((0, rpad), (0, 0)))
        lengths = np.pad(lengths, (0, rpad))
        labels = np.pad(labels, (0, rpad))
    return bases, lengths, labels


def sharded_tables(
    reads: Sequence[np.ndarray],
    k: int,
    p: int,
    *,
    stranded: bool = False,
    min_obs: int = 1,
    mesh=None,
    labels: Optional[np.ndarray] = None,
    slack: Optional[float] = None,
    cap_per_dest: Optional[int] = None,
    data_reduce: str = "label_first",
    stitch: bool = False,
    permutation=None,
):
    """Run the device-sharded scan/exchange/count/compress step.

    ``permutation``: optional (4^p,) minimizer score table (see
    msp.inverse_frequency_score_table) applied in both the sizing
    histogram and the scan itself — balances bucket loads under skewed
    minimizer distributions (msp.rs:57-59, :298-311).

    Buffer sizing is count-then-allocate by default (SURVEY §7 hard part
    4): a cheap histogram pass counts intervals per (source, destination)
    pair and the exchange buffers are sized to the max, so skewed
    minimizer distributions never overflow.  Pass ``slack`` (the legacy
    worst-case fraction heuristic) or an explicit ``cap_per_dest`` to skip
    the extra pass.

    Returns (plan, stacked KmerTableDev, chains, u_exts, contrib) with a
    leading n_shards axis on every array.  With ``stitch``, two extra
    values: the replicated global node-level Chains and final unitig exts
    from the on-device boundary-stitch collective (leading axis is the
    per-shard replica stack; read row 0).
    """
    if mesh is None:
        mesh = make_mesh()
    n_shards = int(mesh.devices.size)
    items = [np.asarray(s, np.uint8) for s in reads if len(s) >= k]
    if not items:
        raise ValueError("no reads of length >= k")
    bases, lengths = F.pad_reads(items, min_len=k, pad_to=16)
    if labels is None:
        labels = np.zeros(len(items), np.int32)
    bases, lengths, labels = _pad_rows(bases, lengths, np.asarray(labels, np.int32), n_shards)

    r_loc = bases.shape[0] // n_shards
    cap = r_loc * (bases.shape[1] - k + 1)
    if cap_per_dest is None:
        if slack is not None:
            cap_per_dest = min(cap, max(16, int(np.ceil(cap * slack / n_shards))))
        else:
            hist_fn = _dest_histogram_fn(k, p, n_shards, stranded, mesh,
                                         None if permutation is None
                                         else jnp.asarray(permutation))
            hist = np.asarray(hist_fn(jnp.asarray(bases), jnp.asarray(lengths)))
            need = int(hist.max())
            # round up to a multiple of 128 so repeated runs with similar
            # skew reuse the compiled program (static shapes)
            cap_per_dest = min(cap, max(128, -(-need // 128) * 128))
    plan = ShardPlan(k, p, stranded, min_obs, n_shards, cap_per_dest)

    log.debug(
        "sharded_tables: %d reads over %d shards, cap_per_dest=%d",
        bases.shape[0], n_shards, cap_per_dest,
    )
    fn = _shard_map_fn(plan, mesh, data_reduce, stitch,
                       None if permutation is None
                       else jnp.asarray(permutation))
    out = fn(jnp.asarray(bases), jnp.asarray(lengths), jnp.asarray(labels))
    table, chains, u_exts, contrib, overflow = out[:5]
    total_overflow = int(np.asarray(overflow).sum())
    if total_overflow:
        raise RuntimeError(
            f"{total_overflow} MSP intervals overflowed their destination "
            f"buffers; re-run with a larger slack or explicit cap_per_dest"
        )
    if stitch:
        return (plan, table, chains, u_exts, contrib) + tuple(out[5:])
    return plan, table, chains, u_exts, contrib


def assemble_sharded(
    reads: Sequence[np.ndarray],
    k: int,
    p: int,
    *,
    stranded: bool = False,
    min_obs: int = 1,
    mesh=None,
    labels: Optional[np.ndarray] = None,
    slack: Optional[float] = None,
    cap_per_dest: Optional[int] = None,
    data_reduce_compress: str = "sum_sat_u16",
    collective: bool = True,
    permutation=None,
):
    """Full sharded assembly == test.rs:418-504 in one call.

    reads -> mesh-sharded MSP/count/compress -> boundary stitch -> final
    graph.  Returns the final DebruijnGraph; the result equals the
    unsharded pipeline on the same reads (the reference's N-shard ==
    1-shard oracle).

    With ``collective`` (the default), the shard-boundary stitch runs ON
    DEVICE inside the same shard_map step: allgather of shard unitig
    end-kmer tables + one global node-level pointer-doubling round
    (SURVEY §7.6; ref contract compression.rs:291-349).  The host only
    assembles sequence bytes from the returned chain labels — no per-node
    work and no host-side graph recompression.  ``collective=False``
    keeps the legacy host path (BaseGraph.combine + compress_graph).
    """
    from tpu_debruijn.graph import BaseGraph, compress_graph

    out = sharded_tables(
        reads,
        k,
        p,
        stranded=stranded,
        min_obs=min_obs,
        mesh=mesh,
        labels=labels,
        slack=slack,
        cap_per_dest=cap_per_dest,
        stitch=collective,
        permutation=permutation,
    )
    plan, table, chains, u_exts, contrib = out[:5]
    spec = plan.spec
    kmers = np.asarray(table.kmers)
    counts = np.asarray(table.counts)

    combined = BaseGraph(plan.k, stranded)
    nu = np.asarray(chains.n_unitigs)
    for s in range(plan.n_shards):
        combined.add_flat(
            *C.assemble_unitigs_flat(
                spec,
                kmers[s],
                np.asarray(chains.uid[s]),
                np.asarray(chains.pos[s]),
                np.asarray(chains.flip[s]),
                np.asarray(chains.length[s]),
                np.asarray(chains.first_item[s]),
                np.asarray(chains.first_flip[s]),
                int(nu[s]),
                np.asarray(u_exts[s]),
                np.asarray(contrib[s]),
                counts[s],
                data_reduce=data_reduce_compress,
            )
        )
    if not collective:
        return compress_graph(combined.finish(), data_reduce=data_reduce_compress)

    # device stitch already produced the global chain labels + final exts
    # (replicated across shards; row 0).  All that remains on the host is
    # flat sequence-byte assembly — vectorized, no per-node loop.
    gchains, final_exts = out[5], out[6]
    g_uid = np.asarray(gchains.uid)[0]
    g_pos = np.asarray(gchains.pos)[0]
    g_flip = np.asarray(gchains.flip)[0]
    g_n = int(np.asarray(gchains.n_unitigs)[0])
    f_exts = np.asarray(final_exts)[0]

    cap = kmers.shape[1]  # unitig slots per shard == kmer slots
    m = plan.n_shards * cap
    offsets = np.zeros(plan.n_shards, np.int64)
    offsets[1:] = np.cumsum(nu[:-1].astype(np.int64))
    gi = np.arange(m)
    live = g_uid >= 0
    node_ids = (offsets[gi[live] // cap] + gi[live] % cap).astype(np.int64)

    seqs = combined.sequences
    seq_flat, out_lengths = C.stitch_flat(
        plan.k, seqs._flat(), seqs.start, seqs.length,
        node_ids, g_uid[live], g_pos[live], g_flip[live], g_n,
    )
    if callable(data_reduce_compress):
        data_red = C._fold_closure(
            data_reduce_compress, combined.data[node_ids],
            g_uid[live], g_pos[live], g_n,
        )
    else:
        data_red = C._reduce_np(
            data_reduce_compress, combined.data[node_ids], g_uid[live], g_n
        )
    final = BaseGraph(plan.k, stranded)
    final.add_flat(seq_flat, out_lengths, f_exts[:g_n], data_red)
    return final.finish()
