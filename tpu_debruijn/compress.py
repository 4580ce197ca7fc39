"""Path compression: kmer table -> unitig graph, via pointer doubling (L4).

Reference: CompressFromHash (src/compression.rs:355-615).
The reference walks each unbranched path sequentially with a hash lookup
per step.  Here the same result is computed in O(log n) data-parallel
rounds:

1. **Edge resolution** (``resolve_edges``): for every kmer and direction,
   apply the reference's merge conditions (compression.rs:382-444) as
   vector masks — unique extension, target present, no palindromes in
   unstranded mode (compression.rs:386,403), unique incoming extension at
   the target (compression.rs:422,435), and the CompressionSpec join_test
   (compression.rs:426).  Targets are found by vectorized binary search
   over the sorted kmer array (replacing BoomHashMap2::get_key_id).
2. **Chain linking** (``link_chains``): each kmer becomes a node with at
   most one partner per side; unitigs are the connected chains.  A
   directed successor function over 2n (kmer, orientation) states is
   pointer-doubled to label every kmer with its unitig id, position, and
   orientation.  Cycles ("smooth circles", graph.rs:319-321) are cut at
   the minimum-index kmer exactly where the reference's seed loop
   (compression.rs:574) would break them.
3. **Emission**: of the two mirror traversals of each chain, the one where
   the minimum-index kmer has its stored orientation is emitted — the same
   orientation the reference produces when that kmer is the seed
   (compression.rs:483-541).  Unitig ids are assigned in increasing
   min-kmer order, matching a sequential seed scan in sorted-kmer order.

Per-kmer data is folded per-unitig with segmented reductions; this
requires the CompressionSpec.reduce to be associative + commutative
(true of every spec the reference ships or tests).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from functools import partial
from typing import Optional

log = logging.getLogger("tpu_debruijn.compress")

import jax
import jax.numpy as jnp
import numpy as np

from tpu_debruijn import exts as E
from tpu_debruijn import kmer as KM
from tpu_debruijn import sorting as S
from tpu_debruijn.kmer import KmerSpec

LEFT, RIGHT = E.LEFT, E.RIGHT


def resolve_edges(
    spec: KmerSpec,
    stranded: bool,
    kmers,
    exts,
    n_valid,
    join_labels=None,
    return_candidates: bool = False,
):
    """Per-kmer merge partners for both directions.

    Returns dict with, for d in {L, R}:
      partner_d: (n,) int32 target index or -1
      in_d:      (n,) int32 stored side of the target the edge enters (0/1)

    With ``return_candidates``, the PRE-mutuality candidate edges are
    returned instead (every reference merge condition applied except the
    CompressionSpec join_test and the reverse-edge mutuality pass) — the
    hook for arbitrary host-evaluated join_test predicates
    (:func:`compress_kmers_rich`).
    """
    n = kmers.shape[0]
    idx_self = jnp.arange(n, dtype=jnp.int32)
    valid = idx_self < n_valid

    if not stranded:
        pal_self = KM.is_palindrome(spec, kmers)
    else:
        pal_self = jnp.zeros(n, bool)

    # candidate target kmers for BOTH directions, resolved by one batched
    # sort-join (2n queries against the n-row table) instead of per-query
    # binary search; the join also returns the target's exts byte so no
    # post-join gather is needed (compression.rs:410-422 semantics)
    cands = []
    meta = {}
    for d in (LEFT, RIGHT):
        uniq, base = E.unique_extension(exts, d)
        cand = (
            KM.extend_left(spec, kmers, base.astype(jnp.uint32))
            if d == LEFT
            else KM.extend_right(spec, kmers, base.astype(jnp.uint32))
        )
        if not stranded:
            cand, flip = KM.min_rc_flip(spec, cand)
            pal_next = KM.is_palindrome(spec, cand)
        else:
            flip = jnp.zeros(n, bool)
            pal_next = jnp.zeros(n, bool)
        cands.append(cand)
        meta[d] = (uniq, flip, pal_next)

    queries = jnp.concatenate(cands, axis=0)  # (2n, W)
    jj, ffound, jexts = S.sort_join_limbs(kmers, n_valid, queries, exts)

    partners = {}
    ins = {}
    for d in (LEFT, RIGHT):
        uniq, flip, pal_next = meta[d]
        j = jj[d * n : (d + 1) * n]
        found = ffound[d * n : (d + 1) * n]
        texts = jexts[d * n : (d + 1) * n]
        j = jnp.where(found, j, -1)
        jc = jnp.clip(j, 0, n - 1)

        # side of the target the edge comes in on (compression.rs:419)
        in_d = jnp.where(flip, d, 1 - d).astype(jnp.int32)
        incoming_cnt = E.num_ext_dir(texts, in_d)

        ok = (
            valid
            & uniq
            & found
            & (j != idx_self)
            & ~pal_self
            & ~pal_next
            & (incoming_cnt == 1)
        )
        if join_labels is not None:
            ok = ok & (join_labels[idx_self] == join_labels[jc])
        partners[d] = jnp.where(ok, j, -1)
        ins[d] = in_d

    if return_candidates:
        return {
            "partner_l": partners[LEFT],
            "in_l": ins[LEFT],
            "partner_r": partners[RIGHT],
            "in_r": ins[RIGHT],
        }
    return _enforce_mutual(partners, ins)


def _enforce_mutual(partners, ins):
    """Keep only edges whose reverse half-edge points back (the
    incoming-unique symmetry of compression.rs:422-435); one (n, 2) row
    gather covers both directions."""
    n = partners[LEFT].shape[0]
    idx_self = jnp.arange(n, dtype=jnp.int32)
    pmat = jnp.stack([partners[LEFT], partners[RIGHT]], axis=1)
    out = {}
    for d in (LEFT, RIGHT):
        j = partners[d]
        jc = jnp.clip(j, 0, n - 1)
        rp = pmat[jc]  # (n, 2)
        rev = jnp.where(ins[d] == LEFT, rp[:, 0], rp[:, 1])
        ok = (j >= 0) & (rev == idx_self)
        out[d] = (jnp.where(ok, j, -1), ins[d])
    return {
        "partner_l": out[LEFT][0],
        "in_l": out[LEFT][1],
        "partner_r": out[RIGHT][0],
        "in_r": out[RIGHT][1],
    }


@dataclasses.dataclass
class Chains:
    """Result of chain linking over n items (kmers or graph nodes)."""

    uid: jnp.ndarray  # (n,) unitig id per item, -1 for invalid/padding
    pos: jnp.ndarray  # (n,) position within unitig (0-based from left)
    flip: jnp.ndarray  # (n,) bool: item is reverse-complemented in unitig
    n_unitigs: jnp.ndarray  # ()
    length: jnp.ndarray  # (n,) unitig length in items (slot u valid < n_unitigs)
    first_item: jnp.ndarray  # (n,) item index at position 0 of unitig u
    last_item: jnp.ndarray  # (n,) item index at last position of unitig u
    first_flip: jnp.ndarray  # (n,) orientation of first item
    last_flip: jnp.ndarray  # (n,) orientation of last item


jax.tree_util.register_dataclass(
    Chains,
    data_fields=[
        "uid",
        "pos",
        "flip",
        "n_unitigs",
        "length",
        "first_item",
        "last_item",
        "first_flip",
        "last_flip",
    ],
    meta_fields=[],
)


def _succ_states(partner_l, partner_r, in_l, in_r, valid):
    """Directed successor over 2n (item, orientation) walker states.

    State 2i+o = item i, orientation o (0 stored / 1 flipped), moving
    "right" along the unitig.  Exit side in stored frame is R for o=0,
    L for o=1; the entered side of the target determines its orientation.
    """
    n = partner_l.shape[0]

    def one(dir_partner, dir_in):
        j = dir_partner
        oj = jnp.where(dir_in == LEFT, 0, 1)
        return jnp.where(j >= 0, 2 * j + oj, -1)

    succ0 = one(partner_r, in_r)  # o=0 exits stored R
    succ1 = one(partner_l, in_l)  # o=1 exits stored L
    succ = jnp.stack([succ0, succ1], axis=1).reshape(2 * n)
    svalid = jnp.repeat(valid, 2)
    return jnp.where(svalid, succ, -1)


def _rank_all(succ, mnmo, dist0=None, end0=None):
    """Pointer-doubling list ranking: (succ_final, dist_to_end, mnmo_min,
    end_state) per state, in one while_loop.

    ``dist0``/``end0`` override the per-state initial edge weight and
    terminal id — the contracted ranking (:func:`link_chains_ordered`)
    seeds them with per-run lengths and exit states; default None gives
    the unweighted behavior (dist0 = 1 per live edge, end0 = own index
    at terminals).

    Random gathers are the cost here, assumed to be paid per index
    rather than per byte (untested on the GPU, see ROADMAP), so the
    whole carry is packed into ONE (m, 4) int32 matrix and each round
    does a single row gather instead of four scalar gathers.  The loop
    exits as soon as every pointer resolves (acyclic input:
    O(log max_chain) rounds); with cycles present it runs the full
    log2(m) rounds, by which point the min aggregate has swept every
    cycle (window 2^t >= m >= cycle length).

    For cycle states dist/end are garbage (unbounded doubling / never
    resolved) — callers must detect them via succ_final >= 0 and re-rank
    on the cut graph.
    """
    m = succ.shape[0]
    max_steps = max(1, math.ceil(math.log2(m + 1)))
    if dist0 is None:
        dist0 = jnp.where(succ >= 0, 1, 0).astype(jnp.int32)
    if end0 is None:
        end0 = jnp.where(succ == -1, jnp.arange(m, dtype=jnp.int32), -1)
    x0 = jnp.stack([succ, dist0, mnmo, end0], axis=1)

    # the convergence flag is computed in the BODY and carried as a
    # scalar, so the cond never reduces over the loop-carried table (a
    # layout hazard for the row gather; untested on the GPU, see ROADMAP)
    def cond(carry):
        _, t, active = carry
        return active & (t < max_steps)

    def body(carry):
        x, t, _ = carry
        succ = x[:, 0]
        sc = jnp.clip(succ, 0, m - 1)
        g = x[sc]  # ONE row gather for all four aggregates
        has = succ >= 0
        succ_new = jnp.where(has, g[:, 0], succ)
        dist_new = x[:, 1] + jnp.where(has, g[:, 1], 0)
        mn_new = jnp.where(has, jnp.minimum(x[:, 2], g[:, 2]), x[:, 2])
        end_new = jnp.where(has, g[:, 3], x[:, 3])
        return (
            jnp.stack([succ_new, dist_new, mn_new, end_new], axis=1),
            t + 1,
            jnp.any(succ_new >= 0),
        )

    x, _, _ = jax.lax.while_loop(cond, body, (x0, 0, jnp.bool_(True)))
    return x[:, 0], x[:, 1], x[:, 2], x[:, 3]


def link_chains(partner_l, partner_r, in_l, in_r, valid) -> Chains:
    """Label each item with (unitig id, position, orientation).

    See module docstring.  ``valid`` masks live items; invalid items get
    uid -1.

    Precondition: partner edges must be strictly MUTUAL and entry-side
    consistent — if ``partner_d[i] == j`` then the partner array of j for
    the side ``in_d[i]`` must point back at i.  Chain starts are derived
    purely from ``partner < 0`` (no in-degree scatter), which is only
    correct under mutuality; both callers (:func:`resolve_edges`,
    graph._node_partner_body) enforce it with a rev == idx_self pass.
    Non-mutual input would silently emit wrong unitigs.
    """
    n = partner_l.shape[0]
    m = 2 * n
    node = jnp.repeat(jnp.arange(n, dtype=jnp.int32), 2)
    orient = jnp.tile(jnp.arange(2, dtype=jnp.int32), n)

    succ0 = _succ_states(partner_l, partner_r, in_l, in_r, valid)
    mnmo0 = (node << 1) | orient  # packed (min-node, orient): one lane
    # carries both aggregates; within a chain node ids are unique, so
    # packed min == (min node, orient at that node)

    # --- single merged ranking pass; path states resolve fully, cycle
    # states are detected afterwards by their unresolved pointer
    succ_f, dist, mnmo, end_id = _rank_all(succ0, mnmo0)
    is_cycle = succ_f >= 0

    # --- cycles (rare): cut like the reference's seed loop would (cycle
    # consumed into one path ending at the min node in stored orientation,
    # compression.rs:450-479) and re-rank — only executed when a cycle
    # exists (lax.cond), so acyclic graphs pay exactly one doubling loop
    mn_f = mnmo >> 1  # for cycle states: cycle-wide min (full sweep)
    cut_exit = is_cycle & (node == mn_f) & (orient == 0)
    # mirror edge: the state whose successor is (min node, orient 1)
    target_is_min_flipped = is_cycle & (succ0 == 2 * mn_f + 1)

    cut_mask = cut_exit | target_is_min_flipped

    def rerank_with_cuts(_):
        succ_cut = jnp.where(cut_mask, -1, succ0)
        _, d, mm, e = _rank_all(succ_cut, mnmo0)
        # states a cut edge pointed INTO become chain starts
        extra = jnp.zeros(m, bool).at[
            jnp.where(cut_mask, jnp.clip(succ0, 0, m - 1), m)
        ].set(True, mode="drop")
        return d, mm, e, extra

    dist, mnmo, end_id, extra_starts = jax.lax.cond(
        jnp.any(is_cycle),
        rerank_with_cuts,
        lambda _: (dist, mnmo, end_id, jnp.zeros(m, bool)),
        None,
    )
    succ = jnp.where(cut_mask, -1, succ0)
    mn = mnmo >> 1
    mo = mnmo & 1

    # chain starts: a state has no predecessor iff its ENTRY-side partner
    # is absent — mutual edges make this purely elementwise (no in-degree
    # scatter): state (i, 0) is entered via stored LEFT, (i, 1) via RIGHT.
    # Cut cycle edges add their former targets as starts (extra_starts).
    no_pred = jnp.stack([partner_l < 0, partner_r < 0], axis=1).reshape(m)
    is_start = (no_pred | extra_starts) & jnp.repeat(valid, 2)

    (n_unitigs, length_u, first_item, first_flip, last_item, last_flip,
     uid_state, pos_state) = _emit_chains(
        n, node, orient, dist, mnmo, end_id, is_start,
        node_of_end=lambda e: e >> 1,
    )

    emitted = uid_state >= 0
    # per-item results: each item has exactly one emitted state
    emit_pair = emitted.reshape(n, 2)
    pick = jnp.where(emit_pair[:, 0], 0, 1)  # which orientation is emitted
    pick_b = emit_pair[:, 0]
    take = lambda a: jnp.where(pick_b, a.reshape(n, 2)[:, 0], a.reshape(n, 2)[:, 1])
    uid = jnp.where(valid & (emit_pair[:, 0] | emit_pair[:, 1]), take(uid_state), -1)
    pos = take(pos_state)
    flip = pick.astype(bool)

    return Chains(
        uid=uid,
        pos=pos,
        flip=flip,
        n_unitigs=n_unitigs,
        length=length_u,
        first_item=first_item,
        last_item=last_item,
        first_flip=first_flip,
        last_flip=last_flip,
    )


def _emit_chains(n, node, orient, dist, mnmo, end_id, is_start, node_of_end):
    """Shared emission tail of the chain linkers: keep the traversal where
    the chain's min node is in stored orientation; compact emitted chains
    into uid order; label every state with (uid, position).

    ``node``/``orient`` give each state's ITEM id and stored orientation
    under the caller's state indexing; ``node_of_end`` maps an end-state
    index to its item id (free arithmetic in the interleaved 2i+o layout,
    a gather in the rank-permuted layout).

    Returns (n_unitigs, length_u, first_item, first_flip, last_item,
    last_flip, uid_state, pos_state).
    """
    m = node.shape[0]
    mn = mnmo >> 1
    mo = mnmo & 1
    # Aggregates (mn, mo) at a start state cover the whole chain.
    emit_start = is_start & (mo == 0)
    n_unitigs = emit_start.sum().astype(jnp.int32)

    # ONE sort compacts emitted chains into uid order (increasing
    # chain-min-node — the reference's seed order, compression.rs:574):
    # row u < n_unitigs of the sorted payloads IS unitig u, so unitig
    # metadata needs no scatters at all.  Emitted keys (chain mins) are
    # unique, so the unstable sort is deterministic for every row read.
    sort_key = jnp.where(emit_start, mn, jnp.int32(n))
    out_s = jax.lax.sort(
        [sort_key, end_id, node, orient, dist], num_keys=1, is_stable=False
    )
    c_end, c_node, c_orient, c_dist = out_s[1:]
    # Chains contract: per-unitig arrays are (n,)-sized, slot u < n_unitigs
    length_m = c_dist + 1  # full (m,) view, used by the end-state scatter
    length_u = length_m[:n]
    first_item = c_node[:n]
    first_flip = c_orient[:n]
    last_item = node_of_end(jnp.clip(c_end, 0, m - 1)[:n])
    last_flip = (c_end & 1)[:n]

    # uid + chain length at each chain's END state, then every state
    # reads them through its own end_id.  TWO 1-lane scatters in place of
    # one packed (m, 2) ROW scatter, which is assumed to lower far worse
    # (untested on the GPU, see ROADMAP)
    uidx = jnp.arange(m, dtype=jnp.int32)
    live = uidx < n_unitigs
    tpos = jnp.where(live, jnp.clip(c_end, 0, m - 1), m)
    tbl_uid = jnp.full(m, -1, jnp.int32).at[tpos].set(uidx, mode="drop")
    tbl_len = jnp.full(m, -1, jnp.int32).at[tpos].set(length_m, mode="drop")
    # read both lanes in ONE (m, 2) row gather; only the SCATTERS are
    # split into 1-lane ones
    tbl = jnp.stack([tbl_uid, tbl_len], axis=1)
    g = tbl[jnp.clip(end_id, 0, m - 1)]
    uid_state = jnp.where(end_id >= 0, g[:, 0], -1)
    chain_len = g[:, 1]
    pos_state = chain_len - 1 - dist
    return (n_unitigs, length_u, first_item, first_flip, last_item,
            last_flip, uid_state, pos_state)


_CP_FLAG = jnp.int32(1 << 30)


def _copy_first_packed(vals, flags):
    """Forward segmented copy-first scan on packed int32 lanes: each
    element gets the value at its segment's START (``flags`` mark starts).
    ``vals`` must fit in 30 bits."""
    x = jnp.where(flags, vals | _CP_FLAG, vals)

    def comb(a, b):
        return jnp.where(b >= _CP_FLAG, b, a)

    return jax.lax.associative_scan(comb, x) & (_CP_FLAG - 1)


def _copy_last_packed(vals, is_end):
    """Suffix variant: each element gets the value at its segment's END."""
    return _copy_first_packed(vals[::-1], is_end[::-1])[::-1]


def _min_suffix_packed(vals, is_end):
    """Suffix segmented MIN on packed int32 lanes (< 2^30): at each
    element, the min of ``vals`` from it through its segment's end."""
    x = jnp.where(is_end, vals | _CP_FLAG, vals)[::-1]

    def comb(a, b):
        merged = jnp.minimum(a & (_CP_FLAG - 1), b & (_CP_FLAG - 1)) | (
            a & _CP_FLAG
        )
        return jnp.where((b & _CP_FLAG) != 0, b | (a & _CP_FLAG), merged)

    return (jax.lax.associative_scan(comb, x) & (_CP_FLAG - 1))[::-1]


def link_chains_ordered(
    partner_l, partner_r, in_l, in_r, valid, first_pos, cap: int
) -> tuple:
    """Chain linking with READ-ADJACENCY contraction (the r4->r5 compress
    rework; reference semantics identical to :func:`link_chains`).

    ``first_pos`` is each item's first-occurrence observation index
    (filter_kmers data_reduce='obs_min').  Permuting items into discovery
    order makes unitig chains index-contiguous: on read corpora ~98% of
    chain edges connect rank-adjacent items (measured, 13x coverage), so
    chains contract into ~n/30 intervals.  Pointer doubling then runs on
    the CONTRACTED graph (two directed traversals per interval), whose
    gathers are ~30x smaller than the full 2n-state ranking — the
    dominant cost of compression.

    Correctness does NOT depend on ``first_pos`` quality — arbitrary
    values only degrade the contraction ratio (fuzzed in tests).

    ``cap`` bounds the contracted interval count (static shape).  Returns
    (chains, overflow): when ``overflow`` is True the contracted table
    was truncated and ``chains`` is INVALID — the caller must retry with
    a bigger cap or fall back to :func:`link_chains`.

    Requires n < 2^22 (packed int32 lanes); callers gate on it.
    """
    n = partner_l.shape[0]
    if n >= (1 << 22):
        raise ValueError("link_chains_ordered requires n < 2^22")
    cap = min(cap, n)  # there are never more intervals than items
    pos = jnp.arange(n, dtype=jnp.int32)

    # ---- 1. permute items into discovery-rank order --------------------
    # invalid items rank last; arange tie-break keeps the sort
    # deterministic under the unstable sort
    aux = (
        in_l.astype(jnp.int32)
        | (in_r.astype(jnp.int32) << 1)
    )
    # clamp below the invalid sentinel so positional validity (rank <
    # n_valid) holds for ANY caller-supplied first_pos values
    kp = jnp.where(
        valid,
        jnp.clip(first_pos.astype(jnp.int32), 0, 0x7FFFFFFE),
        jnp.int32(0x7FFFFFFF),
    )
    out = jax.lax.sort(
        [kp, pos, partner_l, partner_r, aux], num_keys=2, is_stable=False
    )
    orig, plo, pro, auxo = out[1], out[2], out[3], out[4]
    inl = auxo & 1
    inr = (auxo >> 1) & 1
    # rank of every item (inverse permutation), then partner VALUES
    # mapped item-id -> rank: one 2n-row gather
    rout = jax.lax.sort([orig, pos], num_keys=1, is_stable=False)
    rank = rout[1]
    pidx = jnp.concatenate([jnp.clip(plo, 0, n - 1), jnp.clip(pro, 0, n - 1)])
    granks = rank[pidx]
    rlp = jnp.where(plo >= 0, granks[:n], -1)
    rrp = jnp.where(pro >= 0, granks[n:], -1)

    # ---- 2. interval structure in rank space ---------------------------
    # x joined to x+1 iff some partner of x IS x+1 (mutuality gives the
    # reverse edge for free)
    join = (rlp == pos + 1) | (rrp == pos + 1)
    join = join.at[-1].set(False)
    bnd = jnp.concatenate([jnp.ones(1, bool), ~join[:-1]])
    is_end_iv = ~join
    icid = jnp.cumsum(bnd.astype(jnp.int32)) - 1  # interval id per rank

    # forward-traversal (T+) orientation per item: the stored orientation
    # of the state that moves toward HIGHER rank inside its interval
    # (state (i,0) exits stored R / is entered via stored L)
    ofwd = jnp.where(
        rrp == pos + 1, 0,
        jnp.where(
            rlp == pos + 1, 1,
            jnp.where(rlp == pos - 1, 0, jnp.where(rrp == pos - 1, 1, 0)),
        ),
    ).astype(jnp.int32)

    firstpk = _copy_first_packed((pos << 1) | ofwd, bnd)
    lastpk = _copy_last_packed((pos << 1) | ofwd, is_end_iv)
    a_of = firstpk >> 1        # interval first rank, per rank
    ofwd_a = firstpk & 1
    b_of = lastpk >> 1         # interval last rank, per rank
    ofwd_b = lastpk & 1

    # min (orig<<1 | o_fwd) over the interval, anchored at interval start
    mnP_pk = _min_suffix_packed((orig << 1) | ofwd, is_end_iv)

    # ---- 3. sigma state space (2*rank + orient) ------------------------
    oj_r = jnp.where(inr == LEFT, 0, 1)
    oj_l = jnp.where(inl == LEFT, 0, 1)
    succ0 = jnp.where(rrp >= 0, 2 * rrp + oj_r, -1)  # state (x,0) exits R
    succ1 = jnp.where(rlp >= 0, 2 * rlp + oj_l, -1)  # state (x,1) exits L
    succ_sig = jnp.stack([succ0, succ1], axis=1).reshape(2 * n)
    node_sig = jnp.repeat(orig, 2)
    orient_sig = jnp.tile(jnp.arange(2, dtype=jnp.int32), n)
    mnmo_sig0 = (node_sig << 1) | orient_sig
    valid_r = pos < valid.sum().astype(jnp.int32)  # positional: invalid rank last
    valid_sig = jnp.repeat(valid_r, 2)
    no_pred = jnp.stack([rlp < 0, rrp < 0], axis=1).reshape(2 * n)
    is_start = no_pred & valid_sig

    # per-rank lookup for mapping a target state to its traversal:
    # (interval id, is-first, is-last, o_fwd) packed in one lane
    code = (
        (icid << 3)
        | (bnd.astype(jnp.int32) << 2)
        | (is_end_iv.astype(jnp.int32) << 1)
        | ofwd
    )

    # ---- 4. compact intervals (valid only) -----------------------------
    key = jnp.where(valid_r & bnd, np.uint32(0), np.uint32(1 << 31)) | pos.astype(
        jnp.uint32
    )
    cpk = jax.lax.sort(
        [key, (pos << 1) | ofwd, lastpk, mnP_pk], num_keys=1, is_stable=False
    )
    n_iv = (valid_r & bnd).sum().astype(jnp.int32)
    overflow = n_iv > cap
    ca = (cpk[1] >> 1)[:cap]          # interval first rank
    ca_of = (cpk[1] & 1)[:cap]        # o_fwd at first
    cb = (cpk[2] >> 1)[:cap]          # interval last rank
    cb_of = (cpk[2] & 1)[:cap]
    cmnP = cpk[3][:cap]
    ridx = jnp.arange(cap, dtype=jnp.int32)
    ivlive = ridx < n_iv
    clen = cb - ca + 1

    # contracted successors: T+ exits at (b, ofwd_b), T- at (a, 1-ofwd_a)
    csP_t = succ_sig[jnp.clip(2 * cb + cb_of, 0, 2 * n - 1)]
    csM_t = succ_sig[jnp.clip(2 * ca + (1 - ca_of), 0, 2 * n - 1)]

    def to_cid2(tsig):
        # target sigma state -> contracted node id (2*interval + tv)
        t = jnp.clip(tsig, 0, 2 * n - 1) >> 1
        oj = jnp.clip(tsig, 0, 2 * n - 1) & 1
        c = code[t]
        isf = (c >> 2) & 1
        ofw = c & 1
        # the target state HAS a predecessor, so it is the entry of
        # exactly one traversal: T+ iff it's the interval's first item in
        # forward orientation, else T-
        tv = jnp.where((isf == 1) & (oj == ofw), 0, 1)
        return jnp.where(tsig >= 0, 2 * (c >> 3) + tv, -1)

    csP = jnp.where(ivlive, to_cid2(csP_t), -1)
    csM = jnp.where(ivlive, to_cid2(csM_t), -1)
    cdP0 = jnp.where(ivlive, clen - 1 + (csP >= 0), 0)
    cdM0 = jnp.where(ivlive, clen - 1 + (csM >= 0), 0)
    ceP0 = jnp.where(ivlive & (csP == -1), 2 * cb + cb_of, -1)
    ceM0 = jnp.where(ivlive & (csM == -1), 2 * ca + (1 - ca_of), -1)
    cmP0 = jnp.where(ivlive, cmnP, jnp.int32((1 << 30) - 1))
    cmM0 = jnp.where(ivlive, cmnP ^ 1, jnp.int32((1 << 30) - 1))

    interleave = lambda p, m_: jnp.stack([p, m_], axis=1).reshape(2 * cap)
    csucc_c = interleave(csP, csM)
    cdist0 = interleave(cdP0, cdM0)
    cend0 = interleave(ceP0, ceM0)
    cmnmo0 = interleave(cmP0, cmM0)

    # ---- 5. contracted ranking ----------------------------------------
    csucc_f, cdist, cmnmo, cend = _rank_all(csucc_c, cmnmo0, cdist0, cend0)
    any_cycle = jnp.any(csucc_f >= 0)

    # ---- 6a. acyclic expansion (the normal path) -----------------------
    def expand(_):
        # broadcast contracted results to every rank via start-position
        # scatters + copy-first scans (values < 2^30)
        dP = cdist.reshape(cap, 2)[:, 0]
        dM = cdist.reshape(cap, 2)[:, 1]
        eP = cend.reshape(cap, 2)[:, 0]
        eM = cend.reshape(cap, 2)[:, 1]
        spos = jnp.where(ivlive, ca, n)

        def bc(v, fill=0):
            seed = jnp.full(n, fill, jnp.int32).at[spos].set(v, mode="drop")
            return _copy_first_packed(seed, bnd)

        DP = bc(dP)
        DM = bc(dM)
        # end ids may be -1: bias by +1 into [0, 2n], un-bias after
        EP = bc(eP + 1) - 1
        EM = bc(eM + 1) - 1
        qP = pos - a_of
        qM = b_of - pos
        dist_pair = jnp.stack(
            [
                jnp.where(ofwd == 0, DP - qP, DM - qM),   # state o=0
                jnp.where(ofwd == 1, DP - qP, DM - qM),   # state o=1
            ],
            axis=1,
        ).reshape(2 * n)
        end_pair = jnp.stack(
            [
                jnp.where(ofwd == 0, EP, EM),
                jnp.where(ofwd == 1, EP, EM),
            ],
            axis=1,
        ).reshape(2 * n)
        # chain-min aggregates are read at START states only: scatter the
        # contracted values straight to the entry states' sigma slots
        entP = jnp.where(ivlive, 2 * ca + ca_of, 2 * n)
        entM = jnp.where(ivlive, 2 * cb + (1 - cb_of), 2 * n)
        mnP = cmnmo.reshape(cap, 2)[:, 0]
        mnM = cmnmo.reshape(cap, 2)[:, 1]
        mn_sig = jnp.zeros(2 * n, jnp.int32).at[entP].set(mnP, mode="drop")
        mn_sig = mn_sig.at[entM].set(mnM, mode="drop")
        return dist_pair, mn_sig, end_pair, jnp.zeros(2 * n, bool)

    # ---- 6b. cycle fallback: full sigma-space ranking (rare) -----------
    def cyc(_):
        succ_f, dist_f, mnmo_f, end_f = _rank_all(succ_sig, mnmo_sig0)
        is_cy = succ_f >= 0
        mn_f = mnmo_f >> 1
        cut_exit = is_cy & (node_sig == mn_f) & (orient_sig == 0)
        # mirror edge: the state whose successor is (min item, orient 1);
        # that state's sigma index needs rank[mn_f] — one gather, only on
        # this rare branch
        min_flip_sig = 2 * rank[jnp.clip(mn_f, 0, n - 1)] + 1
        target_is_min_flipped = is_cy & (succ_sig == min_flip_sig)
        cut_mask = cut_exit | target_is_min_flipped
        succ_cut = jnp.where(cut_mask, -1, succ_sig)
        _, d, mm, e = _rank_all(succ_cut, mnmo_sig0)
        extra = jnp.zeros(2 * n, bool).at[
            jnp.where(cut_mask, jnp.clip(succ_sig, 0, 2 * n - 1), 2 * n)
        ].set(True, mode="drop")
        return d, mm, e, extra

    dist, mnmo, end_id, extra_starts = jax.lax.cond(
        any_cycle, cyc, expand, None
    )
    is_start = is_start | (extra_starts & valid_sig)

    # ---- 7. emission (shared tail) ------------------------------------
    (n_unitigs, length_u, first_item, first_flip, last_item, last_flip,
     uid_state, pos_state) = _emit_chains(
        n, node_sig, orient_sig, dist, mnmo, end_id, is_start,
        node_of_end=lambda e: node_sig[e],
    )

    emitted = uid_state >= 0
    emit_pair = emitted.reshape(n, 2)
    pick_b = emit_pair[:, 0]
    take = lambda a: jnp.where(
        pick_b, a.reshape(n, 2)[:, 0], a.reshape(n, 2)[:, 1]
    )
    uid_r = jnp.where(
        valid_r & (emit_pair[:, 0] | emit_pair[:, 1]), take(uid_state), -1
    )
    pos_r = take(pos_state)
    flip_r = jnp.where(pick_b, 0, 1)

    # ---- 8. un-permute per-item results back to table order ------------
    pk = (
        (jnp.clip(pos_r, 0, (1 << 22) - 1) << 2)
        | (flip_r << 1)
        | (uid_r >= 0)
    )
    uout = jax.lax.sort([orig, uid_r, pk], num_keys=1, is_stable=False)
    uid = jnp.where((uout[2] & 1) == 1, uout[1], -1)
    pos_i = uout[2] >> 2
    flip = ((uout[2] >> 1) & 1).astype(bool)

    chains = Chains(
        uid=uid,
        pos=pos_i,
        flip=flip,
        n_unitigs=n_unitigs,
        length=length_u,
        first_item=first_item,
        last_item=last_item,
        first_flip=first_flip,
        last_flip=last_flip,
    )
    return chains, overflow


def _nibble_complement(nib):
    """Reverse bit order of a 4-bit extension nibble (base complementing)."""
    return E.complement_bits(nib & 0x0F) & 0x0F


def unitig_end_exts(exts, chains: Chains):
    """Per-unitig Exts byte from the terminal kmers' stored exts.

    Matches build_node's end handling (compression.rs:513-517,534-538):
    walk-left side of the first item (complemented if flipped), walk-right
    side of the last item (complemented if flipped).
    """
    fi = chains.first_item
    ff = chains.first_flip
    li = chains.last_item
    lf = chains.last_flip
    e_first = exts[fi]
    e_last = exts[li]
    left_nib = jnp.where(
        ff == 0,
        E.dir_bits(e_first, LEFT),
        _nibble_complement(E.dir_bits(e_first, RIGHT)),
    )
    right_nib = jnp.where(
        lf == 0,
        E.dir_bits(e_last, RIGHT),
        _nibble_complement(E.dir_bits(e_last, LEFT)),
    )
    return E.from_single_dirs(left_nib, right_nib)


def compress_kmer_table_device(
    spec: KmerSpec,
    stranded: bool,
    kmers,
    exts,
    n_valid,
    join_labels=None,
    first_pos=None,
    order_cap: Optional[int] = None,
):
    """Full device-side compression: table arrays -> chains + unitig exts.

    compress_kmers_with_hash equivalent (compression.rs:588-594).

    With ``first_pos`` (each kmer's first-occurrence observation index,
    filter_kmers data_reduce='obs_min') and ``order_cap``, chain linking
    runs through the read-adjacency contraction
    (:func:`link_chains_ordered`) — ~30x fewer doubling gathers on read
    corpora.  Returns (chains, u_exts, contrib[, overflow]) — the 4th
    element only in the ordered form; overflow=True means the contracted
    table was truncated and the caller must retry with a bigger cap.
    """
    n = kmers.shape[0]
    edges = resolve_edges(spec, stranded, kmers, exts, n_valid, join_labels)
    valid = jnp.arange(n, dtype=jnp.int32) < n_valid
    overflow = None
    if first_pos is not None:
        chains, overflow = link_chains_ordered(
            edges["partner_l"], edges["partner_r"], edges["in_l"],
            edges["in_r"], valid, first_pos,
            cap=order_cap or max(1 << 14, n // 8),
        )
    else:
        chains = link_chains(
            edges["partner_l"], edges["partner_r"], edges["in_l"],
            edges["in_r"], valid,
        )
    u_exts = unitig_end_exts(exts, chains)
    # per-kmer contributed base (for sequence assembly): oriented last base
    contrib = jnp.where(
        chains.flip,
        (~KM.first_base(spec, kmers)) & np.uint32(3),
        KM.last_base(spec, kmers),
    )
    if first_pos is not None:
        return chains, u_exts, contrib, overflow
    return chains, u_exts, contrib


@partial(jax.jit, static_argnums=(0, 1, 2))
def _compress_jit(spec, stranded, use_join, kmers, exts, n_valid, join_labels):
    return compress_kmer_table_device(
        spec, stranded, kmers, exts, n_valid, join_labels if use_join else None
    )


def _pad_table_pow2(kspec, n, kmers, *cols):
    """Pow2-pad (kmers (n, W), 1-D columns) for the device compress call.

    The host APIs receive exact-length tables; compiling _compress_jit at
    every distinct n would defeat the persistent compile cache.  Rows
    >= n_valid are ignored by the kernel (uid -1), and
    assemble_unitigs_flat is documented to accept padded arrays.
    """
    cap = 1 << max(10, int(n - 1).bit_length())
    if cap == len(kmers):
        return (jnp.asarray(kmers),) + tuple(jnp.asarray(c) for c in cols)
    pk = np.zeros((cap, kspec.w), np.uint32)
    pk[:n] = np.asarray(kmers)[:n]
    out = [jnp.asarray(pk)]
    for c in cols:
        c = np.asarray(c)
        pc = np.zeros(cap, c.dtype)
        pc[:n] = c[:n]
        out.append(jnp.asarray(pc))
    return tuple(out)


@partial(jax.jit, static_argnums=(0, 1, 2))
def _compress_ordered_jit(spec, stranded, order_cap, kmers, exts, n_valid,
                          first_pos):
    return compress_kmer_table_device(
        spec, stranded, kmers, exts, n_valid, None,
        first_pos=first_pos, order_cap=order_cap,
    )


@partial(jax.jit, static_argnums=(0, 1))
def _edge_candidates_jit(spec, stranded, kmers, exts, n_valid):
    return resolve_edges(
        spec, stranded, kmers, exts, n_valid, return_candidates=True
    )


@partial(jax.jit, static_argnums=(0,))
def _finalize_compress_jit(
    spec, kmers, exts, n_valid, cand_l, cand_r, in_l, in_r, join_l, join_r
):
    """Second half of the rich path: apply the host-evaluated join masks,
    enforce mutuality, link chains, and derive end exts + contributed
    bases — mirrors compress_kmer_table_device after resolve_edges."""
    n = cand_l.shape[0]
    partners = {
        LEFT: jnp.where(join_l, cand_l, -1),
        RIGHT: jnp.where(join_r, cand_r, -1),
    }
    edges = _enforce_mutual(partners, {LEFT: in_l, RIGHT: in_r})
    valid = jnp.arange(n, dtype=jnp.int32) < n_valid
    chains = link_chains(
        edges["partner_l"], edges["partner_r"], edges["in_l"], edges["in_r"], valid
    )
    u_exts = unitig_end_exts(exts, chains)
    contrib = jnp.where(
        chains.flip,
        (~KM.first_base(spec, kmers)) & np.uint32(3),
        KM.last_base(spec, kmers),
    )
    return chains, u_exts, contrib


class CompressionSpec:
    """Pluggable unitig-merge policy (compression.rs:34-38).

    Two knobs, mirroring the reference trait:

    * ``reduce`` — folds per-item data along the unitig.  Either a named
      associative op (``"sum_sat_u16"``, ``"sum"``, ``"max"``, ``"min"``,
      ``"first"``) executed as a segmented reduction, or an arbitrary
      Python closure ``reduce(path_data, item_data) -> data`` folded
      host-side in unitig path order (left to right).
    * ``join_labels`` — optional callable mapping item data to an int
      label; two adjacent items may merge only if their labels are equal.
      This is the reference's ``join_test`` (compression.rs:37) restricted
      to equivalence tests — the only kind its shipped specs use
      (ScmapCompress joins on equality, compression.rs:84-98).  Pass
      ``join_labels=True`` to join on raw data equality.
    """

    def __init__(self, reduce="sum_sat_u16", join_labels=None):
        self.reduce = reduce
        self.join_labels = join_labels

    def label_array(self, data: np.ndarray):
        """Per-item int labels for the equality join mask, or None."""
        if self.join_labels is None:
            return None
        if self.join_labels is True:
            return np.asarray(data, np.int32)
        return np.asarray(
            [self.join_labels(int(d)) for d in np.asarray(data)], np.int32
        )


class SimpleCompress(CompressionSpec):
    """Closure/named-op reduce, unconditional join (compression.rs:40-65)."""

    def __init__(self, reduce):
        super().__init__(reduce=reduce, join_labels=None)


class ScmapCompress(CompressionSpec):
    """Join only equal data; unitig keeps that data (compression.rs:68-98)."""

    def __init__(self):
        super().__init__(reduce="first", join_labels=True)


def _reduce_np(op: str, vals: np.ndarray, uid: np.ndarray, n_unitigs: int):
    if op == "sum_sat_u16":
        acc = np.zeros(n_unitigs, np.int64)
        np.add.at(acc, uid, vals.astype(np.int64))
        return np.minimum(acc, 65535).astype(np.int32)
    if op == "sum":
        acc = np.zeros(n_unitigs, np.int64)
        np.add.at(acc, uid, vals.astype(np.int64))
        return acc.astype(np.int32)
    if op == "max":
        acc = np.full(n_unitigs, np.iinfo(np.int32).min, np.int32)
        np.maximum.at(acc, uid, vals.astype(np.int32))
        return acc
    if op == "min":
        acc = np.full(n_unitigs, np.iinfo(np.int32).max, np.int32)
        np.minimum.at(acc, uid, vals.astype(np.int32))
        return acc
    if op == "first":  # all-equal data (ScmapCompress)
        acc = np.zeros(n_unitigs, np.int32)
        acc[uid] = vals
        return acc
    raise ValueError(op)


def _fold_closure(fn, vals, uid, pos, n_unitigs):
    """Fold an arbitrary reduce closure in unitig path order (host-side).

    Matches CompressionSpec::reduce folding along build_node's path
    (compression.rs:510,531) up to fold order: ours is always left-to-right
    along the emitted unitig.
    """
    order = np.lexsort((pos, uid))
    acc = [None] * n_unitigs
    for i in order:
        u = int(uid[i])
        acc[u] = int(vals[i]) if acc[u] is None else fn(acc[u], int(vals[i]))
    return np.asarray([0 if a is None else a for a in acc], np.int32)


def _fold_objects(fn, payloads, idxs, uid, pos, n_unitigs):
    """Fold arbitrary payload OBJECTS per unitig in path order.

    ``idxs[i]`` maps compacted row i back to its payload; the accumulator
    starts as the leftmost item's payload object itself, so ``fn`` must
    not mutate its arguments (return a new object) — the generic-D analog
    of build_node's reduce fold (compression.rs:510,531), valid for
    associative + commutative reduces.
    """
    order = np.lexsort((pos, uid))
    acc = [None] * n_unitigs
    seen = [False] * n_unitigs
    for i in order:
        u = int(uid[i])
        o = payloads[int(idxs[i])]
        if not seen[u]:
            acc[u] = o
            seen[u] = True
        else:
            acc[u] = fn(acc[u], o)
    return acc


def assemble_unitigs_device(spec: KmerSpec, kmers, chains: Chains, contrib,
                            counts, cap_bases: int):
    """Device-side unitig sequence assembly.

    The host assembler (:func:`assemble_unitigs_flat`) needs every chain
    label array pulled to the host — ~8 x n x 4B.  This builds the SAME
    flat layout on device so only the base stream (~1 byte/base) and
    per-unitig arrays cross the boundary.

    Layout (identical to assemble_unitigs_flat): unitig u occupies
    ``out_lengths[u] = length[u] + K - 1`` bases at offset
    ``sum(out_lengths[:u])``; the first K-1 bases come from the oriented
    first kmer, every subsequent base is its kmer's oriented last base
    (build_node's VecDeque assembly, compression.rs:483-541).

    Returns (seq (cap_bases,) uint8 — valid prefix ``total``,
    total_bases (), out_lengths (n,) int32 [slot u < n_unitigs],
    data_sum (n,) int32 u16-saturated per-unitig count sums,
    overflow () bool — ``cap_bases`` too small, caller grows + retries).
    """
    n = kmers.shape[0]
    k = spec.k
    uid, pos = chains.uid, chains.pos
    nutg = chains.n_unitigs
    slot = jnp.arange(n, dtype=jnp.int32)
    live_u = slot < nutg
    out_len = jnp.where(live_u, chains.length + (k - 1), 0)
    csum = jnp.cumsum(out_len)
    offsets_excl = csum - out_len  # (n,)
    total = csum[-1] if n else jnp.int32(0)
    overflow = total > cap_bases

    live = uid >= 0
    # item index at each tail output position (>= K-1 within its unitig)
    item_pos = offsets_excl[jnp.clip(uid, 0, n - 1)] + (k - 1) + pos
    item_at = (
        jnp.zeros(cap_bases, jnp.int32)
        .at[jnp.where(live, item_pos, cap_bases)]
        .set(slot, mode="drop")
    )
    # unitig id per output base: anchor scatter + prefix sum
    mark = (
        jnp.zeros(cap_bases, jnp.int32)
        .at[jnp.where(live_u & (out_len > 0), offsets_excl, cap_bases)]
        .set(1, mode="drop")
    )
    useg = jnp.cumsum(mark) - 1
    usegc = jnp.clip(useg, 0, n - 1)
    bpos = jnp.arange(cap_bases, dtype=jnp.int32)
    w_in = bpos - offsets_excl[usegc]
    head = w_in < (k - 1)

    tail_base = contrib[jnp.clip(item_at, 0, n - 1)]
    fi = chains.first_item[usegc]
    ff = chains.first_flip[usegc].astype(bool)
    fk = kmers[jnp.clip(fi, 0, n - 1)]  # (cap_bases, W) row gather
    jpos = jnp.where(ff, (k - 1) - w_in, w_in)
    b0 = KM.get_base_dyn(spec, fk, jnp.clip(jpos, 0, k - 1))
    head_base = jnp.where(ff, (~b0) & np.uint32(3), b0)

    seq = jnp.where(head, head_base, tail_base.astype(jnp.uint32))
    seq = jnp.where(bpos < total, seq, 0).astype(jnp.uint8)

    # u16-saturated count sum, overflow-proof: per-item counts are already
    # <= 65535, so with m <= 65535 items the raw sum fits uint32 exactly
    # (65535^2 < 2^32); unitigs with more items than that are saturated
    # outright (sum >= m > 65535 since every count >= 1).  int32
    # accumulation would wrap negative at ~33k max-count items (host
    # _reduce_np sums in int64 — this keeps device == host semantics).
    nitems = out_len - (k - 1)
    sum_u = (
        jnp.zeros(n, jnp.uint32)
        .at[jnp.where(live, uid, n)]
        .add(counts.astype(jnp.uint32), mode="drop")
    )
    data_sum = jnp.where(
        nitems > 65535, 65535, jnp.minimum(sum_u, 65535).astype(jnp.int32)
    ).astype(jnp.int32)
    return seq, total, out_len, data_sum, overflow


@partial(jax.jit, static_argnums=(0, 5))
def _assemble_dev_jit(spec, kmers, chains, contrib, counts, cap_bases):
    return assemble_unitigs_device(spec, kmers, chains, contrib, counts, cap_bases)


def compress_kmers_flat_device(table, *, cap_bases: Optional[int] = None):
    """Host API: KmerTable -> (seq_flat, out_lengths, u_exts, data) with
    sequence assembly ON DEVICE — the route :func:`compress_kmers` takes
    for its default policy (counts fold as u16-saturated sums; other
    policies assemble on the host).
    """
    kspec = table.spec
    n = len(table.kmers)
    if n == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64), np.zeros(0, np.int32), np.zeros(0, np.int32)
    kmers, exts, counts = _pad_table_pow2(
        kspec, n, table.kmers, table.exts, np.asarray(table.counts, np.int32)
    )
    chains, u_exts, contrib = _compress_jit(
        kspec, table.stranded, False, kmers, exts, jnp.int32(n),
        jnp.zeros(kmers.shape[0], jnp.int32),
    )
    nutg = int(chains.n_unitigs)
    if cap_bases is None:
        # exact output size: total bases = n + n_unitigs*(k-1) (every
        # unitig emits its item count + k-1 head bases) — sizing from
        # n + k alone under-provisions fragmented tables by up to ~n*k
        # and costs ~log2(k) cap-doubling recompiles
        cap = 1 << max(13, (n + nutg * (kspec.k - 1)).bit_length())
    else:
        cap = cap_bases
    while True:
        seq, total, out_len, data_sum, overflow = _assemble_dev_jit(
            kspec, kmers, chains, contrib, counts, cap
        )
        if not bool(overflow):
            break
        cap *= 2
    tot = int(total)
    # pow2-trimmed pulls (cheap slice programs; log2 distinct shapes)
    nb = 256
    while nb < tot:
        nb *= 2
    nb = min(nb, cap)
    seq_np = np.asarray(seq[:nb])[:tot]
    ub = 256
    while ub < nutg:
        ub *= 2
    ub = min(ub, n)
    out_lengths = np.asarray(out_len[:ub])[:nutg].astype(np.int64)
    u_exts_np = np.asarray(u_exts[:ub])[:nutg].astype(np.int32)
    data_np = np.asarray(data_sum[:ub])[:nutg].astype(np.int32)
    return seq_np, out_lengths, u_exts_np, data_np


def compress_kmers_rich(
    table,
    payloads,
    spec=None,
    *,
    reduce=None,
    join_test=None,
):
    """Generic-``D`` path compression: the reference trait's FULL power
    (CompressionSpec<D>, compression.rs:34-38) — arbitrary Python payload
    objects, an arbitrary ``reduce(acc, item) -> acc`` closure, and an
    arbitrary ``join_test(d1, d2) -> bool`` predicate.

    ``payloads`` is a length-n list aligned with ``table`` rows (e.g. the
    label sets from :func:`tpu_debruijn.filter.filter_kmers_set`).
    ``spec`` may be any object with ``.reduce``/``.join_test`` methods
    (duck-typed like the Rust trait); or pass the callables directly.

    Mechanics: edge candidates are resolved on device with every merge
    condition except the join test (resolve_edges with
    ``return_candidates``); the join predicate is evaluated host-side on
    the <= 2n candidate edges only (the reference also calls join_test
    once per extension attempt, compression.rs:426); masks go back to the
    device for mutuality + chain linking; payloads are folded per unitig
    in path order.

    Requirements matching the data-parallel model: ``join_test`` must be
    symmetric and ``reduce`` associative + commutative (true of every
    spec the reference ships or tests); ``reduce`` must not mutate its
    arguments.

    Returns list of (bases uint8, exts int, payload) per unitig.
    """
    kspec = table.spec
    n = len(table.kmers)
    if n == 0:
        return []
    if spec is not None:
        reduce = spec.reduce
        join_test = spec.join_test
    if reduce is None:
        reduce = lambda a, b: a
    kmers = jnp.asarray(table.kmers)
    exts = jnp.asarray(table.exts)
    cand = _edge_candidates_jit(kspec, table.stranded, kmers, exts, jnp.int32(n))
    join_l = np.ones(n, bool)
    join_r = np.ones(n, bool)
    if join_test is not None:
        for key, jm in (("partner_l", join_l), ("partner_r", join_r)):
            arr = np.asarray(cand[key])
            for i in np.nonzero(arr >= 0)[0]:
                jm[i] = bool(join_test(payloads[int(i)], payloads[int(arr[i])]))
    chains, u_exts, contrib = _finalize_compress_jit(
        kspec, kmers, exts, jnp.int32(n),
        cand["partner_l"], cand["partner_r"], cand["in_l"], cand["in_r"],
        jnp.asarray(join_l), jnp.asarray(join_r),
    )
    uid = np.asarray(chains.uid)
    pos = np.asarray(chains.pos)
    nutg = int(chains.n_unitigs)
    seq_flat, out_lengths, u_exts_t, _ = assemble_unitigs_flat(
        kspec, table.kmers, uid, pos, np.asarray(chains.flip),
        np.asarray(chains.length), np.asarray(chains.first_item),
        np.asarray(chains.first_flip), nutg, np.asarray(u_exts),
        np.asarray(contrib), np.zeros(n, np.int32), data_reduce="first",
    )
    live = np.nonzero(uid >= 0)[0]
    objs = _fold_objects(reduce, payloads, live, uid[live], pos[live], nutg)
    offsets = np.zeros(nutg + 1, np.int64)
    np.cumsum(out_lengths, out=offsets[1:])
    return [
        (seq_flat[offsets[u] : offsets[u + 1]], int(u_exts_t[u]), objs[u])
        for u in range(nutg)
    ]


@jax.jit
def _fold_pairs_device(pu, pl):
    """Per-unitig color-set union on device: sort (unitig, label) pairs,
    keep run starts (the deduplicated sorted union), compact.  ``pu`` is
    each pair's unitig id (-1 = censored/dead).  Returns (uids, labels,
    n_pairs) with live unique pairs sorted at the front — the device
    replacement for a host np.unique over 10M+ pair rows."""
    dead = pu < 0
    k0 = jnp.where(dead, np.uint32(0xFFFFFFFF), pu.astype(jnp.uint32))
    k1 = jnp.where(dead, np.uint32(0xFFFFFFFF), pl.astype(jnp.uint32))
    s0, s1 = jax.lax.sort([k0, k1], num_keys=2, is_stable=False)
    p0 = jnp.concatenate([~s0[:1], s0[:-1]])
    p1 = jnp.concatenate([s1[:1], s1[:-1]])
    starts = (s0 != p0) | (s1 != p1)
    keep = starts.at[0].set(True) & (s0 != np.uint32(0xFFFFFFFF))
    n = pu.shape[0]
    key = jnp.arange(n, dtype=jnp.uint32) | jnp.where(
        keep, np.uint32(0), np.uint32(1 << 31)
    )
    out = jax.lax.sort([key, s0, s1], num_keys=1, is_stable=False)
    return (
        out[1].astype(jnp.int32),
        out[2].astype(jnp.int32),
        keep.sum().astype(jnp.int32),
    )


def compress_kmers_color_sets(
    table,
    pair_label: np.ndarray,
    split: np.ndarray,
    *,
    join_on_sets: bool = False,
):
    """Fold CountFilterSet color sets through compression AT SCALE — no
    per-kmer Python objects, no per-edge Python calls.

    The per-kmer data is a sorted label set in array form
    (:func:`tpu_debruijn.filter.filter_kmers_set_arrays` output: row i's
    set is ``pair_label[split[i]:split[i+1]]``); the per-unitig data is
    the sorted UNION of its kmers' sets — exactly the reference pattern
    ``SimpleCompress(|mut a, b| { a.extend(b); a })`` + sort/dedup over
    `Vec<u8>` colors (compression.rs:40-65 applied to filter.rs:68-101
    data).  With ``join_on_sets``, kmers merge only when their sets are
    IDENTICAL (ScmapCompress<Vec<D>> semantics, compression.rs:68-98),
    decided via eq-class ids — one equality-label device pass.

    Returns (nodes, out_labels, out_split): ``nodes`` is the usual
    [(bases, exts, data)] list (data = eq-class id when ``join_on_sets``
    else 0); unitig u's color set is
    ``out_labels[out_split[u]:out_split[u+1]]`` (sorted, deduplicated).
    """
    from tpu_debruijn.filter import assign_eq_classes

    kspec = table.spec
    n = len(table.kmers)
    if n == 0:
        return [], np.zeros(0, np.int32), np.zeros(1, np.int64)
    split = np.asarray(split, np.int64)
    pair_label = np.asarray(pair_label, np.int32)
    lens = np.diff(split)
    if join_on_sets:
        pair_kmer = np.repeat(np.arange(n, dtype=np.int64), lens)
        ids, _ = assign_eq_classes(pair_kmer, pair_label, n)
        labels = ids
    else:
        labels = np.zeros(n, np.int32)
    pk, pe, pl = _pad_table_pow2(kspec, n, table.kmers, table.exts, labels)
    chains, u_exts, contrib = _compress_jit(
        kspec, table.stranded, join_on_sets, pk, pe, jnp.int32(n), pl,
    )
    nutg = int(chains.n_unitigs)
    # sequences assemble ON DEVICE (assemble_unitigs_device): the host
    # pulls the flat base buffer + per-unitig lengths/exts + the per-item
    # uid column (pair routing) — 2-3 pow2-trimmed transfers instead of
    # the 8 full-cap chain arrays the host assembler needs
    base_cap = 1 << max(13, int(n + max(nutg, 1) * (kspec.k - 1)).bit_length())
    while True:
        seq, total, out_len, _, overflow = _assemble_dev_jit(
            kspec, pk, chains, contrib, jnp.zeros(pk.shape[0], jnp.int32),
            base_cap,
        )
        if not bool(overflow):
            break
        base_cap *= 2
    tot = int(total)
    nb = 256
    while nb < tot:
        nb *= 2
    seq_flat = np.asarray(seq[: min(nb, base_cap)])[:tot]
    ub = 256
    while ub < nutg:
        ub *= 2
    ub = min(ub, pk.shape[0])
    out_lengths = np.asarray(out_len[:ub])[:nutg].astype(np.int64)
    u_exts_np = np.asarray(u_exts[:ub])[:nutg].astype(np.int32)
    if join_on_sets:
        first_item = np.asarray(chains.first_item[:ub])[:nutg]
        node_data = np.asarray(pl)[first_item]  # eq-class id (constant per unitig)
    else:
        node_data = np.zeros(nutg, np.int32)
    offsets = np.zeros(nutg + 1, np.int64)
    np.cumsum(out_lengths, out=offsets[1:])
    nodes = [
        (seq_flat[offsets[u] : offsets[u + 1]], int(u_exts_np[u]),
         int(node_data[u]))
        for u in range(nutg)
    ]
    uid = np.asarray(chains.uid)
    # per-unitig set union: route every (kmer, label) pair to its unitig
    # and unique — ONE device sort + compaction over the pair rows (pow2
    # padded; dead rows carry uid -1), no per-unitig loop and no host
    # np.unique at 10M+ pair scale
    slot_of_pair = np.repeat(np.arange(n, dtype=np.int64), lens)
    pu = uid[slot_of_pair].astype(np.int32)
    p_n = len(pu)
    if p_n:
        cap = 1 << max(8, (p_n - 1).bit_length())
        pu_p = np.full(cap, -1, np.int32)
        pl_p = np.zeros(cap, np.int32)
        pu_p[:p_n] = pu
        pl_p[:p_n] = pair_label
        du, dl, dn = _fold_pairs_device(jnp.asarray(pu_p), jnp.asarray(pl_p))
        np_pairs = int(dn)
        uids = np.asarray(du)[:np_pairs]
        out_labels = np.asarray(dl)[:np_pairs]
        out_split = np.searchsorted(uids, np.arange(nutg + 1)).astype(np.int64)
    else:
        out_split = np.zeros(nutg + 1, np.int64)
        out_labels = np.zeros(0, np.int32)
    return nodes, out_labels, out_split


def infer_exts_device(spec: KmerSpec, stranded: bool, kmers, n_valid):
    """Infer extension bytes from set membership alone.

    compress_kmers_no_exts semantics (compression.rs:628-646): for each of
    the 8 (direction, base) neighbors of a kmer, set the extension bit iff
    the (canonicalized) neighbor is itself in the kmer set.  Targets are
    found by vectorized binary search over the sorted kmer array instead of
    the reference's HashSet.
    """
    n = kmers.shape[0]
    exts = jnp.zeros(n, jnp.int32)
    valid = jnp.arange(n, dtype=jnp.int32) < n_valid
    for d in (LEFT, RIGHT):
        for b in range(4):
            cand = (
                KM.extend_left(spec, kmers, jnp.uint32(b))
                if d == LEFT
                else KM.extend_right(spec, kmers, jnp.uint32(b))
            )
            if not stranded:
                cand = KM.min_rc(spec, cand)
            _, found = S.searchsorted_limbs(kmers, cand, n_valid)
            exts = jnp.where(valid & found, E.set_ext(exts, d, b), exts)
    return exts


@partial(jax.jit, static_argnums=(0, 1))
def _infer_exts_jit(spec, stranded, kmers, n_valid):
    return infer_exts_device(spec, stranded, kmers, n_valid)


def compress_kmers_no_exts(
    k: int,
    kmers: np.ndarray,
    data: Optional[np.ndarray] = None,
    *,
    stranded: bool = False,
    data_reduce: str = "sum_sat_u16",
    join_on_data: bool = False,
    spec: Optional[CompressionSpec] = None,
):
    """Host API: kmer set without extensions -> unitig list.

    compress_kmers_no_exts equivalent (compression.rs:619-659): extensions
    are inferred from set membership (a bit is set iff the neighbor kmer is
    present), then normal path compression runs.  ``kmers`` is an (n, W)
    uint32 limb array (any order; duplicates are dropped);
    ``data`` is an optional aligned int payload.

    Returns list of (bases, exts, data) like :func:`compress_kmers`.
    """
    from tpu_debruijn.filter import KmerTable

    cspec = spec
    spec = KmerSpec(k)
    kmers = np.asarray(kmers, np.uint32).reshape(-1, spec.w)
    if data is None:
        data = np.zeros(len(kmers), np.int32)
    data = np.asarray(data, np.int32)
    order = np.lexsort(tuple(kmers[:, i] for i in range(spec.w - 1, -1, -1)))
    kmers, data = kmers[order], data[order]
    if len(kmers) > 1:
        keep = np.ones(len(kmers), bool)
        keep[1:] = (kmers[1:] != kmers[:-1]).any(axis=1)
        kmers, data = kmers[keep], data[keep]
    n = len(kmers)
    if n == 0:
        return []
    exts = np.asarray(_infer_exts_jit(spec, stranded, jnp.asarray(kmers), jnp.int32(n)))
    table = KmerTable(
        spec=spec,
        stranded=stranded,
        kmers=kmers,
        exts=exts,
        counts=np.ones(n, np.int32),
        data=data,
    )
    return compress_kmers(
        table,
        data_reduce=data_reduce,
        join_on_data=join_on_data,
        data_field="data",
        spec=cspec,
    )


def compress_kmers(
    table,
    *,
    data_reduce: str = "sum_sat_u16",
    join_on_data: bool = False,
    data_field: str = "counts",
    spec: Optional[CompressionSpec] = None,
):
    """Host API: KmerTable -> list of unitigs [(bases, exts, data)].

    Equivalent to compress_kmers_with_hash (compression.rs:588) followed by
    reading BaseGraph node arrays.  Policy comes from ``spec`` (a
    :class:`CompressionSpec`) or from the shorthand knobs: ``data_reduce``
    folds the per-kmer data, ``join_on_data`` enables the ScmapCompress
    join_test (only equal data may merge, compression.rs:84-98).
    """
    kspec = table.spec
    n = len(table.kmers)
    if n == 0:
        return []
    if (
        spec is None
        and not join_on_data
        and data_reduce == "sum_sat_u16"
        and data_field == "counts"
    ):
        # the default policy assembles sequences ON DEVICE: the host pulls
        # ~1 byte/base instead of ~8 x n x 4B of chain labels (faster on
        # the H100 end to end, PERF.md)
        seq_flat, out_lengths, u_exts_t, data_red = compress_kmers_flat_device(
            table
        )
        offsets = np.zeros(len(out_lengths) + 1, np.int64)
        np.cumsum(out_lengths, out=offsets[1:])
        return [
            (
                seq_flat[offsets[u] : offsets[u + 1]],
                int(u_exts_t[u]),
                int(data_red[u]),
            )
            for u in range(len(out_lengths))
        ]
    data_np = np.asarray(getattr(table, data_field))
    if spec is not None:
        data_reduce = spec.reduce
        label_np = spec.label_array(data_np)
        join_on_data = label_np is not None
        labels_np = np.asarray(
            data_np if label_np is None else label_np, np.int32
        )
    else:
        labels_np = np.asarray(data_np, np.int32)
    kmers, exts, labels = _pad_table_pow2(
        kspec, n, table.kmers, table.exts, labels_np
    )
    chains, u_exts, contrib = _compress_jit(
        kspec, table.stranded, join_on_data, kmers, exts, jnp.int32(n), labels
    )
    log.debug(
        "compress_kmers: %d kmers -> %d unitigs", n, int(chains.n_unitigs)
    )
    return assemble_unitigs(
        kspec,
        table.kmers,
        # per-item arrays sliced back to n: data_np is host-side exact
        # length (may be an object array for callable reduces)
        np.asarray(chains.uid)[:n],
        np.asarray(chains.pos)[:n],
        np.asarray(chains.flip)[:n],
        np.asarray(chains.length),
        np.asarray(chains.first_item),
        np.asarray(chains.first_flip),
        int(chains.n_unitigs),
        np.asarray(u_exts),
        np.asarray(contrib)[:n],
        data_np,
        data_reduce=data_reduce,
    )


def assemble_unitigs_flat(
    spec: KmerSpec,
    kmers: np.ndarray,
    uid: np.ndarray,
    pos: np.ndarray,
    flip: np.ndarray,
    lengths: np.ndarray,
    first_item: np.ndarray,
    first_flip: np.ndarray,
    nutg: int,
    u_exts: np.ndarray,
    contrib: np.ndarray,
    data_np: np.ndarray,
    *,
    data_reduce: str = "sum_sat_u16",
):
    """Host: chain labels -> flat unitig buffers, no per-unitig loop.

    Works on padded arrays (padding slots carry uid == -1), so sharded
    callers can pass whole device buffers without trimming.

    Returns ``(seq_flat uint8, out_lengths int64, u_exts int32,
    data int32)`` — the ``BaseGraph.add_flat`` input format.
    """
    live = uid >= 0
    if callable(data_reduce):
        data_red = _fold_closure(data_reduce, data_np[live], uid[live], pos[live], nutg)
    else:
        data_red = _reduce_np(data_reduce, data_np[live], uid[live], nutg)

    out_lengths = (lengths[:nutg] + spec.k - 1).astype(np.int64)
    offsets = np.zeros(nutg + 1, np.int64)
    np.cumsum(out_lengths, out=offsets[1:])
    seq_flat = np.zeros(offsets[-1], np.uint8)
    # bases contributed by each kmer at pos >= 1
    tail = live & (pos > 0)
    seq_flat[offsets[uid[tail]] + spec.k - 1 + pos[tail]] = contrib[tail]
    # the first kmer of each unitig contributes all K bases, oriented
    if nutg:
        fk = KM.to_bases_batch_np(spec, kmers[first_item[:nutg]])  # (U, K)
        flip_u = first_flip[:nutg].astype(bool)
        fk[flip_u] = (3 - fk[flip_u, ::-1]) & 3
        idx = offsets[:nutg, None] + np.arange(spec.k)[None, :]
        seq_flat[idx.reshape(-1)] = fk.reshape(-1)

    return seq_flat, out_lengths, np.asarray(u_exts[:nutg], np.int32), data_red


def assemble_unitigs(
    spec: KmerSpec,
    kmers: np.ndarray,
    uid: np.ndarray,
    pos: np.ndarray,
    flip: np.ndarray,
    lengths: np.ndarray,
    first_item: np.ndarray,
    first_flip: np.ndarray,
    nutg: int,
    u_exts: np.ndarray,
    contrib: np.ndarray,
    data_np: np.ndarray,
    *,
    data_reduce: str = "sum_sat_u16",
):
    """Host: chain labels -> ragged unitig list [(bases, exts, data)].

    Thin view-building wrapper over :func:`assemble_unitigs_flat`.
    """
    seq_flat, out_lengths, u_exts_t, data_red = assemble_unitigs_flat(
        spec, kmers, uid, pos, flip, lengths, first_item, first_flip,
        nutg, u_exts, contrib, data_np, data_reduce=data_reduce,
    )
    offsets = np.zeros(nutg + 1, np.int64)
    np.cumsum(out_lengths, out=offsets[1:])
    return [
        (seq_flat[offsets[u] : offsets[u + 1]], int(u_exts_t[u]), int(data_red[u]))
        for u in range(nutg)
    ]


def stitch_flat(
    k: int,
    src_flat: np.ndarray,
    src_starts: np.ndarray,
    src_lens: np.ndarray,
    node_ids: np.ndarray,
    uid: np.ndarray,
    pos: np.ndarray,
    flip: np.ndarray,
    nutg: int,
):
    """Concatenate oriented node sequences per unitig, dropping K-1 overlaps.

    The vectorized equivalent of build_node's VecDeque assembly at node
    granularity (compression.rs:291-334 path): every output base position
    is mapped to its source position in one gather — no per-node loop.

    Args:
      src_flat/src_starts/src_lens: the node sequence store (flat bases).
      node_ids: (m,) node indices participating (live nodes).
      uid/pos/flip: (m,) chain labels aligned with node_ids.
      nutg: number of output unitigs (uid values are 0..nutg-1).

    Returns (out_flat uint8, out_lengths int64).
    """
    if nutg == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64)
    order = np.lexsort((pos, uid))
    nid = node_ids[order]
    uid_s = uid[order]
    pos_s = pos[order]
    flip_s = flip[order].astype(bool)

    src_start_n = src_starts[nid].astype(np.int64)
    src_len_n = src_lens[nid].astype(np.int64)
    skip = np.where(pos_s > 0, k - 1, 0).astype(np.int64)
    contrib = src_len_n - skip

    # sorted by uid ascending => output layout is simply the running sum
    cum_excl = np.zeros(len(contrib), np.int64)
    np.cumsum(contrib[:-1], out=cum_excl[1:])
    total = int(contrib.sum())
    out_lengths = np.bincount(uid_s, weights=contrib, minlength=nutg).astype(np.int64)

    rep = np.repeat(np.arange(len(nid)), contrib)  # node per output base
    within = np.arange(total, dtype=np.int64) - np.repeat(cum_excl, contrib)
    fwd = src_start_n[rep] + skip[rep] + within
    rev = src_start_n[rep] + src_len_n[rep] - 1 - skip[rep] - within
    flip_rep = flip_s[rep]
    vals = src_flat[np.where(flip_rep, rev, fwd)]
    out_flat = np.where(flip_rep, 3 - vals, vals).astype(np.uint8)
    return out_flat, out_lengths
