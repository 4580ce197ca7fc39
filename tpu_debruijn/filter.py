"""Kmer counting / filtering engine (L3): the data-parallel ``filter_kmers``.

Reference: src/filter.rs:139-231.  Same semantics —
enumerate every kmer of every read with its extension byte
(lib.rs:809-842), canonicalize to min(kmer, rc) in unstranded mode
(filter.rs:190-196), group equal kmers, and fold each group through a
summarizer (CountFilter / CountFilterSet, filter.rs:40-101) — but the
mechanism is built from sorts and scans over whole batches:

* kmer extraction is a fully parallel bit-window gather over 2-bit packed
  base words (no sequential iterator),
* grouping is one lexicographic sort over uint32 limbs (the reference
  already sorts inside each of its 256 buckets, filter.rs:206 — here the
  sort IS the whole join),
* summarizers are segmented reductions (sum / bitwise-or / first).

The jitted pipeline keeps static shapes: all arrays are padded to
``R * (L - K + 1)`` candidate slots with validity masks; host wrappers
trim to actual sizes.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

import logging

from tpu_debruijn import exts as E
from tpu_debruijn import kmer as KM
from tpu_debruijn import sorting as S

log = logging.getLogger("tpu_debruijn.filter")
from tpu_debruijn.kmer import KmerSpec


def pack_base_words(bases):
    """(R, L) 2-bit codes -> (R, ceil(L/16)) uint32 words, 16 bases/word,
    first base in the most significant bits (AVX2 pack kernel equivalent,
    bitops_avx2.rs:9-42; layout note dna_string.rs:72 uses u64/32 bases —
    uint32/16 bases keeps every limb in 32-bit lanes)."""
    r, l = bases.shape
    nw = -(-l // 16)
    pad = nw * 16 - l
    b = jnp.asarray(bases, jnp.uint32)
    if pad:
        b = jnp.pad(b, ((0, 0), (0, pad)))
    b = b.reshape(r, nw, 16)
    shifts = np.uint32(30) - np.uint32(2) * jnp.arange(16, dtype=jnp.uint32)
    return (b << shifts).sum(axis=-1, dtype=jnp.uint32)


def extract_kmers(spec: KmerSpec, bases, lengths, seq_exts):
    """All kmers + extension bytes of a padded read batch.

    Args:
      bases: (R, L) int array of 2-bit codes (padding arbitrary)
      lengths: (R,) actual read lengths
      seq_exts: (R,) whole-read extension bytes (Exts of the read within its
        parent string, for MSP substrings — filter.rs:116-124)

    Returns (kmers (R, Lk, W) uint32, exts (R, Lk) int32, valid (R, Lk) bool)
    where Lk = L - K + 1.  Position s holds the kmer starting at base s.
    """
    k, w, padbits = spec.k, spec.w, spec.pad
    r, l = bases.shape
    if l < k:
        raise ValueError(f"padded read length {l} < K={k}")
    lk = l - k + 1

    words = pack_base_words(bases)  # (R, nw)
    nw = words.shape[1]
    # prepend one zero word (for windows that reach before the stream) and
    # append enough zero words for the deepest limb access
    pstream = jnp.pad(words, ((0, 0), (1, w + 1)))

    # shifted[r2] = stream funnel-shifted left by 2*r2 bits
    shifted = []
    for r2 in range(16):
        if r2 == 0:
            shifted.append(pstream)
        else:
            cur = pstream << np.uint32(2 * r2)
            nxt = jnp.pad(pstream[:, 1:], ((0, 0), (0, 1))) >> np.uint32(32 - 2 * r2)
            shifted.append(cur | nxt)
    shifted = jnp.stack(shifted, axis=0)  # (16, R, nw + w + 2)

    s = jnp.arange(lk, dtype=jnp.int32)
    u = s + (16 - padbits // 2)  # half-word offset incl. the prepended word
    r_half = u % 16
    q = u // 16
    limbs = []
    for j in range(w):
        lj = shifted[r_half, :, q + j]  # (Lk, R)
        limbs.append(lj.T)
    kmers = jnp.stack(limbs, axis=-1)  # (R, Lk, W)
    if padbits:
        kmers = kmers.at[..., 0].set(kmers[..., 0] & spec.top_mask)

    # extension bytes (KmerExtsIter semantics, lib.rs:809-842)
    bases_i = jnp.asarray(bases, jnp.int32)
    se = jnp.asarray(seq_exts, jnp.int32)[:, None]
    lengths = jnp.asarray(lengths, jnp.int32)[:, None]

    left_prev = bases_i[:, : lk - 1] if lk > 1 else bases_i[:, :0]
    left_nib = jnp.concatenate(
        [se & 0x0F, jnp.left_shift(1, left_prev)], axis=1
    )
    rb = bases_i[:, k:]  # base at s + k, shape (R, Lk - 1)
    rb = jnp.pad(rb, ((0, 0), (0, 1)))
    pos = s[None, :]
    at_right_end = pos == (lengths - k)
    right_nib = jnp.where(at_right_end, (se >> 4) & 0x0F, jnp.left_shift(1, rb))
    exts = (left_nib & 0x0F) | ((right_nib & 0x0F) << 4)

    valid = pos <= (lengths - k)
    return kmers, exts.astype(jnp.int32), valid


def canonicalize(spec: KmerSpec, kmers, exts, stranded: bool):
    """min_rc_flip + Exts::rc on flip (filter.rs:190-196).

    A plain elementwise bit ladder: XLA fuses it into one pass over the
    limbs, which is all a memory-bound map can ask for.
    """
    if stranded:
        return kmers, exts, jnp.zeros(kmers.shape[:-1], bool)
    ck, flip = KM.min_rc_flip(spec, kmers)
    cexts = jnp.where(flip, E.rc(exts), exts)
    return ck, cexts, flip


def extract_canonical(spec: KmerSpec, bases, lengths, seq_exts,
                      stranded: bool):
    """The count programs' front end: ``extract_kmers`` + ``canonicalize``,
    named "frontend" for trace reductions.  Plain XLA: on the H100 it
    fuses into the count step's consumers, and a hand-written fused kernel
    did not make the step faster (PERF.md).
    """
    with jax.named_scope("frontend"):
        kmers, exts, valid = extract_kmers(spec, bases, lengths, seq_exts)
        kmers, exts, _ = canonicalize(spec, kmers, exts, stranded)
        return kmers, exts, valid


def sort_observations(spec: KmerSpec, kf, ef, lab, vf, stable: bool = True):
    """Sort kmer observations by (validity, kmer), carrying exts + labels.

    Returns (slimbs: list of W key arrays, svalid, sexts, slab); ``lab``
    may be None (label-free pipelines), then slab is None.  ``stable``
    may be False when within-run payload order is immaterial (every
    reduction except 'label_first' is order-independent) — an unstable
    sort needs no tie-break work.

    Memory-traffic optimizations over a naive variadic sort (the sort is
    the pipeline's dominant cost; a comparator sort moves EVERY array
    through every pass, so each dropped array cuts traffic, and a
    post-sort random gather is assumed to cost more than riding the sort
    — both untested on the GPU, see ROADMAP):

    * when the kmer's top limb has spare pad bits (k not a multiple of
      16), the validity flag rides in limb 0's top bit instead of a
      dedicated key array — invalid slots sort after all valid kmers;
    * when there are NO pad bits (k = 16/32/48/64) and labels are not
      carried, invalid rows become all-ones sentinel kmers with zeroed
      exts and validity is recovered POSITIONALLY (svalid = pos <
      sum(vf)): sentinels sort to the tail, and the one run they can
      share with real data (poly-T, which equals the sentinel value)
      stays correct because sentinel exts OR in as 0 and the count of
      that run is bounded by the valid-row total.  This drops the whole
      dedicated flag key array from the dominant sort.  Requires
      consumers to delimit exts aggregation by KEY CHANGE, not validity
      (valid poly-T rows can interleave with sentinels under the
      unstable sort) — see count_kmers' is_end.
    * exts (and the label, when present) are sort payloads — no row-index
      payload and no post-sort gathers at all.
    """
    if spec.pad >= 1:
        flag = jnp.where(vf, np.uint32(0), np.uint32(1 << 31))
        keys = [kf[:, 0] | flag] + [kf[:, i] for i in range(1, spec.w)]
        nflag = 0
    elif lab is None:
        n = vf.shape[0]
        nvalid = vf.sum().astype(jnp.int32)
        keys = [
            jnp.where(vf, kf[:, i], np.uint32(0xFFFFFFFF))
            for i in range(spec.w)
        ]
        ef = jnp.where(vf, ef, 0)
        out = jax.lax.sort(keys + [ef], num_keys=spec.w, is_stable=stable)
        svalid = jnp.arange(n, dtype=jnp.int32) < nvalid
        return list(out[: spec.w]), svalid, out[spec.w], None
    else:
        keys = [(~vf).astype(jnp.uint32)] + S.limbs_to_keys(kf)
        nflag = 1
    payload = [ef] + ([] if lab is None else [lab])
    out = jax.lax.sort(keys + payload, num_keys=len(keys), is_stable=stable)
    nk = len(keys)
    sexts = out[nk]
    slab = out[nk + 1] if lab is not None else None
    if nflag:
        svalid = out[0] == 0
        slimbs = list(out[1:nk])
    else:
        svalid = (out[0] >> np.uint32(31)) == 0
        slimbs = list(out[:nk])
        # top bit only set on invalid slots, which sort past every valid
        # row and are masked by svalid everywhere downstream
    return slimbs, svalid, sexts, slab


@dataclasses.dataclass
class KmerTableDev:
    """Device-side padded kmer table (the BoomHashMap2 replacement).

    ``kmers[:n_valid]`` are sorted unique valid kmers; slots beyond are
    padding.  ``all_*`` arrays hold the full census (valid + censored),
    used for sharded censored-ext repair (filter.rs:238-276).
    """

    spec: KmerSpec
    stranded: bool
    kmers: jnp.ndarray  # (n, W) uint32
    exts: jnp.ndarray  # (n,) int32
    counts: jnp.ndarray  # (n,) int32 (u16-saturated)
    data: jnp.ndarray  # (n,) int32 label payload (segment-reduced)
    n_valid: jnp.ndarray  # () int32
    all_kmers: Optional[jnp.ndarray] = None  # (n, W) unique census
    all_n: Optional[jnp.ndarray] = None


jax.tree_util.register_dataclass(
    KmerTableDev,
    data_fields=["kmers", "exts", "counts", "data", "n_valid", "all_kmers", "all_n"],
    meta_fields=["spec", "stranded"],
)


def count_kmers(
    spec: KmerSpec,
    bases,
    lengths,
    seq_exts,
    labels,
    *,
    stranded: bool,
    min_obs: int,
    data_reduce: str = "label_first",
    report_all: bool = True,
) -> KmerTableDev:
    """The filter_kmers pipeline body (jit-friendly; static shapes).

    data_reduce: how to fold per-observation labels per kmer —
      'label_first' (keep any one; CountFilter ignores data),
      'min' / 'max' / 'sum', or 'none' (labels are not plumbed at all and
      ``data`` comes back zero — drops one sort payload + one partition
      payload; the fast path when, like the reference's plain CountFilter,
      per-kmer data is just the count, filter.rs:40-63).
    report_all: also build the unique-kmer census (``all_kmers``), needed
      for sharded censored-ext repair (filter.rs:238-276); skipping it
      (False) drops one full-width partition sort from the pipeline.
    """
    kmers, exts, valid = extract_canonical(spec, bases, lengths, seq_exts,
                                           stranded)

    n = kmers.shape[0] * kmers.shape[1]
    w = spec.w
    kf = kmers.reshape(n, w)
    ef = exts.reshape(n)
    vf = valid.reshape(n)
    if data_reduce == "none":
        lab = None
    elif data_reduce == "obs_min":
        # per-OBSERVATION index (read-major discovery order), min-reduced
        # per kmer -> data = each kmer's first-occurrence position.  Feeds
        # compression's read-adjacency ordering (compress.link_chains_
        # ordered): consecutive first-occurrence ranks make unitig chains
        # index-contiguous, collapsing the pointer-doubling gathers.
        lab = jnp.arange(n, dtype=jnp.int32)
    else:
        lab = jnp.broadcast_to(
            jnp.asarray(labels, jnp.int32)[:, None], valid.shape
        ).reshape(n)

    slimbs, svalid, sexts, slab = sort_observations(
        spec, kf, ef, lab, vf, stable=(data_reduce == "label_first")
    )
    prev = [jnp.concatenate([kk[:1], kk[:-1]]) for kk in slimbs]
    differs = ~S.lex_eq(slimbs, prev)
    first = jnp.zeros(n, bool).at[0].set(True)
    starts = svalid & (first | differs)

    # scatter-free segmented reductions: all grouping work is done with
    # scans over the sorted runs + stable partitions.  Per-run aggregates are anchored at the run START (via
    # suffix scans seeded at run ends), so ONE partition by the pass mask
    # yields the whole table:
    #   * run length = next-boundary position - own position, from a single
    #     suffix-min scan (runs are contiguous among valid rows);
    #   * exts OR = a packed single-int32 suffix scan;
    #   * 16-bit count + 8-bit exts ride the partition as ONE packed
    #     payload lane.
    pos = jnp.arange(n, dtype=jnp.int32)
    if spec.pad == 0 and lab is None:
        # sentinel-validity layout (see sort_observations): exts segments
        # are delimited by KEY CHANGE only — valid poly-T rows can
        # interleave with zero-exts sentinel rows inside the final run,
        # and ORing across the whole run is exact because sentinel exts
        # are 0
        is_end = jnp.concatenate([differs[1:], jnp.ones(1, bool)])
    else:
        is_end = svalid & jnp.concatenate(
            [starts[1:] | ~svalid[1:], jnp.ones(1, bool)]
        )

    or_total = S.seg_or_suffix8(sexts, is_end)
    if data_reduce in ("none", "label_first"):
        lab_red = slab  # stable sort keeps first occurrence at run start
    elif data_reduce in ("min", "obs_min"):
        lab_red = S.seg_op_scan(slab[::-1], is_end[::-1], jnp.minimum)[::-1]
    elif data_reduce == "max":
        lab_red = S.seg_op_scan(slab[::-1], is_end[::-1], jnp.maximum)[::-1]
    elif data_reduce == "sum":
        lab_red = S.seg_op_scan(slab[::-1], is_end[::-1], lambda a, b: a + b)[::-1]
    else:
        raise ValueError(data_reduce)

    if min_obs <= 1 and n < (1 << 23):
        # every run start passes, so counts need not precede the partition:
        # carry each start's POSITION instead and difference consecutive
        # compacted positions afterwards — drops the suffix-min scan.
        # The partition key IS the packed payload with the pass flag in
        # the top bit (pos < 2^23 so pos<<8 < 2^31): one array fewer in
        # the partition sort than a separate index key — the sort moves
        # every operand through every pass, so each dropped array cuts
        # the dominant cost
        passes = starts
        packed = (pos << 8) | (or_total & 0xFF)
        key = jnp.where(passes, np.uint32(0), np.uint32(1 << 31)) | packed.astype(
            jnp.uint32
        )
        vout = jax.lax.sort(
            [key] + list(slimbs) + ([] if lab_red is None else [lab_red]),
            num_keys=1,
            is_stable=False,
        )
        n_valid = passes.sum().astype(jnp.int32)
        vkmers = S.keys_to_limbs(vout[1 : 1 + spec.w])
        vexts = (vout[0] & np.uint32(0xFF)).astype(jnp.int32)
        p = ((vout[0] >> np.uint32(8)) & np.uint32(0x7FFFFF)).astype(jnp.int32)
        nvalid_obs = svalid.sum().astype(jnp.int32)
        nxt = jnp.concatenate([p[1:], jnp.zeros(1, p.dtype)])
        nxt = jnp.where(pos == n_valid - 1, nvalid_obs, nxt)
        vcounts = jnp.minimum(nxt - p, 65535)
        vdata = (
            vout[1 + spec.w] if lab_red is not None else jnp.zeros_like(vcounts)
        )
    else:
        # general path: per-run length from one suffix-min scan over the
        # boundary positions (runs are contiguous among valid rows)
        bnd = starts | ~svalid
        t = jnp.where(bnd, pos, n)
        suf_min = jax.lax.associative_scan(jnp.minimum, t[::-1])[::-1]
        nxt_after = jnp.concatenate([suf_min[1:], jnp.full(1, n, jnp.int32)])
        counts = jnp.minimum(nxt_after - pos, 65535)
        passes = starts & (counts >= min_obs)
        packed = (counts << 8) | (or_total & 0xFF)  # fits: 16+8 bits
        n_valid, vout = S.partition(
            passes,
            list(slimbs) + [packed] + ([] if lab_red is None else [lab_red]),
        )
        vkmers = S.keys_to_limbs(vout[: spec.w])
        vexts = vout[spec.w] & 0xFF
        vcounts = vout[spec.w] >> 8
        vdata = vout[spec.w + 1] if lab_red is not None else jnp.zeros_like(vcounts)

    if report_all:
        n_unique, aout = S.partition(starts, list(slimbs))
        ukmers = S.keys_to_limbs(aout)
    else:
        n_unique = starts.sum().astype(jnp.int32)
        ukmers = None

    return KmerTableDev(
        spec=spec,
        stranded=stranded,
        kmers=vkmers,
        exts=vexts,
        counts=vcounts,
        data=vdata,
        n_valid=n_valid,
        all_kmers=ukmers,
        all_n=n_unique,
    )


def count_kmers_sets(
    spec: KmerSpec,
    bases,
    lengths,
    seq_exts,
    labels,
    *,
    stranded: bool,
    min_obs: int,
):
    """CountFilterSet engine (filter.rs:68-101): per-kmer sorted-deduped
    label sets, via one sort over (kmer, label) composite keys.

    Returns (KmerTableDev, pair_kmer (n,) int32 slot ids into the table,
    pair_label (n,) int32, n_pairs): pairs are the distinct (kmer, label)
    observations of *valid* kmers, lexicographically ordered, so the label
    set of table slot i is pair_label[pair_kmer == i] (already sorted).
    """
    kmers, exts, valid = extract_canonical(spec, bases, lengths, seq_exts,
                                           stranded)

    n = kmers.shape[0] * kmers.shape[1]
    w = spec.w
    kf = kmers.reshape(n, w)
    ef = exts.reshape(n)
    vf = valid.reshape(n)
    lab = jnp.broadcast_to(
        jnp.asarray(labels, jnp.int32)[:, None], valid.shape
    ).reshape(n)

    # validity flag folded into limb 0's pad bit when available (see
    # sort_observations); labels are part of the KEY here, not a payload
    if spec.pad >= 1:
        flag = jnp.where(vf, np.uint32(0), np.uint32(1 << 31))
        keys = [kf[:, 0] | flag] + [kf[:, i] for i in range(1, w)]
        keys += [lab.astype(jnp.uint32)]
        (skeys, (sexts,)) = S.sort_with_payload(keys, [ef])
        svalid = (skeys[0] >> np.uint32(31)) == 0
        slimbs = [skeys[0] & spec.top_mask] + list(skeys[1:-1])
        slab = skeys[-1].astype(jnp.int32)
    else:
        inv = (~vf).astype(jnp.uint32)
        keys = [inv] + S.limbs_to_keys(kf) + [lab.astype(jnp.uint32)]
        (skeys, (sexts,)) = S.sort_with_payload(keys, [ef])
        svalid = skeys[0] == 0
        slimbs = list(skeys[1:-1])
        slab = skeys[-1].astype(jnp.int32)
    skmers = S.keys_to_limbs(slimbs)

    starts = S.run_starts(slimbs, svalid)  # kmer-run starts
    seg = S.segment_ids(starts, svalid)
    counts = jnp.minimum(S.segment_sum(svalid.astype(jnp.int32), seg, n), 65535)
    uexts = S.segment_or8(sexts, seg, n)
    # per-limb 1-lane scatters (assumed cheaper than one row scatter;
    # untested on the GPU, see ROADMAP)
    ukmers = jnp.stack(
        [
            jnp.zeros(n, skmers.dtype).at[seg].set(skmers[:, i], mode="drop")
            for i in range(skmers.shape[1])
        ],
        axis=1,
    )
    n_unique = starts.sum().astype(jnp.int32)

    # (kmer, label) pair starts: new kmer OR new label within the run
    prev_lab = jnp.concatenate([slab[:1] - 1, slab[:-1]])
    pair_starts = svalid & (starts | (slab != prev_lab))

    slot = jnp.arange(n, dtype=jnp.int32)
    is_unique = slot < n_unique
    passes = is_unique & (counts >= min_obs)
    n_valid, (vkmers, vexts, vcounts) = S.compact(passes, [ukmers, uexts, counts])

    # renumber pair kmer ids into compacted slots, drop censored kmers
    new_slot = jnp.cumsum(passes.astype(jnp.int32)) - 1  # by old slot id
    segc = jnp.clip(seg, 0, n - 1)
    pair_keep = pair_starts & passes[segc]
    n_pairs, (pair_kmer, pair_label) = S.compact(
        pair_keep, [new_slot[segc], slab]
    )

    table = KmerTableDev(
        spec=spec,
        stranded=stranded,
        kmers=vkmers,
        exts=vexts,
        counts=vcounts,
        data=jnp.zeros_like(vcounts),
        n_valid=n_valid,
        all_kmers=ukmers,
        all_n=n_unique,
    )
    return table, pair_kmer, pair_label, n_pairs


@partial(jax.jit, static_argnums=(0, 1, 2))
def _count_kmers_sets_jit(spec, stranded, min_obs, bases, lengths, seq_exts, labels):
    return count_kmers_sets(
        spec, bases, lengths, seq_exts, labels, stranded=stranded, min_obs=min_obs
    )


def filter_kmers_set(
    seqs,
    k: int,
    *,
    stranded: bool = False,
    min_obs: int = 1,
):
    """Host API: CountFilterSet (filter.rs:68-101) — each kmer's data is
    the sorted, deduplicated list of labels ("colors") it was observed
    with.  Returns (KmerTable, label_sets: list of tuples aligned with
    table rows).
    """
    spec = KmerSpec(k)
    items = [s for s in seqs if len(s[0]) >= k]
    if not items:
        return (
            KmerTable(
                spec, stranded,
                np.zeros((0, spec.w), np.uint32), np.zeros(0, np.int32),
                np.zeros(0, np.int32), np.zeros(0, np.int32),
            ),
            [],
        )
    bases, lengths = pad_reads([s[0] for s in items], min_len=k, pad_to=16)
    seq_exts = np.array([s[1] for s in items], dtype=np.int32)
    labels = np.array([s[2] for s in items], dtype=np.int32)
    dev, pair_kmer, pair_label, n_pairs = _count_kmers_sets_jit(
        spec, stranded, min_obs, bases, lengths, seq_exts, labels
    )
    n = int(dev.n_valid)
    np_ = int(n_pairs)
    pk = np.asarray(pair_kmer)[:np_]
    plb = np.asarray(pair_label)[:np_]
    # pk is sorted by table slot; searchsorted splits give each slot's
    # (already sorted, deduped) label run without a per-kmer scan
    split = np.searchsorted(pk, np.arange(n + 1))
    plist = plb.tolist()
    sets: List[tuple] = [
        tuple(plist[split[i] : split[i + 1]]) for i in range(n)
    ]
    table = KmerTable(
        spec=spec,
        stranded=stranded,
        kmers=np.asarray(dev.kmers[:n]),
        exts=np.asarray(dev.exts[:n]),
        counts=np.asarray(dev.counts[:n]),
        data=np.zeros(n, np.int32),
    )
    return table, sets


def assign_eq_classes(
    pair_kmer: np.ndarray,
    pair_label: np.ndarray,
    n: int,
    *,
    dense_limit: int = 1 << 26,
):
    """Vectorized eq-class assignment from sorted (kmer-slot, label) pairs.

    ``pair_kmer`` is sorted ascending with ``pair_label`` sorted within
    each slot (exactly :func:`filter_kmers_set`'s device output), so each
    slot's label SET is a contiguous run.  Ids are assigned in first-
    appearance order over slots 0..n-1 (the reference's discovery-order
    semantics, CountFilterEqClass's HashMap insertion order).

    Small inputs build a dense (n, maxlen) signature matrix and row-unique
    it; when ``n * maxlen > dense_limit`` elements (the dense matrix would
    exceed ~``8 * dense_limit`` bytes, e.g. 1M kmers x 1000 samples) the
    runs are instead hashed to 128-bit digests (two independent 64-bit
    polynomial hashes + the run length) and the digests are uniqued —
    O(n + P) memory regardless of set width, with collision probability
    ~n^2 / 2^128.

    Returns (ids (n,) int32, eq_classes list of label tuples).
    """
    split = np.searchsorted(pair_kmer, np.arange(n + 1))
    lens = np.diff(split)
    if n == 0:
        return np.zeros(0, np.int32), []
    maxlen = int(lens.max(initial=0))
    if n * max(maxlen, 1) > dense_limit:
        return _assign_eq_classes_hashed(pair_label, split, lens, n)
    # padded signature matrix: row per slot = labels then -1 padding
    rows = np.full((n, maxlen), -1, np.int64)
    if len(pair_label):
        col = np.arange(len(pair_label)) - np.repeat(split[:-1], lens)
        rows[np.repeat(np.arange(n), lens), col] = pair_label
    uniq, first_idx, inv = np.unique(
        rows, axis=0, return_index=True, return_inverse=True
    )
    # renumber sorted-unique ids into first-appearance (discovery) order
    order = np.argsort(first_idx, kind="stable")
    remap = np.empty(len(uniq), np.int32)
    remap[order] = np.arange(len(uniq), dtype=np.int32)
    ids = remap[inv].astype(np.int32)
    eq_classes = []
    for u in order:
        r = uniq[u]
        eq_classes.append(tuple(int(x) for x in r[r >= 0]))
    return ids, eq_classes


def _assign_eq_classes_hashed(pair_label, split, lens, n):
    """Scale-safe eq-class grouping: order-sensitive polynomial digests of
    each slot's label run instead of a dense signature matrix.

    Runs are already sorted + deduplicated, so equal SETS produce equal
    sequences and therefore equal digests.  Two independent 64-bit hashes
    plus the exact run length make accidental collisions ~n^2 / 2^128.
    """
    P = len(pair_label)
    labs = pair_label.astype(np.uint64) + np.uint64(1)  # avoid 0-absorption
    if P:
        col = (np.arange(P, dtype=np.int64) - np.repeat(split[:-1], lens)).astype(
            np.uint64
        )
        h = np.zeros((n, 2), np.uint64)
        with np.errstate(over="ignore"):
            for j, r in enumerate(
                (np.uint64(0x9E3779B97F4A7C15), np.uint64(0xC2B2AE3D27D4EB4F))
            ):
                # r^col via exponentiation of the per-position exponent in
                # log-steps (wraparound mod 2^64 is the hash ring)
                pw = np.ones(P, np.uint64)
                base = r
                c = col.copy()
                while c.any():
                    odd = (c & np.uint64(1)).astype(bool)
                    pw[odd] *= base
                    base = base * base
                    c >>= np.uint64(1)
                terms = labs * pw
                nonempty = lens > 0
                acc = np.zeros(n, np.uint64)
                sums = np.add.reduceat(terms, split[:-1][nonempty])
                acc[nonempty] = sums
                h[:, j] = acc
    else:
        h = np.zeros((n, 2), np.uint64)
    sig = np.column_stack([h, lens.astype(np.uint64)])
    uniq, first_idx, inv = np.unique(
        sig, axis=0, return_index=True, return_inverse=True
    )
    order = np.argsort(first_idx, kind="stable")
    remap = np.empty(len(uniq), np.int32)
    remap[order] = np.arange(len(uniq), dtype=np.int32)
    ids = remap[inv.reshape(-1)].astype(np.int32)
    eq_classes = []
    for u in order:
        s = int(first_idx[u])
        eq_classes.append(
            tuple(int(x) for x in pair_label[split[s] : split[s + 1]])
        )
    return ids, eq_classes


def filter_kmers_set_arrays(
    seqs,
    k: int,
    *,
    stranded: bool = False,
    min_obs: int = 1,
):
    """Array-native CountFilterSet: no per-kmer Python tuples.

    Returns (KmerTable, pair_label (P,) int32, split (n+1,) int64): the
    label SET of table row i is ``pair_label[split[i]:split[i+1]]``
    (sorted, deduplicated).  This is the scale-safe variant of
    :func:`filter_kmers_set` — a 100M-kmer colored run never materializes
    Python objects.
    """
    spec = KmerSpec(k)
    items = [s for s in seqs if len(s[0]) >= k]
    if not items:
        return (
            KmerTable(
                spec, stranded,
                np.zeros((0, spec.w), np.uint32), np.zeros(0, np.int32),
                np.zeros(0, np.int32), np.zeros(0, np.int32),
            ),
            np.zeros(0, np.int32),
            np.zeros(1, np.int64),
        )
    bases, lengths = pad_reads([s[0] for s in items], min_len=k, pad_to=16)
    seq_exts = np.array([s[1] for s in items], dtype=np.int32)
    labels = np.array([s[2] for s in items], dtype=np.int32)
    dev, pair_kmer, pair_label, n_pairs = _count_kmers_sets_jit(
        spec, stranded, min_obs, bases, lengths, seq_exts, labels
    )
    n = int(dev.n_valid)
    np_ = int(n_pairs)
    pk = np.asarray(pair_kmer)[:np_]
    plb = np.asarray(pair_label)[:np_]
    split = np.searchsorted(pk, np.arange(n + 1)).astype(np.int64)
    table = KmerTable(
        spec=spec,
        stranded=stranded,
        kmers=np.asarray(dev.kmers[:n]),
        exts=np.asarray(dev.exts[:n]),
        counts=np.asarray(dev.counts[:n]),
        data=np.zeros(n, np.int32),
    )
    return table, plb, split


def filter_kmers_eq_classes(
    seqs,
    k: int,
    *,
    stranded: bool = False,
    min_obs: int = 1,
):
    """CountFilterEqClass-style summarizer (the Cell Ranger pattern built
    on the reference's KmerSummarizer trait, filter.rs:27-38): kmers with
    identical label sets share an equivalence-class id.

    Fully vectorized: the device returns sorted (kmer, label) pairs and
    :func:`assign_eq_classes` groups them with numpy row-unique — no
    per-kmer Python loop, so million-kmer colored corpora classify in
    seconds.

    Returns (KmerTable with data = eq-class id, eq_classes: list of label
    tuples indexed by id).
    """
    spec = KmerSpec(k)
    items = [s for s in seqs if len(s[0]) >= k]
    if not items:
        return (
            KmerTable(
                spec, stranded,
                np.zeros((0, spec.w), np.uint32), np.zeros(0, np.int32),
                np.zeros(0, np.int32), np.zeros(0, np.int32),
            ),
            [],
        )
    bases, lengths = pad_reads([s[0] for s in items], min_len=k, pad_to=16)
    seq_exts = np.array([s[1] for s in items], dtype=np.int32)
    labels = np.array([s[2] for s in items], dtype=np.int32)
    dev, pair_kmer, pair_label, n_pairs = _count_kmers_sets_jit(
        spec, stranded, min_obs, bases, lengths, seq_exts, labels
    )
    n = int(dev.n_valid)
    np_ = int(n_pairs)
    ids, eq_classes = assign_eq_classes(
        np.asarray(pair_kmer)[:np_], np.asarray(pair_label)[:np_], n
    )
    table = KmerTable(
        spec=spec,
        stranded=stranded,
        kmers=np.asarray(dev.kmers[:n]),
        exts=np.asarray(dev.exts[:n]),
        counts=np.asarray(dev.counts[:n]),
        data=ids,
    )
    return table, eq_classes


@partial(jax.jit, static_argnums=(0, 1))
def _sorted_obs_jit(spec, stranded, bases, lengths, seq_exts, labels):
    """Device half of the pluggable-summarizer path: every kmer observation,
    canonicalized and lexicographically sorted (equal kmers adjacent)."""
    kmers, exts, valid = extract_canonical(spec, bases, lengths, seq_exts,
                                           stranded)
    n = kmers.shape[0] * kmers.shape[1]
    kf = kmers.reshape(n, spec.w)
    ef = exts.reshape(n)
    vf = valid.reshape(n)
    lab = jnp.broadcast_to(
        jnp.asarray(labels, jnp.int32)[:, None], valid.shape
    ).reshape(n)
    slimbs, svalid, sexts, slab = sort_observations(spec, kf, ef, lab, vf)
    if spec.pad >= 1:
        # clear the validity flag bit: these limbs are returned to the host
        slimbs = [slimbs[0] & spec.top_mask] + slimbs[1:]
    return (
        S.keys_to_limbs(slimbs),
        sexts,
        slab,
        vf.sum().astype(jnp.int32),
    )


class KmerSummarizer:
    """The pluggable per-kmer reduction (KmerSummarizer trait,
    filter.rs:27-38).  ``summarize(kmer, exts, payloads)`` receives every
    observation of one kmer — the canonical ``kmer`` limbs (W,) uint32,
    ``exts`` (m,) int extension bytes, and ``payloads``, the list of m
    per-observation data objects (arbitrary ``D``, exactly the reference
    trait's ``Iterator<Item = (K, Exts, D)>`` power) — and returns
    ``(is_valid, folded_exts, summary_data)``.
    """

    def summarize(self, kmer: np.ndarray, exts: np.ndarray, payloads: list):
        raise NotImplementedError


class CountFilter(KmerSummarizer):
    """count >= min_obs; data = u16-saturated count (filter.rs:40-63)."""

    def __init__(self, min_obs: int):
        self.min_obs = min_obs

    def summarize(self, kmer, exts, payloads):
        count = min(len(exts), 65535)
        return count >= self.min_obs, int(np.bitwise_or.reduce(exts)), count


class CountFilterSet(KmerSummarizer):
    """data = sorted deduplicated payload tuple (filter.rs:68-101)."""

    def __init__(self, min_obs: int):
        self.min_obs = min_obs

    def summarize(self, kmer, exts, payloads):
        return (
            len(exts) >= self.min_obs,
            int(np.bitwise_or.reduce(exts)),
            tuple(sorted(set(payloads))),
        )


class CountFilterEqClass(KmerSummarizer):
    """data = equivalence-class id over payload sets (the Cell Ranger
    pattern built on the reference's trait); ``self.eq_classes`` maps
    payload tuple -> id."""

    def __init__(self, min_obs: int):
        self.min_obs = min_obs
        self.eq_classes: dict = {}

    def summarize(self, kmer, exts, payloads):
        key = tuple(sorted(set(payloads)))
        eq_id = self.eq_classes.setdefault(key, len(self.eq_classes))
        return len(exts) >= self.min_obs, int(np.bitwise_or.reduce(exts)), eq_id


def filter_kmers_with_summarizer(
    seqs,
    k: int,
    summarizer: KmerSummarizer,
    *,
    stranded: bool = False,
    report_all: bool = False,
):
    """Fully pluggable filter_kmers (filter.rs:139): arbitrary Python
    summarizers, exactly the reference trait's power.

    ``seqs`` items are ``(bases, seq_exts, payload)`` where ``payload``
    may be ANY object (the reference's arbitrary ``D``, filter.rs:27-38)
    — it is carried per observation and handed back to the summarizer.

    The device does the heavy lifting (extraction, canonicalization, the
    sort that groups equal kmers); the host walks groups and calls
    ``summarizer.summarize(kmer, exts, payloads)``.  The fast paths
    (:func:`filter_kmers`, :func:`filter_kmers_set`) cover the built-in
    summarizers entirely on-device — use this for custom policies.

    Returns (KmerTable, data_list) where data_list holds each valid kmer's
    summary object (table.data gets the int cast when possible).
    """
    spec = KmerSpec(k)
    items = [s for s in seqs if len(s[0]) >= k]
    empty = KmerTable(
        spec, stranded,
        np.zeros((0, spec.w), np.uint32), np.zeros(0, np.int32),
        np.zeros(0, np.int32), np.zeros(0, np.int32),
    )
    if not items:
        return empty, []
    bases, lengths = pad_reads([s[0] for s in items], min_len=k, pad_to=16)
    seq_exts = np.array([s[1] for s in items], dtype=np.int32)
    payloads = [s[2] for s in items]
    # the device carries the item INDEX; payload objects stay host-side
    labels = np.arange(len(items), dtype=np.int32)
    d_kmers, d_exts, d_labs, n_obs = _sorted_obs_jit(
        spec, stranded, bases, lengths, seq_exts, labels
    )
    n = int(n_obs)
    kmers = np.asarray(d_kmers)[:n]
    exts = np.asarray(d_exts)[:n]
    labs = np.asarray(d_labs)[:n]
    if n == 0:
        return empty, []
    new = np.ones(n, bool)
    new[1:] = (kmers[1:] != kmers[:-1]).any(axis=1)
    starts = np.nonzero(new)[0]
    ends = np.append(starts[1:], n)

    out_k, out_e, out_d, out_c = [], [], [], []
    all_rows = []
    for s, e in zip(starts, ends):
        ok, fexts, data = summarizer.summarize(
            kmers[s], exts[s:e], [payloads[j] for j in labs[s:e]]
        )
        if report_all:
            all_rows.append(kmers[s])
        if ok:
            out_k.append(kmers[s])
            out_e.append(fexts)
            out_d.append(data)
            out_c.append(min(e - s, 65535))
    table = KmerTable(
        spec=spec,
        stranded=stranded,
        kmers=np.array(out_k, np.uint32).reshape(-1, spec.w),
        exts=np.array(out_e, np.int32),
        counts=np.array(out_c, np.int32),
        data=np.array(
            [d if isinstance(d, (int, np.integer)) else 0 for d in out_d],
            np.int32,
        ),
        all_kmers=np.array(all_rows, np.uint32).reshape(-1, spec.w)
        if report_all
        else None,
    )
    return table, out_d


def remove_censored_exts_device(
    spec: KmerSpec,
    stranded: bool,
    kmers,
    exts,
    n_valid,
    all_kmers=None,
    all_n=None,
):
    """Drop extensions pointing at censored kmers (filter.rs:238-306).

    With ``all_kmers`` given: sharded semantics — an extension is censored
    only if its target is present in the census but not valid
    (remove_censored_exts_sharded, filter.rs:238-276).  Without: global
    semantics — keep only extensions onto valid kmers (filter.rs:280-306).
    """
    new_exts = jnp.zeros_like(exts)
    for d in (E.LEFT, E.RIGHT):
        for b in range(4):
            has = E.has_ext(exts, d, b)
            cand = (
                KM.extend_left(spec, kmers, b)
                if d == E.LEFT
                else KM.extend_right(spec, kmers, b)
            )
            if not stranded:
                cand = KM.min_rc(spec, cand)
            _, found_valid = S.searchsorted_limbs(kmers, cand, n_valid)
            if all_kmers is not None:
                _, found_all = S.searchsorted_limbs(all_kmers, cand, all_n)
                censored = (~found_valid) & found_all
                keep = has & ~censored
            else:
                keep = has & found_valid
            new_exts = jnp.where(keep, E.set_ext(new_exts, d, b), new_exts)
    return new_exts


def remove_censored_exts(table) -> None:
    """Global censored-ext repair (filter.rs:280-306): keep only
    extensions onto valid kmers.  Mutates ``table.exts`` in place."""
    n = len(table.kmers)
    if n == 0:
        return
    new = remove_censored_exts_device(
        table.spec,
        table.stranded,
        jnp.asarray(table.kmers),
        jnp.asarray(table.exts),
        jnp.int32(n),
    )
    table.exts = np.asarray(new)


def remove_censored_exts_sharded(table) -> None:
    """Sharded repair (filter.rs:238-276): drop extensions whose target is
    in this shard's census but invalid; keep cross-shard unknowns.
    Requires the table was built with ``report_all=True``."""
    n = len(table.kmers)
    if n == 0:
        return
    if table.all_kmers is None:
        raise ValueError("table has no census; build with report_all=True")
    new = remove_censored_exts_device(
        table.spec,
        table.stranded,
        jnp.asarray(table.kmers),
        jnp.asarray(table.exts),
        jnp.int32(n),
        jnp.asarray(table.all_kmers),
        jnp.int32(len(table.all_kmers)),
    )
    table.exts = np.asarray(new)


# ---------------------------------------------------------------------------
# host-facing API
# ---------------------------------------------------------------------------


def pad_reads(
    seqs: Sequence[np.ndarray], min_len: int, pad_to: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack variable-length base arrays into a padded (R, L) matrix."""
    if not seqs:
        raise ValueError("no sequences")
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    l = max(int(lengths.max()), min_len)
    if pad_to:
        l = -(-l // pad_to) * pad_to
    out = np.zeros((len(seqs), l), dtype=np.uint8)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = np.asarray(s, dtype=np.uint8)
    return out, lengths


@dataclasses.dataclass
class PackedReadBlock:
    """A pre-batched, 2-bit PACKED read block for streaming ingestion.

    ``packed``: (m, width//4) uint8 rows, 4 bases/byte, little-endian
    within the byte (filter._unpack2bit layout — the device streaming
    upload format; the native FASTX batch extractor emits it directly).
    ``lengths``: (m,) unpacked read lengths.  ``width``: unpacked row
    width in bases (multiple of 16).  ``seq_exts``/``label``: scalar or
    (m,) arrays, as in the plain block tuple.
    """

    packed: np.ndarray
    lengths: np.ndarray
    width: int
    seq_exts: object = 0
    label: object = 0


@dataclasses.dataclass
class KmerTable:
    """Host view of a filtered kmer table (trimmed numpy arrays)."""

    spec: KmerSpec
    stranded: bool
    kmers: np.ndarray  # (n, W)
    exts: np.ndarray  # (n,)
    counts: np.ndarray  # (n,)
    data: np.ndarray  # (n,)
    all_kmers: Optional[np.ndarray] = None

    def __len__(self):
        return len(self.kmers)

    def kmer_ints(self) -> List[int]:
        return [KM.to_int(self.spec, self.kmers[i]) for i in range(len(self))]

    # -- lookups (BoomHashMap2 surface: filter.rs:9,228; boomphf get) -----
    def get_key_id(self, kmer_limbs) -> Optional[int]:
        """Slot id of a kmer, or None (Mphf::try_hash equivalent).

        The table is sorted by kmer, so the id is found by binary search
        (the engine's replacement for the MPHF; SURVEY.md §1).
        """
        q = np.asarray(kmer_limbs, np.uint32).reshape(self.spec.w)
        lo, hi = 0, len(self.kmers)
        while lo < hi:
            mid = (lo + hi) // 2
            row = self.kmers[mid]
            c = 0
            for a, b in zip(row, q):
                if a != b:
                    c = -1 if a < b else 1
                    break
            if c < 0:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(self.kmers) and np.array_equal(self.kmers[lo], q):
            return lo
        return None

    def get(self, kmer_limbs):
        """(exts, data) of a kmer, or None (BoomHashMap2::get)."""
        i = self.get_key_id(kmer_limbs)
        if i is None:
            return None
        return int(self.exts[i]), int(self.data[i])

    def get_key(self, i: int) -> np.ndarray:
        """Kmer limbs at slot i (BoomHashMap2::get_key)."""
        return self.kmers[i]

    def to_tuples(self):
        return [
            (KM.to_int(self.spec, self.kmers[i]), int(self.exts[i]), int(self.counts[i]))
            for i in range(len(self))
        ]

    # -- checkpoint (serde parity: kmers/exts derive Serialize, kmer.rs:231)
    def save(self, path) -> None:
        np.savez_compressed(
            path,
            k=self.spec.k,
            stranded=self.stranded,
            kmers=self.kmers,
            exts=self.exts,
            counts=self.counts,
            data=self.data,
            **(
                {"all_kmers": self.all_kmers}
                if self.all_kmers is not None
                else {}
            ),
        )

    @staticmethod
    def load(path) -> "KmerTable":
        z = np.load(path)
        return KmerTable(
            spec=KmerSpec(int(z["k"])),
            stranded=bool(z["stranded"]),
            kmers=z["kmers"],
            exts=z["exts"],
            counts=z["counts"],
            data=z["data"],
            all_kmers=z["all_kmers"] if "all_kmers" in z else None,
        )


def filter_kmers(
    seqs,
    k: int,
    *,
    stranded: bool = False,
    min_obs: int = 1,
    report_all: bool = False,
    data_reduce: str = "label_first",
) -> KmerTable:
    """Host wrapper: list of (bases, seq_exts, label) -> KmerTable.

    Mirrors filter_kmers (filter.rs:139) with a CountFilter(min_obs)
    summarizer; counts are carried alongside whatever ``data_reduce``
    produces from the labels.
    """
    spec = KmerSpec(k)
    items = [s for s in seqs if len(s[0]) >= k]
    if not items:
        return KmerTable(
            spec,
            stranded,
            np.zeros((0, spec.w), np.uint32),
            np.zeros(0, np.int32),
            np.zeros(0, np.int32),
            np.zeros(0, np.int32),
            all_kmers=np.zeros((0, spec.w), np.uint32) if report_all else None,
        )
    bases, lengths = pad_reads([s[0] for s in items], min_len=k, pad_to=16)
    seq_exts = np.array([s[1] for s in items], dtype=np.int32)
    labels = np.array([s[2] for s in items], dtype=np.int32)

    log.debug(
        "filter_kmers: %d reads (padded %s), K=%d stranded=%s min_obs=%d",
        len(items), bases.shape, k, stranded, min_obs,
    )
    dev = _count_kmers_jit(
        spec, stranded, min_obs, data_reduce, report_all,
        bases, lengths, seq_exts, labels
    )
    n = int(dev.n_valid)
    log.debug("filter_kmers: %d valid kmers (census %d)", n, int(dev.all_n))
    table = KmerTable(
        spec=spec,
        stranded=stranded,
        kmers=np.asarray(dev.kmers[:n]),
        exts=np.asarray(dev.exts[:n]),
        counts=np.asarray(dev.counts[:n]),
        data=np.asarray(dev.data[:n]),
    )
    if report_all:
        table.all_kmers = np.asarray(dev.all_kmers[: int(dev.all_n)])
    return table


_MERGE_FLAG = jnp.int32(1 << 30)


def _seg_sum_or_suffix(packed, is_end):
    """Suffix segmented reduce of ``(count << 8) | exts`` lanes: at each
    element, (u16-saturating count sum, exts OR) from the element through
    its segment's END — one packed int32 associative scan.

    Early u16 saturation commutes with the final ``min(sum, 65535)`` the
    API promises (min-of-sums == min-of-saturating-sums), so the count
    stays in 16 bits throughout.
    """
    x = jnp.where(is_end, packed | _MERGE_FLAG, packed)[::-1]

    def comb(a, b):
        cnt = jnp.minimum(((a >> 8) & 0xFFFF) + ((b >> 8) & 0xFFFF), 65535)
        merged = (cnt << 8) | ((a | b) & 0xFF) | (a & _MERGE_FLAG)
        return jnp.where((b & _MERGE_FLAG) != 0, b | (a & _MERGE_FLAG), merged)

    return (jax.lax.associative_scan(comb, x) & ~_MERGE_FLAG)[::-1]


def _merge_sorted_core(spec, cols, val_all, pay_all, c_out):
    """Shared tail of the device merges: one sort over the concatenated
    rows, packed (count<<8)|exts segmented suffix reduce, partition of
    run starts; output trimmed to ``c_out`` rows."""
    w = spec.w
    if spec.pad >= 1:
        flag = jnp.where(val_all, np.uint32(0), np.uint32(1 << 31))
        keys = [cols[0] | flag] + cols[1:]
        out = jax.lax.sort(keys + [pay_all], num_keys=w, is_stable=False)
        svalid = (out[0] >> np.uint32(31)) == 0
        slimbs = [out[0] & spec.top_mask] + list(out[1:w])
    else:
        inv = (~val_all).astype(jnp.uint32)
        out = jax.lax.sort([inv] + cols + [pay_all], num_keys=w + 1,
                           is_stable=False)
        svalid = out[0] == 0
        slimbs = list(out[1 : w + 1])
    spacked = out[-1]

    starts = S.run_starts(slimbs, svalid)
    nxt_boundary = jnp.concatenate(
        [starts[1:] | ~svalid[1:], jnp.ones(1, bool)]
    )
    is_end = svalid & nxt_boundary
    agg = _seg_sum_or_suffix(spacked, is_end)
    n_new = starts.sum().astype(jnp.int32)
    _, vout = S.partition(starts, slimbs + [agg])
    new_kmers = S.keys_to_limbs([v[:c_out] for v in vout[:w]])
    new_packed = vout[w][:c_out]
    return new_kmers, new_packed, n_new


@partial(jax.jit, static_argnums=(0,))
def _merge_tables_jit(spec, s_kmers, s_packed, s_n, c_kmers, c_exts,
                      c_counts, c_n):
    """Merge a PRE-DEDUPED sorted chunk table into the device-resident
    accumulated table: a C + U row program (U = chunk-unique capacity)
    instead of C + R*Lk — the two-level shape that keeps every compiled
    program small no matter how the corpus grows.  The chunk dedupe itself is the already-compiled count program.

    SELF-GUARDING: if the merged unique count exceeds C, or the chunk's
    unique count exceeds U (its rows were truncated by the caller's
    slice), the state is returned UNCHANGED — the caller detects the
    dropped merge from the returned (n_new, c_n) diagnostics (possibly
    several chunks later, so readbacks never block the stream), grows
    capacity, and replays exactly the dropped chunks.

    Returns (kmers (C, W), packed (C,), n, n_new, applied).
    """
    w = spec.w
    c = s_kmers.shape[0]
    u = c_kmers.shape[0]
    c_packed = (jnp.minimum(c_counts, 65535) << 8) | (c_exts & 0xFF)
    val_all = jnp.concatenate([
        jnp.arange(c, dtype=jnp.int32) < s_n,
        jnp.arange(u, dtype=jnp.int32) < jnp.minimum(c_n, u),
    ])
    pay_all = jnp.concatenate([s_packed, c_packed])
    cols = [
        jnp.concatenate([s_kmers[:, i], c_kmers[:, i]]) for i in range(w)
    ]
    nk, npk, n_new = _merge_sorted_core(spec, cols, val_all, pay_all, c)
    ok = (n_new <= c) & (c_n <= u)
    out_k = jnp.where(ok, nk, s_kmers)
    out_p = jnp.where(ok, npk, s_packed)
    out_n = jnp.where(ok, n_new, s_n)
    return out_k, out_p, out_n, n_new, ok


def _block_compact(starts, arrays, n_blocks, out_cols, sentinels):
    """Compact start rows to the front of each of ``n_blocks`` contiguous
    chunks via ONE batched per-chunk sort, then slice to ``out_cols``.

    A batched (n_blocks, m) sort is assumed far cheaper than the global
    partition sort (untested on the GPU, see ROADMAP) — chunk
    locality is free here because the input is globally sorted, so
    per-chunk compaction preserves global key order across chunk
    boundaries.  Non-start and sliced-away rows become SENTINELS
    (all-ones keys / zero payloads), which downstream sorts push to the
    tail and aggregations ignore (zero counts).

    Returns (compacted arrays flattened to (n_blocks*out_cols,),
    chunk_counts (n_blocks,), ok scalar).
    """
    n = starts.shape[0]
    b = n_blocks
    m = n // b
    col = jnp.arange(m, dtype=jnp.uint32)
    key = jnp.where(
        starts.reshape(b, m), np.uint32(0), np.uint32(1 << 31)
    ) | col[None, :]
    blocked = [a.reshape(b, m) for a in arrays]
    out = jax.lax.sort([key] + blocked, dimension=1, num_keys=1,
                       is_stable=False)
    chunk_counts = starts.reshape(b, m).sum(axis=1).astype(jnp.int32)
    oc = min(out_cols, m)  # chunks shorter than out_cols fit trivially
    live = col[None, :oc].astype(jnp.int32) < chunk_counts[:, None]
    res = []
    for a, sent in zip(out[1:], sentinels):
        sl = jnp.where(live, a[:, :oc], sent)
        if out_cols > m:
            sl = jnp.concatenate(
                [sl, jnp.full((b, out_cols - m), sent, a.dtype)], axis=1
            )
        res.append(sl.reshape(b * out_cols))
    ok = (chunk_counts <= out_cols).all()
    return res, chunk_counts, ok


def count_kmers_blocks(
    spec: KmerSpec,
    bases,
    lengths,
    seq_exts,
    *,
    stranded: bool,
    out_cols: int,
    n_blocks: int = 256,
    labels=None,
):
    """The streaming-merge count program: per-batch kmer dedup emitting a
    BLOCK-COMPACTED sentinel-encoded table (filter.rs:139-231 semantics,
    CountFilter shape — counts only).

    Pipeline: extract -> canonicalize -> ONE W-key sentinel sort (no
    validity flag arrays at all: invalid rows become all-ones kmers with
    zero payloads and sort to the tail) -> ONE packed (count<<8)|exts
    suffix scan -> block-compaction (batched per-chunk sort in place of
    the global partition).

    Returns (limbs (n_blocks*out_cols, W), packed (n_blocks*out_cols,),
    n_unique, ok) — plus a label array before ``packed`` when ``labels``
    is given.  Rows are globally sorted among live rows; dead rows
    are all-ones/zero sentinels.  ``ok`` False means some chunk had more
    unique kmers than ``out_cols`` and the output is truncated — the
    caller must grow ``out_cols`` and retry (the self-guarding merge
    refuses truncated chunks).

    With ``labels`` (per-read int32 color ids), rows are (kmer, label)
    PAIRS: the label rides as one more sort key below the kmer limbs —
    the CountFilterSet data model (filter.rs:68-101) in streaming form.
    The all-ones sentinel label (0xFFFFFFFF, outside the int32 label
    range) keeps even poly-T pairs unambiguous.
    """
    kmers, exts, valid = extract_canonical(spec, bases, lengths, seq_exts,
                                           stranded)
    n = kmers.shape[0] * kmers.shape[1]
    w = spec.w
    kf = kmers.reshape(n, w)
    ef = exts.reshape(n)
    vf = valid.reshape(n)

    keys = [
        jnp.where(vf, kf[:, i], np.uint32(0xFFFFFFFF)) for i in range(w)
    ]
    if labels is not None:
        lab = jnp.broadcast_to(
            jnp.asarray(labels, jnp.int32)[:, None], valid.shape
        ).reshape(n)
        keys.append(
            jnp.where(vf, lab.astype(jnp.uint32), np.uint32(0xFFFFFFFF))
        )
    nk = len(keys)
    packed = jnp.where(vf, (jnp.int32(1) << 8) | (ef & 0xFF), 0)
    out = jax.lax.sort(keys + [packed], num_keys=nk, is_stable=False)
    slimbs, spacked = list(out[:nk]), out[nk]

    prev = [jnp.concatenate([kk[:1], kk[:-1]]) for kk in slimbs]
    differs = ~S.lex_eq(slimbs, prev)
    starts = differs.at[0].set(True)
    is_end = jnp.concatenate([differs[1:], jnp.ones(1, bool)])
    agg = _seg_sum_or_suffix(spacked, is_end)
    # the all-ones run head is a start but aggregates to count 0 when it
    # holds only sentinels; with no pad bits a REAL poly-T kmer shares
    # the sentinel value and the head row then carries its true count —
    # live rows are exactly those with a count (packed >= 256)
    n_unique = (starts & (agg >= 256)).sum().astype(jnp.int32)

    res, _, ok = _block_compact(
        starts, slimbs + [agg], n_blocks, out_cols,
        [np.uint32(0xFFFFFFFF)] * nk + [jnp.int32(0)],
    )
    climbs = S.keys_to_limbs(res[:w])
    if labels is not None:
        return climbs, res[w], res[nk], n_unique, ok
    return climbs, res[w], n_unique, ok


def _unpack2bit(packed, l: int):
    """(R, L//4) uint8 host-packed reads -> (R, L) 2-bit codes.

    The streaming loop uploads PACKED reads: 4 bases/byte moves a
    quarter of the host-to-device bytes of raw codes; unpacking is one
    fused elementwise pass on device."""
    r = packed.shape[0]
    shifts = np.uint8(2) * jnp.arange(4, dtype=jnp.uint8)
    out = (packed[:, :, None] >> shifts[None, None, :]) & np.uint8(3)
    return out.reshape(r, l)


@partial(jax.jit, static_argnums=(0, 1, 2))
def _count_kmers_blocks_jit(spec, stranded, out_cols, bases, lengths, seq_exts):
    return count_kmers_blocks(
        spec, bases, lengths, seq_exts, stranded=stranded, out_cols=out_cols
    )


@partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _count_kmers_blocks_packed_jit(spec, stranded, out_cols, l, packed,
                                   lengths, seq_exts):
    return count_kmers_blocks(
        spec, _unpack2bit(packed, l), lengths, seq_exts,
        stranded=stranded, out_cols=out_cols,
    )


@partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _count_kmers_blocks_packed_colored_jit(spec, stranded, out_cols, l,
                                           packed, lengths, seq_exts, labels):
    return count_kmers_blocks(
        spec, _unpack2bit(packed, l), lengths, seq_exts,
        stranded=stranded, out_cols=out_cols, labels=labels,
    )


@partial(jax.jit, static_argnums=(0, 1, 2))
def _count_kmers_blocks_colored_jit(spec, stranded, out_cols, bases, lengths,
                                    seq_exts, labels):
    return count_kmers_blocks(
        spec, bases, lengths, seq_exts, stranded=stranded, out_cols=out_cols,
        labels=labels,
    )


def _merge_blocks(spec, s_kmers, s_packed, c_kmers, c_packed, n_blocks,
                  c_ok, s_labels=None, c_labels=None):
    """Fold a sentinel-encoded block table into the sentinel-encoded
    device state: ONE sort over C+U rows (sentinels need no validity
    arrays), ONE packed suffix scan, block-compaction back to C rows.
    Self-guarding: if any output chunk overflows C//n_blocks or the
    incoming chunk was truncated (``c_ok`` False), the state is returned
    unchanged and the caller replays after growing capacity.

    With label arrays, rows are (kmer, label) pairs and the label rides
    as one more sort key (colored streaming, filter.rs:68-101).

    Returns (kmers (C, W), [labels (C,),] packed (C,), n_unique, ok).
    """
    w = spec.w
    c = s_kmers.shape[0]
    colored = s_labels is not None
    cols = [
        jnp.concatenate([s_kmers[:, i], c_kmers[:, i]]) for i in range(w)
    ]
    if colored:
        cols.append(
            jnp.concatenate(
                [s_labels.astype(jnp.uint32), c_labels.astype(jnp.uint32)]
            )
        )
    nk = len(cols)
    pay = jnp.concatenate([s_packed, c_packed])
    out = jax.lax.sort(cols + [pay], num_keys=nk, is_stable=False)
    slimbs, spacked = list(out[:nk]), out[nk]
    prev = [jnp.concatenate([kk[:1], kk[:-1]]) for kk in slimbs]
    differs = ~S.lex_eq(slimbs, prev)
    starts = differs.at[0].set(True)
    is_end = jnp.concatenate([differs[1:], jnp.ones(1, bool)])
    agg = _seg_sum_or_suffix(spacked, is_end)
    n_unique = (starts & (agg >= 256)).sum().astype(jnp.int32)

    res, _, ok = _block_compact(
        starts, slimbs + [agg], n_blocks, c // n_blocks,
        [np.uint32(0xFFFFFFFF)] * nk + [jnp.int32(0)],
    )
    ok = ok & c_ok
    new_k = S.keys_to_limbs(res[:w])
    out_k = jnp.where(ok, new_k, s_kmers)
    out_p = jnp.where(ok, res[nk], s_packed)
    if colored:
        out_l = jnp.where(ok, res[w].astype(jnp.int32), s_labels)
        return out_k, out_l, out_p, n_unique, ok
    return out_k, out_p, n_unique, ok


@partial(jax.jit, static_argnums=(0, 5))
def _merge_blocks_jit(spec, s_kmers, s_packed, c_kmers, c_packed, n_blocks,
                      c_ok):
    return _merge_blocks(spec, s_kmers, s_packed, c_kmers, c_packed,
                         n_blocks, c_ok)


def _merge_blocks_dense(spec, s_kmers, s_packed, c_kmers, c_packed, c_ok,
                        s_labels=None, c_labels=None):
    """Guaranteed-progress merge: same sort + scan as :func:`_merge_blocks`
    but compaction is ONE global partition (start rows to the front,
    dense), so the only overflow is a REAL one (more uniques than state
    capacity).  The per-chunk block compaction is meant to be cheaper but cannot
    fit a contiguous all-unique key range (every first merge, and chunks
    of mostly-new kmers) — the streaming loop runs the block merge
    optimistically and replays refused chunks through this one.

    Returns like _merge_blocks; the output state is dense at the front.
    """
    w = spec.w
    c = s_kmers.shape[0]
    colored = s_labels is not None
    cols = [
        jnp.concatenate([s_kmers[:, i], c_kmers[:, i]]) for i in range(w)
    ]
    if colored:
        cols.append(
            jnp.concatenate(
                [s_labels.astype(jnp.uint32), c_labels.astype(jnp.uint32)]
            )
        )
    nk = len(cols)
    tot = cols[0].shape[0]
    pay = jnp.concatenate([s_packed, c_packed])
    out = jax.lax.sort(cols + [pay], num_keys=nk, is_stable=False)
    slimbs, spacked = list(out[:nk]), out[nk]
    prev = [jnp.concatenate([kk[:1], kk[:-1]]) for kk in slimbs]
    differs = ~S.lex_eq(slimbs, prev)
    starts = differs.at[0].set(True)
    is_end = jnp.concatenate([differs[1:], jnp.ones(1, bool)])
    agg = _seg_sum_or_suffix(spacked, is_end)
    live_start = starts & (agg >= 256)
    n_unique = live_start.sum().astype(jnp.int32)

    key = jnp.arange(tot, dtype=jnp.uint32) | jnp.where(
        live_start, np.uint32(0), np.uint32(1 << 31)
    )
    out2 = jax.lax.sort([key] + slimbs + [agg], num_keys=1, is_stable=False)
    ridx = jnp.arange(c, dtype=jnp.int32)
    live = ridx < n_unique
    new_k = S.keys_to_limbs(
        [
            jnp.where(live, out2[1 + i][:c], np.uint32(0xFFFFFFFF))
            for i in range(w)
        ]
    )
    new_p = jnp.where(live, out2[1 + nk][:c], 0)
    ok = (n_unique <= c) & c_ok
    out_k = jnp.where(ok, new_k, s_kmers)
    out_p = jnp.where(ok, new_p, s_packed)
    if colored:
        new_l = jnp.where(
            live, out2[1 + w][:c].astype(jnp.int32), -1
        )
        out_l = jnp.where(ok, new_l, s_labels)
        return out_k, out_l, out_p, n_unique, ok
    return out_k, out_p, n_unique, ok


@partial(jax.jit, static_argnums=(0,))
def _merge_blocks_dense_jit(spec, s_kmers, s_packed, c_kmers, c_packed, c_ok):
    return _merge_blocks_dense(spec, s_kmers, s_packed, c_kmers, c_packed,
                               c_ok)


@partial(jax.jit, static_argnums=(0,))
def _merge_blocks_dense_colored_jit(spec, s_kmers, s_labels, s_packed,
                                    c_kmers, c_labels, c_packed, c_ok):
    return _merge_blocks_dense(spec, s_kmers, s_packed, c_kmers, c_packed,
                               c_ok, s_labels=s_labels, c_labels=c_labels)


@partial(jax.jit, static_argnums=(0, 7))
def _merge_blocks_colored_jit(spec, s_kmers, s_labels, s_packed, c_kmers,
                              c_labels, c_packed, n_blocks, c_ok):
    return _merge_blocks(spec, s_kmers, s_packed, c_kmers, c_packed,
                         n_blocks, c_ok, s_labels=s_labels, c_labels=c_labels)


@partial(jax.jit, static_argnums=(0,))
def _extract_blocks_state_jit(spec, s_kmers, s_packed):
    """Dense sorted table from the sentinel-gapped block state: one
    partition by liveness (live rows are already in global kmer order)."""
    n = s_kmers.shape[0]
    live = s_packed >= 256
    key = jnp.arange(n, dtype=jnp.uint32) | jnp.where(
        live, np.uint32(0), np.uint32(1 << 31)
    )
    out = jax.lax.sort(
        [key] + [s_kmers[:, i] for i in range(spec.w)] + [s_packed],
        num_keys=1, is_stable=False,
    )
    return (
        S.keys_to_limbs(out[1 : 1 + spec.w]),
        out[1 + spec.w],
        live.sum().astype(jnp.int32),
    )


@partial(jax.jit, static_argnums=(0,))
def _extract_blocks_state_colored_jit(spec, s_kmers, s_labels, s_packed):
    """Colored variant: dense sorted (kmer, label) pair table."""
    n = s_kmers.shape[0]
    live = s_packed >= 256
    key = jnp.arange(n, dtype=jnp.uint32) | jnp.where(
        live, np.uint32(0), np.uint32(1 << 31)
    )
    out = jax.lax.sort(
        [key]
        + [s_kmers[:, i] for i in range(spec.w)]
        + [s_labels, s_packed],
        num_keys=1, is_stable=False,
    )
    return (
        S.keys_to_limbs(out[1 : 1 + spec.w]),
        out[1 + spec.w],
        out[2 + spec.w],
        live.sum().astype(jnp.int32),
    )


def _merge_sorted_parts(spec: KmerSpec, plist, data_reduce: str):
    """Merge sorted-unique partial kmer tables into one (host side).

    Each part is ``(kmers (n, W) sorted unique, exts, counts, data)``;
    counts accumulate in int64 (u16 saturation is applied once, at the
    end of streaming).  ``label_first`` keeps the earliest part's label
    (np.lexsort is stable and parts are concatenated in arrival order).
    """
    kmers = np.concatenate([p[0] for p in plist])
    exts = np.concatenate([p[1] for p in plist])
    counts = np.concatenate([p[2] for p in plist]).astype(np.int64)
    data = np.concatenate([p[3] for p in plist])
    cols = tuple(kmers[:, i] for i in range(spec.w - 1, -1, -1))
    order = np.lexsort(cols)
    kmers, exts, counts, data = kmers[order], exts[order], counts[order], data[order]
    new = np.ones(len(kmers), bool)
    if len(kmers) > 1:
        new[1:] = (kmers[1:] != kmers[:-1]).any(axis=1)
    starts = np.nonzero(new)[0]
    ucounts = np.add.reduceat(counts, starts)
    uexts = np.bitwise_or.reduceat(exts, starts)
    if data_reduce in ("label_first", "none"):
        udata = data[starts]
    elif data_reduce == "min":
        udata = np.minimum.reduceat(data, starts)
    elif data_reduce == "max":
        udata = np.maximum.reduceat(data, starts)
    elif data_reduce == "sum":
        udata = np.add.reduceat(data, starts)
    else:
        raise ValueError(data_reduce)
    return kmers[starts], uexts, ucounts, udata


def filter_kmers_streaming(
    seqs,
    k: int,
    *,
    stranded: bool = False,
    min_obs: int = 1,
    data_reduce: str = "label_first",
    chunk_reads: int = 4096,
    read_len_cap: Optional[int] = None,
    memory_gb: Optional[float] = None,
    merge: str = "host",
    init_capacity: int = 1 << 20,
    unique_capacity: Optional[int] = None,
    colored: bool = False,
):
    """Memory-bounded streaming counting (filter.rs:151-183 equivalent).

    The reference bounds temp memory by multi-pass bucket ranges; here the
    device works in fixed-shape read chunks (one compiled program reused
    for every chunk) and partial sorted tables are merged on the host, so
    device memory is O(chunk) and host memory is O(unique kmers).  Counts
    accumulate globally before the ``min_obs`` threshold is applied, so the
    result equals single-pass ``filter_kmers``.

    ``memory_gb`` mirrors the reference's ``memory_size`` parameter
    (filter.rs:139-145): when given (and ``read_len_cap`` is known or
    derivable), ``chunk_reads`` is sized so the device working set stays
    under that bound.

    ``seqs`` may be any iterable of (bases, seq_exts, label).  Items
    whose ``bases`` is 2-D are treated as pre-batched read blocks
    ``(bases (m, L) uint8, seq_exts (m,)|scalar, label (m,)|scalar
    [, lengths (m,)|None])`` — note seq_exts/label come BEFORE the
    optional lengths, mirroring the per-read tuple order — and bypass
    the per-read Python staging loop — the fast path for high-volume
    streaming.

    ``merge`` selects where partial results accumulate:

    * ``"host"`` (default): each chunk's unique table is pulled to the
      host and LSM-merged in numpy — labels and every ``data_reduce``
      supported.
    * ``"device"``: the unique table stays ON DEVICE (capacity
      ``init_capacity`` rows, grown on demand).  Each chunk is deduped by
      the count program, then folded in with a C + U row table merge
      (U = ``unique_capacity``), so compiled program size never grows
      with the corpus; overflows are detected through lagged, batched
      diagnostics and replayed exactly — the stream never blocks on a
      per-chunk host round trip.  Requires ``data_reduce='none'``.

    ``colored=True`` (requires ``merge='device'``) streams CountFilterSet
    data (filter.rs:68-101): read labels are color ids, the device state
    holds (kmer, label) PAIRS (the label rides the sorts as one more
    key), and the return value becomes the
    :func:`filter_kmers_set_arrays` triple ``(KmerTable, pair_label,
    split)`` — row i's sorted deduplicated color set is
    ``pair_label[split[i]:split[i+1]]``.  ``min_obs`` applies to each
    kmer's TOTAL count across colors, exactly like the in-memory path.
    """
    spec = KmerSpec(k)
    if memory_gb is not None and read_len_cap is not None:
        # working set per read ≈ Lk kmer slots × (W limbs + exts + label +
        # count + sort keys ≈ W+5 int32 lanes), double-buffered by the sort
        lk = max(read_len_cap - k + 1, 1)
        bytes_per_read = lk * (spec.w + 5) * 4 * 2
        chunk_reads = max(256, int(memory_gb * 1e9 / bytes_per_read))
    # widths are always rounded to 32 (bounds compile shapes), including
    # the user-provided cap, so the first block never triggers a regrow
    cap = None if read_len_cap is None else -(-read_len_cap // 32) * 32
    parts = []
    chunk: List = []

    if colored and merge != "device":
        raise ValueError("colored=True requires merge='device'")
    if merge == "device":
        if data_reduce != "none":
            raise ValueError(
                "merge='device' supports data_reduce='none' only "
                "(colored=True carries labels as pair keys; other "
                "label reductions need merge='host')"
            )
        # the block pipeline reshapes the obs stream into 256 chunks:
        # rows must stay a power of two (see flush/flush_block rounding)
        chunk_reads = 1 << max(8, (chunk_reads - 1).bit_length())
        u0 = unique_capacity or max(1 << 16, init_capacity // 2)
        dstate = {
            "kmers": None, "packed": None, "n": None,
            "C": max(1 << 13, 1 << (init_capacity - 1).bit_length()),
            # chunk-side block table: 256 blocks x out_cols rows; the
            # merge program is C + 256*out_cols rows — two-level shape,
            # every compiled program stays small no matter how the
            # corpus grows
            "out_cols": 1 << max(2, (max(u0 // 256, 1) - 1).bit_length()),
            "NB": 256,       # count-side blocks
            "MB": 128,       # merge-side blocks
            # deferred-confirmation machinery: merges are self-guarding
            # no-ops on overflow; diagnostics are read back LAGGED and
            # BATCHED so the stream never blocks on a host sync per chunk
            "pending": [],  # (device chunk tuple, n_new, count_ok, ok)
            "confirm_every": 32,
            # adaptive merge mode: while the corpus is young, most
            # chunks are mostly-NEW kmers, which the optimistic block
            # merge legitimately refuses (contiguous all-unique ranges
            # overflow any per-block slot count) — every such chunk
            # would be processed twice (optimistic + dense replay).
            # After a majority-refused confirm batch, the next
            # ``dense_batches`` batches dispatch the guaranteed-progress
            # dense merge directly, then re-probe the optimistic one.
            "dense_batches": 0,
            # phase-time accumulators (host wall): upload = jnp.asarray
            # of chunk arrays, dispatch = count+merge enqueue, confirm =
            # diagnostic readbacks
            "t_upload": 0.0, "t_dispatch": 0.0, "t_confirm": 0.0,
            "n_chunks": 0, "n_replays": 0,
        }

    def _dev_init():
        if dstate["kmers"] is None:
            c0 = dstate["C"]
            # sentinel state: all-ones kmers + zero packed = dead rows
            dstate["kmers"] = jnp.full((c0, spec.w), 0xFFFFFFFF, jnp.uint32)
            dstate["packed"] = jnp.zeros(c0, jnp.int32)
            dstate["n"] = jnp.int32(0)
            if colored:
                dstate["labels"] = jnp.full(c0, -1, jnp.int32)

    def _dev_stage(chunk_np, dense=False):
        """Enqueue block dedupe + guarded merge of one chunk; no host
        sync.  Reads arrive 2-bit PACKED (4 bases/byte, a quarter of the
        upload bytes) and unpack on device.  The default merge is the optimistic block-compaction one
        (cheapest, but refuses chunks with contiguous all-unique key
        ranges); ``dense=True`` (used for replays) runs the
        guaranteed-progress global-partition merge."""
        import time as _time

        t0 = _time.perf_counter()
        dev = tuple(map(jnp.asarray, chunk_np))
        dstate["t_upload"] += _time.perf_counter() - t0
        _dev_process(dev, dense)

    def _dev_process(dev, dense=False):
        """Count + merge an already-uploaded (device-resident) chunk.
        Pending entries keep the device arrays so dense replays skip the
        re-upload of the chunk."""
        import time as _time

        t1 = _time.perf_counter()
        dense = dense or dstate["dense_batches"] > 0
        da, dl, de, dlab = dev
        l = da.shape[1] * 4
        if colored:
            ck, cl, cp, c_n, c_ok = _count_kmers_blocks_packed_colored_jit(
                spec, stranded, dstate["out_cols"], l, da, dl, de, dlab
            )
            if dense:
                nk, nl, npk, n_new, ok = _merge_blocks_dense_colored_jit(
                    spec, dstate["kmers"], dstate["labels"],
                    dstate["packed"], ck, cl, cp, c_ok,
                )
            else:
                nk, nl, npk, n_new, ok = _merge_blocks_colored_jit(
                    spec, dstate["kmers"], dstate["labels"],
                    dstate["packed"], ck, cl, cp, dstate["MB"], c_ok,
                )
            dstate["labels"] = nl
        else:
            ck, cp, c_n, c_ok = _count_kmers_blocks_packed_jit(
                spec, stranded, dstate["out_cols"], l, da, dl, de
            )
            if dense:
                nk, npk, n_new, ok = _merge_blocks_dense_jit(
                    spec, dstate["kmers"], dstate["packed"], ck, cp, c_ok,
                )
            else:
                nk, npk, n_new, ok = _merge_blocks_jit(
                    spec, dstate["kmers"], dstate["packed"], ck, cp,
                    dstate["MB"], c_ok,
                )
        dstate["kmers"], dstate["packed"], dstate["n"] = nk, npk, n_new
        dstate["t_dispatch"] += _time.perf_counter() - t1
        dstate["n_chunks"] += 1
        dstate["n_replays"] += int(dense)
        dstate["pending"].append((dev, n_new, c_ok, ok))

    def _dev_confirm(force=False):
        """Read pending diagnostics in ONE batched transfer; grow + replay
        exactly the dropped chunks (state is unchanged by dropped merges,
        and merges of distinct chunks commute, so replay is exact)."""
        if not dstate["pending"]:
            return
        if not force and len(dstate["pending"]) < dstate["confirm_every"]:
            return
        import time as _time

        t0 = _time.perf_counter()
        pend = dstate["pending"]
        dstate["pending"] = []
        flat = []
        for _, nn, cok, ok in pend:
            flat += [nn, cok.astype(jnp.int32), ok.astype(jnp.int32)]
        diag = np.asarray(jnp.stack(flat)).reshape(len(pend), 3)
        dstate["t_confirm"] += _time.perf_counter() - t0
        dropped = [pend[i][0] for i in range(len(pend)) if diag[i, 2] == 0]
        if dstate["dense_batches"] > 0:
            dstate["dense_batches"] -= 1
        if dropped:
            # at high per-block density refusals recur intermittently on
            # block skew alone, each costing a wasted optimistic merge +
            # a dense replay; the dense merge is assumed to cost little
            # more than the block one, so ANY refusal flips the next
            # batches to dense (majority-refused batches flip longer)
            dstate["dense_batches"] = (
                4 if 2 * len(dropped) > len(pend) else 2
            )
        if not dropped:
            return
        if (diag[:, 1] == 0).any():
            # count-side block truncation: widen the chunk block table
            dstate["out_cols"] *= 2
        need_n = int(diag[:, 0].max())
        if 2 * need_n > dstate["C"]:
            # capacity headroom for the gapped block-merge state: keep C
            # at >= 2x the unique count so steady-state chunks fit their
            # per-chunk output slots
            c2 = dstate["C"]
            while c2 < 2 * need_n:
                c2 *= 2
            log.info(
                "filter_kmers_streaming[device]: growing table capacity "
                "%d -> %d (out_cols=%d)", dstate["C"], c2, dstate["out_cols"],
            )
            pad = c2 - dstate["C"]
            dstate["kmers"] = jnp.pad(
                dstate["kmers"], ((0, pad), (0, 0)),
                constant_values=np.uint32(0xFFFFFFFF),
            )
            dstate["packed"] = jnp.pad(dstate["packed"], ((0, pad),))
            if colored:
                dstate["labels"] = jnp.pad(
                    dstate["labels"], ((0, pad),), constant_values=-1
                )
            dstate["C"] = c2
        log.info(
            "filter_kmers_streaming[device]: replaying %d dropped chunk(s)",
            len(dropped),
        )
        # replays take the guaranteed-progress dense merge: the block
        # merge legitimately refuses mostly-new chunks (contiguous
        # all-unique ranges overflow ANY per-chunk slot count), so
        # replaying through it could loop forever.  Replays reuse the
        # device-resident chunk arrays — no re-upload.
        for dev in dropped:
            _dev_process(dev, dense=True)
        _dev_confirm(force=True)

    def _pack4(arr):
        # host-side 2-bit packing (width is a multiple of 16, so of 4)
        return (
            arr[:, 0::4]
            | (arr[:, 1::4] << 2)
            | (arr[:, 2::4] << 4)
            | (arr[:, 3::4] << 6)
        ).astype(np.uint8)

    def run_device_merge(arr, lengths, seq_exts, labels):
        _dev_init()
        _dev_stage((_pack4(arr), lengths, seq_exts, labels))
        _dev_confirm()

    def run_device(arr, lengths, seq_exts, labels):
        if merge == "device":
            return run_device_merge(arr, lengths, seq_exts, labels)
        dev = _count_kmers_jit(
            spec, stranded, 1, data_reduce, False, arr, lengths, seq_exts, labels
        )
        n = int(dev.n_valid)
        log.debug(
            "filter_kmers_streaming: chunk %d -> %d unique kmers", len(parts), n
        )
        # slice ON DEVICE before the host transfer: the padded table is
        # rows*Lk slots but only n are live, so pulling the full buffer
        # per chunk would move mostly padding.
        # The slice length is rounded up to a power of two (then trimmed on
        # host) so the per-chunk slice program has at most log2 distinct
        # shapes instead of one compile per chunk.
        nb = 256
        while nb < n:
            nb *= 2
        nb = min(nb, dev.kmers.shape[0])
        parts.append(
            (
                np.asarray(dev.kmers[:nb])[:n],
                np.asarray(dev.exts[:nb])[:n],
                np.asarray(dev.counts[:nb])[:n].astype(np.int64),
                np.asarray(dev.data[:nb])[:n],
            )
        )
        # LSM-style incremental merging keeps host memory O(global unique)
        # with a log factor, instead of O(sum of per-chunk uniques) — the
        # reference's whole point of memory-bounded counting
        # (filter.rs:151-183)
        while len(parts) >= 2 and 2 * len(parts[-1][0]) >= len(parts[-2][0]):
            b = parts.pop()
            a = parts.pop()
            parts.append(_merge_sorted_parts(spec, [a, b], data_reduce))

    def flush(chunk):
        nonlocal cap
        if not chunk:
            return
        # grow cap (recompiling) if this chunk holds a wider read than any
        # seen so far — never silently truncate (64-base rounding bounds
        # distinct compile shapes)
        need = -(-max(len(s[0]) for s in chunk) // 32) * 32
        if cap is None or need > cap:
            if cap is not None:
                log.warning(
                    "filter_kmers_streaming: read wider than previous cap "
                    "(%d > %d); growing (recompiles)", need, cap,
                )
            cap = need
        # pad rows to a power of two, not the full memory-budget chunk:
        # a small final (or only) chunk must not inflate to chunk_reads
        # rows (a 4GB budget implies ~1M rows — pathological for tiny
        # inputs); power-of-two rounding bounds recompiles at log2 shapes
        rows = 256
        while rows < len(chunk):
            rows *= 2
        rows = min(rows, chunk_reads)
        arr = np.zeros((rows, -(-max(cap, k) // 16) * 16), np.uint8)
        lengths = np.zeros(rows, np.int32)
        seq_exts = np.zeros(rows, np.int32)
        labels = np.zeros(rows, np.int32)
        for i, (s, e, d) in enumerate(chunk):
            s = np.asarray(s, np.uint8)[: arr.shape[1]]
            arr[i, : len(s)] = s
            lengths[i] = len(s)
            seq_exts[i] = e
            labels[i] = d
        run_device(arr, lengths, seq_exts, labels)

    def flush_block(item):
        # pre-batched (m, L) block: no per-read staging loop
        nonlocal cap
        block = np.ascontiguousarray(item[0], dtype=np.uint8)
        m, blen = block.shape
        blens = item[3] if len(item) > 3 and item[3] is not None else None
        need = -(-blen // 32) * 32
        if cap is None or need > cap:
            if cap is not None:
                log.warning(
                    "filter_kmers_streaming: block wider than previous cap "
                    "(%d > %d); growing (recompiles)", need, cap,
                )
            cap = need
        width = -(-max(cap, k) // 16) * 16
        step = chunk_reads
        for lo in range(0, m, step):
            sub = block[lo : lo + step]
            rows = 256
            while rows < sub.shape[0]:
                rows *= 2
            rows = min(rows, chunk_reads)
            arr = np.zeros((rows, width), np.uint8)
            arr[: sub.shape[0], : min(blen, width)] = sub[:, :width]
            lengths = np.zeros(rows, np.int32)
            if blens is None:
                lengths[: sub.shape[0]] = min(blen, width)
            else:
                lengths[: sub.shape[0]] = np.minimum(
                    np.asarray(blens[lo : lo + step], np.int32), width
                )
            e, d = item[1], item[2]
            seq_exts = np.zeros(rows, np.int32)
            seq_exts[: sub.shape[0]] = (
                np.asarray(e, np.int32)[lo : lo + step] if np.ndim(e) else e
            )
            labels = np.zeros(rows, np.int32)
            labels[: sub.shape[0]] = (
                np.asarray(d, np.int32)[lo : lo + step] if np.ndim(d) else d
            )
            run_device(arr, lengths, seq_exts, labels)

    def flush_packed(item: PackedReadBlock):
        # already in the device upload format: slice into chunk_reads
        # sub-blocks, pad rows to pow2, and stage with zero re-encoding
        nonlocal cap
        if merge != "device":
            raise ValueError("PackedReadBlock items require merge='device'")
        if item.width % 16:
            raise ValueError("PackedReadBlock width must be a multiple of 16")
        if cap is None or item.width > cap:
            cap = item.width
        m = item.packed.shape[0]
        wb = item.packed.shape[1]
        for lo in range(0, m, chunk_reads):
            sub = item.packed[lo : lo + chunk_reads]
            rows = 256
            while rows < sub.shape[0]:
                rows *= 2
            rows = min(rows, chunk_reads)
            arr = np.zeros((rows, wb), np.uint8)
            arr[: sub.shape[0]] = sub
            lengths = np.zeros(rows, np.int32)
            lengths[: sub.shape[0]] = np.asarray(
                item.lengths[lo : lo + chunk_reads], np.int32
            )
            e, d = item.seq_exts, item.label
            seq_exts = np.zeros(rows, np.int32)
            seq_exts[: sub.shape[0]] = (
                np.asarray(e, np.int32)[lo : lo + chunk_reads] if np.ndim(e) else e
            )
            labels = np.zeros(rows, np.int32)
            labels[: sub.shape[0]] = (
                np.asarray(d, np.int32)[lo : lo + chunk_reads] if np.ndim(d) else d
            )
            _dev_init()
            _dev_stage((arr, lengths, seq_exts, labels))
            _dev_confirm()

    for item in seqs:
        if isinstance(item, PackedReadBlock):
            flush(chunk)
            chunk = []
            flush_packed(item)
            continue
        if np.ndim(item[0]) == 2:
            flush(chunk)
            chunk = []
            flush_block(item)
            continue
        if len(item[0]) < k:
            continue
        chunk.append(item)
        if len(chunk) == chunk_reads:
            flush(chunk)
            chunk = []
    flush(chunk)

    if merge == "device":
        if dstate["kmers"] is None:
            empty = KmerTable(
                spec, stranded,
                np.zeros((0, spec.w), np.uint32), np.zeros(0, np.int32),
                np.zeros(0, np.int32), np.zeros(0, np.int32),
            )
            if colored:
                return empty, np.zeros(0, np.int32), np.zeros(1, np.int64)
            return empty
        _dev_confirm(force=True)
        log.info(
            "filter_kmers_streaming[device]: %d chunks (%d dense replays); "
            "upload %.2fs dispatch %.2fs confirm %.2fs",
            dstate["n_chunks"], dstate["n_replays"], dstate["t_upload"],
            dstate["t_dispatch"], dstate["t_confirm"],
        )
        if colored:
            dk, dl, dp, dn = _extract_blocks_state_colored_jit(
                spec, dstate["kmers"], dstate["labels"], dstate["packed"]
            )
            n = int(dn)
            nb = 256
            while nb < n:
                nb *= 2
            nb = min(nb, dstate["C"])
            pk = np.asarray(dk[:nb])[:n]          # (P, W) pair kmers
            pl = np.asarray(dl[:nb])[:n]          # (P,) pair labels
            pp = np.asarray(dp[:nb])[:n]          # (P,) packed
            # per-kmer rollup over the sorted pair runs: counts sum
            # (u16-saturated), exts OR, min_obs on the kmer TOTAL
            new = np.ones(n, bool)
            if n > 1:
                new[1:] = (pk[1:] != pk[:-1]).any(axis=1)
            kstarts = np.nonzero(new)[0]
            pcounts = ((pp >> 8) & 0xFFFF).astype(np.int64)
            pexts = (pp & 0xFF).astype(np.int32)
            kcounts = np.minimum(
                np.add.reduceat(pcounts, kstarts) if n else np.zeros(0),
                65535,
            ).astype(np.int32)
            kexts = (
                np.bitwise_or.reduceat(pexts, kstarts)
                if n
                else np.zeros(0, np.int32)
            )
            keep = kcounts >= min_obs
            table = KmerTable(
                spec=spec,
                stranded=stranded,
                kmers=pk[kstarts][keep],
                exts=kexts[keep].astype(np.int32),
                counts=kcounts[keep],
                data=np.zeros(int(keep.sum()), np.int32),
            )
            # pair arrays filtered to surviving kmers, with split offsets
            kid = np.cumsum(new) - 1
            pair_keep = keep[kid]
            pair_label = pl[pair_keep].astype(np.int32)
            lens = np.diff(np.append(kstarts, n))[keep]
            split = np.zeros(len(table) + 1, np.int64)
            np.cumsum(lens, out=split[1:])
            return table, pair_label, split
        # densify the sentinel-gapped block state ONCE (amortized over
        # the whole stream), then pull
        dk, dp, dn = _extract_blocks_state_jit(
            spec, dstate["kmers"], dstate["packed"]
        )
        n = int(dn)
        nb = 256
        while nb < n:
            nb *= 2
        nb = min(nb, dstate["C"])
        kk = np.asarray(dk[:nb])[:n]
        pp = np.asarray(dp[:nb])[:n]
        counts = ((pp >> 8) & 0xFFFF).astype(np.int32)  # u16-saturated
        exts = (pp & 0xFF).astype(np.int32)
        keep = counts >= min_obs
        return KmerTable(
            spec=spec,
            stranded=stranded,
            kmers=kk[keep],
            exts=exts[keep],
            counts=counts[keep],
            data=np.zeros(int(keep.sum()), np.int32),
        )

    if not parts:
        return KmerTable(
            spec, stranded,
            np.zeros((0, spec.w), np.uint32), np.zeros(0, np.int32),
            np.zeros(0, np.int32), np.zeros(0, np.int32),
        )
    while len(parts) > 1:
        b = parts.pop()
        a = parts.pop()
        parts.append(_merge_sorted_parts(spec, [a, b], data_reduce))
    kmers, uexts, counts, udata = parts[0]

    ucounts = np.minimum(counts, 65535).astype(np.int32)
    keep = ucounts >= min_obs
    return KmerTable(
        spec=spec,
        stranded=stranded,
        kmers=kmers[keep],
        exts=uexts[keep].astype(np.int32),
        counts=ucounts[keep],
        data=udata[keep].astype(np.int32),
    )


@partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def _count_kmers_jit(spec, stranded, min_obs, data_reduce, report_all,
                     bases, lengths, seq_exts, labels):
    return count_kmers(
        spec,
        bases,
        lengths,
        seq_exts,
        labels,
        stranded=stranded,
        min_obs=min_obs,
        data_reduce=data_reduce,
        report_all=report_all,
    )
