"""Sort-based join primitives: the data-parallel replacement for the
reference's hash maps (boomphf) and per-bucket sorts (filter.rs:206).

* multi-limb lexicographic sort (``jax.lax.sort`` with num_keys)
* vectorized binary search over sorted limb arrays (replaces
  BoomHashMap::get / get_key_id lookups, graph.rs:244-249)
* segmented reductions over sorted runs (replaces itertools group_by +
  summarizer loops, filter.rs:208-219)
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np


def sort_with_payload(keys, payloads=(), num_key_arrays=None):
    """Sort rows by lexicographic key tuple, carrying payload arrays.

    ``keys``: list of (n,) arrays, most-significant first.
    Returns (sorted_keys, sorted_payloads).
    """
    keys = list(keys)
    payloads = list(payloads)
    nk = len(keys) if num_key_arrays is None else num_key_arrays
    out = jax.lax.sort(keys + payloads, num_keys=nk, is_stable=True)
    return out[: len(keys)], out[len(keys) :]


def limbs_to_keys(limbs):
    """(n, W) limb array -> list of W (n,) key arrays."""
    return [limbs[:, i] for i in range(limbs.shape[1])]


def keys_to_limbs(keys):
    return jnp.stack(keys, axis=1)


def lex_lt(a_keys, b_keys):
    """Elementwise lexicographic < over equal-length key tuples."""
    res = jnp.zeros(a_keys[0].shape, dtype=bool)
    eq = jnp.ones(a_keys[0].shape, dtype=bool)
    for a, b in zip(a_keys, b_keys):
        res = res | (eq & (a < b))
        eq = eq & (a == b)
    return res


def lex_eq(a_keys, b_keys):
    eq = jnp.ones(a_keys[0].shape, dtype=bool)
    for a, b in zip(a_keys, b_keys):
        eq = eq & (a == b)
    return eq


def searchsorted_limbs(sorted_limbs, query_limbs, n_valid=None):
    """Vectorized lower-bound binary search over a sorted (n, W) limb array.

    Returns (idx, found): idx = first position with sorted >= query
    (lower bound), found = idx in range and exact match.  ``n_valid`` bounds
    the logical length (entries beyond are treated as +inf; they must sort
    after all valid entries — callers ensure this by padding with 0xFF..FF
    or by passing n_valid).
    """
    n, w = sorted_limbs.shape
    m = query_limbs.shape[0]
    hi0 = jnp.asarray(n if n_valid is None else n_valid, jnp.int32)
    lo = jnp.zeros(m, dtype=jnp.int32)
    hi = jnp.broadcast_to(hi0, (m,))

    qkeys = limbs_to_keys(query_limbs)
    steps = max(1, math.ceil(math.log2(max(n, 1) + 1)))

    def body(_, carry):
        lo, hi = carry
        mid = (lo + hi) // 2
        midv = sorted_limbs[jnp.clip(mid, 0, n - 1)]
        mkeys = [midv[:, i] for i in range(w)]
        is_lt = lex_lt(mkeys, qkeys)  # sorted[mid] < q
        lo = jnp.where(is_lt, mid + 1, lo)
        hi = jnp.where(is_lt, hi, mid)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi))
    idx = lo
    inb = idx < hi0
    atv = sorted_limbs[jnp.clip(idx, 0, n - 1)]
    found = inb & lex_eq([atv[:, i] for i in range(w)], qkeys)
    return idx, found


_JOIN_FLAG = np.int32(1 << 30)


def sort_join_limbs(sorted_limbs, n_valid, query_limbs, table_vals=None):
    """Exact-match join of queries against a sorted kmer table via ONE sort.

    Replaces per-query binary search (log2(n) random row gathers, assumed
    to dominate over the compares) with a single stable sort
    over table+queries, a packed segmented copy scan, and one scatter.

    Args:
      sorted_limbs: (n, W) table; rows [0, n_valid) are sorted unique
        valid entries.  Rows beyond n_valid may hold arbitrary values
        (e.g. a partition's unselected tail) — they never produce a match
        because the stable sort keeps lower-index (valid) table rows first
        within an equal-key run and the run leader's row id is checked
        against n_valid.
      query_limbs: (q, W) queries, any order.
      table_vals: optional (n,) aux values in [0, 255] (e.g. Exts bytes)
        returned for the matched row.  When n + q < 2**22 the value rides
        the sort payload (zero extra gathers); larger joins carry the row
        id only (29 bits under the scan flag) and fetch vals with one
        post-join gather.  Hard limit: n + q < 2**29.

    Returns (idx, found[, vals]): idx int32 = matching table row
    (arbitrary where not found), found bool; vals int32 if table_vals.
    """
    n, w = sorted_limbs.shape
    q = query_limbs.shape[0]
    tot = n + q
    if tot >= (1 << 29):
        raise ValueError(f"sort_join_limbs: n+q = {tot} exceeds 2**29")
    # payload layout: small joins (< 2**22 rows) pack the aux value into
    # the row-id payload (zero extra gathers); big joins carry the row id
    # only (29 bits under the scan flag) and fetch vals with one gather
    packed_vals = table_vals is not None and tot < (1 << 22)
    pos_bits = 22 if packed_vals else 29
    pos_mask = (1 << pos_bits) - 1
    keys = [
        jnp.concatenate([sorted_limbs[:, i], query_limbs[:, i]])
        for i in range(w)
    ]
    pos = jnp.arange(tot, dtype=jnp.int32)
    if packed_vals:
        pay = pos | jnp.concatenate(
            [(table_vals.astype(jnp.int32) & 0xFF), jnp.zeros(q, jnp.int32)]
        ) << 22
    else:
        pay = pos
    out = jax.lax.sort(keys + [pay], num_keys=w, is_stable=True)
    skeys, spay = out[:w], out[w]

    prev = [jnp.concatenate([k[:1], k[:-1]]) for k in skeys]
    starts = ~lex_eq(skeys, prev)
    starts = starts.at[0].set(True)

    # run leader's payload at every row: packed copy-first scan
    x = jnp.where(starts, spay | _JOIN_FLAG, spay)

    def comb(a, b):
        return jnp.where(b >= _JOIN_FLAG, b, a)

    leader = jax.lax.associative_scan(comb, x) & (_JOIN_FLAG - 1)

    lpos = leader & pos_mask
    own = spay & pos_mask
    is_query = own >= n
    found_here = lpos < jnp.asarray(n_valid, jnp.int32)
    if packed_vals:
        lval = (leader >> 22) & 0xFF
        res = lpos | (lval << 22) | jnp.where(found_here, _JOIN_FLAG, 0)
    else:
        res = lpos | jnp.where(found_here, _JOIN_FLAG, 0)

    if _JOIN_UNPERMUTE[0] == "sort":
        # un-permute by ONE unstable 2-lane sort on the unique row id —
        # rows n..tot-1 are the queries in original order (A/B vs the
        # scatter path via _JOIN_UNPERMUTE)
        sout = jax.lax.sort([own, res], num_keys=1, is_stable=False)
        gathered = sout[1][n:]
    else:
        target = jnp.where(is_query, own - n, q)
        gathered = jnp.zeros(q, jnp.int32).at[target].set(res, mode="drop")
    idx = gathered & pos_mask
    found = gathered >= _JOIN_FLAG
    if table_vals is not None:
        if packed_vals:
            return idx, found, (gathered >> 22) & 0xFF
        vals = table_vals.astype(jnp.int32)[jnp.clip(idx, 0, n - 1)] & 0xFF
        return idx, found, vals
    return idx, found


# join un-permute strategy: "scatter" (one q-row scatter) or "sort" (one
# unstable 2-lane sort over n+q rows).  Module-level so benches can A/B.
# Default "sort" is inherited and unconfirmed on the GPU (see ROADMAP).
_JOIN_UNPERMUTE = ["sort"]


def run_starts(key_arrays, valid):
    """True at the first element of each run of equal keys (among valid).

    Assumes invalid entries are sorted to the end.
    """
    n = key_arrays[0].shape[0]
    prev = [jnp.concatenate([k[:1], k[:-1]]) for k in key_arrays]
    differs = ~lex_eq(key_arrays, prev)
    first = jnp.zeros(n, bool).at[0].set(True)
    return valid & (first | differs)


def segment_ids(starts, valid):
    """Segment id per element; invalid elements get id = n (drop slot)."""
    n = starts.shape[0]
    seg = jnp.cumsum(starts.astype(jnp.int32)) - 1
    return jnp.where(valid, seg, n)


def segment_sum(vals, seg, n):
    return jnp.zeros((n,) + vals.shape[1:], vals.dtype).at[seg].add(vals, mode="drop")


def segment_max(vals, seg, n, init=0):
    return (
        jnp.full((n,) + vals.shape[1:], init, vals.dtype)
        .at[seg]
        .max(vals, mode="drop")
    )


def segment_min(vals, seg, n, init):
    return (
        jnp.full((n,) + vals.shape[1:], init, vals.dtype)
        .at[seg]
        .min(vals, mode="drop")
    )


def segment_or8(vals, seg, n):
    """Segmented bitwise-OR of 8-bit values (the Exts fold, filter.rs:53-59).

    One 1-lane max-scatter per bit in place of one packed (n, 8) row
    scatter (assumed slower; untested on the GPU, see ROADMAP)."""
    acc = jnp.zeros(n, vals.dtype)
    for b in range(8):
        bit = (vals >> b) & 1
        got = jnp.zeros(n, vals.dtype).at[seg].max(bit, mode="drop")
        acc = acc | (got << b)
    return acc


def segment_first(vals, seg, n, starts):
    """Value of the first element of each segment (scatter from starts)."""
    out = jnp.zeros((n,) + vals.shape[1:], vals.dtype)
    idx = jnp.where(starts, seg, n)
    return out.at[idx].set(vals, mode="drop")


def partition(mask, arrays):
    """Stable partition via one sort: rows with mask move to the front,
    preserving order.  Returns (count, arrays).

    Chosen over the scatter-based ``compact`` on the assumption that
    sorts beat scatters (untested on the GPU, see ROADMAP).  The key is
    the row index with the mask in the top bit — keys are UNIQUE, so the
    unstable sort is still deterministic and order-preserving within both
    groups.  Tail slots hold the unselected rows (NOT a fill value) —
    callers must bound by count.
    """
    n = mask.shape[0]
    key = jnp.arange(n, dtype=jnp.uint32) | jnp.where(
        mask, np.uint32(0), np.uint32(1 << 31)
    )
    out = jax.lax.sort([key] + list(arrays), num_keys=1, is_stable=False)
    return mask.sum().astype(jnp.int32), out[1:]


def _seg_combine_copy_first(a, b):
    """Segmented copy-first scan combinator: value = first of segment."""
    f1, v1 = a
    f2, v2 = b
    f2b = f2.astype(bool)
    if isinstance(v1, (list, tuple)):
        v = type(v1)(jnp.where(f2b, x2, x1) for x1, x2 in zip(v1, v2))
    else:
        v = jnp.where(f2b, v2, v1)
    return f1 | f2, v


def seg_first_scan(vals, starts):
    """Each element gets its segment's FIRST value (forward copy scan).

    ``vals`` may be one array or a tuple of arrays sharing the flags.
    """
    _, v = jax.lax.associative_scan(_seg_combine_copy_first, (starts, vals))
    return v


def seg_last_scan(vals, is_end):
    """Each element gets its segment's LAST value (reversed copy scan)."""
    single = not isinstance(vals, (list, tuple))
    vt = (vals,) if single else tuple(vals)
    rev = tuple(v[::-1] for v in vt)
    out = seg_first_scan(rev, is_end[::-1])
    out = tuple(v[::-1] for v in out)
    return out[0] if single else out


def seg_or_scan(vals, starts):
    """Forward segmented bitwise-OR scan (OR is associative)."""

    def comb(a, b):
        f1, v1 = a
        f2, v2 = b
        return f1 | f2, jnp.where(f2.astype(bool), v2, v1 | v2)

    _, v = jax.lax.associative_scan(comb, (starts, vals))
    return v


def seg_or_suffix8(vals, is_end):
    """At each element: bitwise-OR of ``vals`` from the element through its
    segment's END (segments delimited by ``is_end`` flags), for 8-bit
    values.  The whole segmented scan runs as ONE packed int32
    associative scan (flag in bit 8) in place of the generic
    tuple-combinator scan, which moves multiple arrays per pass.
    """
    x = (is_end[::-1].astype(jnp.int32) << 8) | (vals[::-1] & 0xFF)

    def comb(a, b):
        # (flag, val) segmented-OR combinator on packed lanes:
        # flag_out = fa | fb; val_out = vb if fb else va | vb
        return jnp.where(b >= 256, b | (a & 256), a | b)

    return (jax.lax.associative_scan(comb, x) & 0xFF)[::-1]


def seg_op_scan(vals, starts, op):
    """Forward segmented scan with an arbitrary associative ``op``."""

    def comb(a, b):
        f1, v1 = a
        f2, v2 = b
        return f1 | f2, jnp.where(f2.astype(bool), v2, op(v1, v2))

    _, v = jax.lax.associative_scan(comb, (starts, vals))
    return v


def compact(mask, arrays, fill=0):
    """Stable-compact rows where mask is True to the front of each array.

    Returns (count, compacted_arrays); tail slots are ``fill``.
    """
    n = mask.shape[0]
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    idx = jnp.where(mask, pos, n)
    outs = []
    for a in arrays:
        if a.ndim == 2:
            # one scatter PER COLUMN in place of one multi-lane row
            # scatter (assumed slower; untested on the GPU, see ROADMAP)
            cols = [
                jnp.full(a.shape[:1], fill, a.dtype)
                .at[idx]
                .set(a[:, i], mode="drop")
                for i in range(a.shape[1])
            ]
            out = jnp.stack(cols, axis=1)
        else:
            out = jnp.full(a.shape, fill, a.dtype).at[idx].set(a, mode="drop")
        outs.append(out)
    return mask.sum().astype(jnp.int32), outs
