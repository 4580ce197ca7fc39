"""Fixed-K kmer arithmetic on uint32 limb vectors (L2 core).

Capability-equivalent to the reference's ``IntKmer``/``VarIntKmer`` types
(src/kmer.rs:230-824) but designed for 32-bit vector lanes:

* A kmer of K bases (2 <= K <= 64) is a 2K-bit integer stored in
  ``W = ceil(K/16)`` uint32 limbs, **most-significant limb first**, with the
  value right-aligned in the low 2K bits (zero padding in the top bits, like
  VarIntKmer, kmer.rs:429-437).  Base 0 (leftmost in the string) occupies the
  most significant 2 bits of the value, so comparing limb tuples
  lexicographically == comparing kmer strings lexicographically.
* Every operation (shift-extend, reverse-complement, canonicalize, hamming,
  palindrome) is a branch-free elementwise uint32 computation over arrays of
  shape (..., W) — this is the data-parallel replacement for the reference's
  per-int-width bit kernels (``reverse_by_twos`` ladders, kmer.rs:97-228).

All functions take/return jax arrays but are also numpy-compatible (the ops
used exist in both namespaces); the engine jit-compiles them.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax.numpy as jnp
import numpy as np

UMAX = np.uint32(0xFFFFFFFF)


@dataclasses.dataclass(frozen=True)
class KmerSpec:
    """Static description of a kmer width; closed over by jitted code."""

    k: int

    def __post_init__(self):
        if not (1 <= self.k <= 64):
            raise ValueError(f"K must be in 1..64, got {self.k}")

    @property
    def w(self) -> int:
        """Number of uint32 limbs."""
        return (self.k + 15) // 16

    @property
    def nbits(self) -> int:
        return 2 * self.k

    @property
    def pad(self) -> int:
        """Zero bits above the value in the top limb; always in [0, 32)."""
        return 32 * self.w - 2 * self.k

    @property
    def top_mask(self) -> np.uint32:
        return np.uint32(UMAX >> np.uint32(self.pad))

    def limb_mask(self, i: int) -> np.uint32:
        return self.top_mask if i == 0 else UMAX


def _u32(x):
    return jnp.asarray(x, jnp.uint32)


# ---------------------------------------------------------------------------
# construction / conversion (host side)
# ---------------------------------------------------------------------------


def from_int(spec: KmerSpec, value: int) -> np.ndarray:
    """Python int rank -> (W,) uint32 limbs (host).  kmer.rs from_u64 analog."""
    out = np.zeros(spec.w, dtype=np.uint32)
    for i in range(spec.w - 1, -1, -1):
        out[i] = value & 0xFFFFFFFF
        value >>= 32
    return out


def to_int(spec: KmerSpec, limbs) -> int:
    """(..., W) limbs -> python int rank (host; works on a single kmer)."""
    limbs = np.asarray(limbs, dtype=np.uint64)
    v = 0
    for i in range(spec.w):
        v = (v << 32) | int(limbs[..., i])
    return v


def from_bases(spec: KmerSpec, bases) -> np.ndarray:
    """Host: (K,) array of 2-bit codes -> (W,) limbs."""
    v = 0
    for b in np.asarray(bases, dtype=np.uint8)[: spec.k]:
        v = (v << 2) | int(b)
    return from_int(spec, v)


def from_bases_batch_np(spec: KmerSpec, rows: np.ndarray) -> np.ndarray:
    """Host-vectorized: (N, K) base codes -> (N, W) limbs.

    Left-pads each row to 16W bases so the packed value lands right-aligned
    (the canonical limb layout).
    """
    rows = np.asarray(rows, np.uint32)
    n = rows.shape[0]
    padded = np.zeros((n, 16 * spec.w), np.uint32)
    padded[:, 16 * spec.w - spec.k :] = rows
    padded = padded.reshape(n, spec.w, 16)
    shifts = (30 - 2 * np.arange(16, dtype=np.uint32)).astype(np.uint32)
    return (padded << shifts).sum(axis=2, dtype=np.uint32)


def to_bases_batch_np(spec: KmerSpec, limbs: np.ndarray) -> np.ndarray:
    """Host-vectorized inverse of from_bases_batch_np: (N, W) -> (N, K)."""
    limbs = np.asarray(limbs, np.uint32)
    shifts = (30 - 2 * np.arange(16, dtype=np.uint32)).astype(np.uint32)
    # (N, W, 16) -> (N, 16W), keep the low-order K positions
    all_b = ((limbs[:, :, None] >> shifts[None, None, :]) & 3).reshape(
        limbs.shape[0], -1
    )
    return all_b[:, 16 * spec.w - spec.k :].astype(np.uint8)


def kmers_from_bytes(spec: KmerSpec, bases) -> np.ndarray:
    """All kmers of a 2-bit coded array -> (N-K+1, W) limbs (lib.rs:288-305).

    Returns an empty (0, W) array when the input is shorter than K.
    """
    bases = np.asarray(bases, np.uint8)
    if len(bases) < spec.k:
        return np.zeros((0, spec.w), np.uint32)
    win = np.lib.stride_tricks.sliding_window_view(bases, spec.k)
    return from_bases_batch_np(spec, win)


def kmers_from_ascii(spec: KmerSpec, s) -> np.ndarray:
    """All kmers of an ASCII ACGT string (lib.rs:307-327)."""
    from tpu_debruijn import bases as B

    return kmers_from_bytes(spec, B.ascii_to_bases(s))


def to_bases(spec: KmerSpec, limbs) -> np.ndarray:
    """Host: (W,) limbs -> (K,) array of 2-bit codes."""
    v = to_int(spec, limbs)
    out = np.empty(spec.k, dtype=np.uint8)
    for i in range(spec.k - 1, -1, -1):
        out[i] = v & 3
        v >>= 2
    return out


def to_string(spec: KmerSpec, limbs) -> str:
    return "".join("ACGT"[b] for b in to_bases(spec, limbs))


def from_string(spec: KmerSpec, s: str) -> np.ndarray:
    from tpu_debruijn.bases import ascii_to_bases

    return from_bases(spec, ascii_to_bases(s))


# ---------------------------------------------------------------------------
# elementwise kmer ops on (..., W) uint32 arrays
# ---------------------------------------------------------------------------


def empty(spec: KmerSpec, shape=()) -> jnp.ndarray:
    """All-A kmers.  Kmer::empty (lib.rs:187)."""
    return jnp.zeros((*shape, spec.w), dtype=jnp.uint32)


def mask_value(spec: KmerSpec, a):
    """Clear padding bits above the 2K-bit value."""
    if spec.pad == 0:
        return a
    return a.at[..., 0].set(a[..., 0] & spec.top_mask) if hasattr(a, "at") else a


def _apply_top_mask(spec: KmerSpec, limbs: list):
    limbs = list(limbs)
    if spec.pad:
        limbs[0] = limbs[0] & spec.top_mask
    return limbs


def _split(a):
    """(..., W) -> list of W (...,) limb arrays, most-significant first."""
    return [a[..., i] for i in range(a.shape[-1])]


def _join(limbs):
    return jnp.stack(limbs, axis=-1)


def extend_right(spec: KmerSpec, a, v):
    """Shift base ``v`` into the right end, dropping the leftmost base.

    Kmer::extend_right (lib.rs:207, kmer.rs:397-402).
    ``v``: integer array broadcastable to a[..., 0] with values 0..3.
    """
    x = _split(a)
    out = []
    for i in range(spec.w):
        lo = (x[i + 1] >> np.uint32(30)) if i + 1 < spec.w else _u32(v) & np.uint32(3)
        out.append((x[i] << np.uint32(2)) | lo)
    return _join(_apply_top_mask(spec, out))


def extend_left(spec: KmerSpec, a, v):
    """Shift base ``v`` into the left end, dropping the rightmost base.

    Kmer::extend_left (lib.rs:204, kmer.rs:392-395).
    """
    x = _split(a)
    out = []
    for i in range(spec.w):
        hi = (x[i - 1] << np.uint32(30)) if i > 0 else _u32(0)
        out.append((x[i] >> np.uint32(2)) | hi)
    # place v at bit position nbits-2 of the value
    shift = spec.nbits - 2
    il = spec.w - 1 - shift // 32
    sh = np.uint32(shift % 32)
    out[il] = out[il] | (_u32(v) << sh)
    return _join(_apply_top_mask(spec, out))


def extend(spec: KmerSpec, a, v, dir_is_right):
    """extend() with a traced direction flag (False=left, True=right)."""
    r = extend_right(spec, a, v)
    l = extend_left(spec, a, v)
    d = jnp.asarray(dir_is_right, bool)[..., None]
    return jnp.where(d, r, l)


def _reverse_by_twos_u32(x):
    """Reverse the 16 2-bit groups within each uint32 (kmer.rs:169-183)."""
    x = ((x & np.uint32(0x33333333)) << np.uint32(2)) | (
        (x >> np.uint32(2)) & np.uint32(0x33333333)
    )
    x = ((x & np.uint32(0x0F0F0F0F)) << np.uint32(4)) | (
        (x >> np.uint32(4)) & np.uint32(0x0F0F0F0F)
    )
    x = ((x & np.uint32(0x00FF00FF)) << np.uint32(8)) | (
        (x >> np.uint32(8)) & np.uint32(0x00FF00FF)
    )
    x = ((x & np.uint32(0x0000FFFF)) << np.uint32(16)) | (
        (x >> np.uint32(16)) & np.uint32(0x0000FFFF)
    )
    return x


def rc(spec: KmerSpec, a):
    """Reverse complement.  IntKmer::rc (kmer.rs:346-352) equivalent:
    complement = bitwise-NOT of the value; reverse = 2-bit-group reversal of
    the full 32W-bit register followed by a right shift of the pad amount.
    """
    x = _split(a)
    # complement within the value bits
    comp = [x[i] ^ spec.limb_mask(i) for i in range(spec.w)]
    # reverse 2-bit groups across the whole register: per-limb reverse, then
    # reverse limb order
    rev = [_reverse_by_twos_u32(comp[i]) for i in range(spec.w - 1, -1, -1)]
    # value now occupies the TOP 2K bits; shift right by pad to realign
    if spec.pad:
        p = np.uint32(spec.pad)
        q = np.uint32(32 - spec.pad)
        out = []
        for i in range(spec.w):
            hi = (rev[i - 1] << q) if i > 0 else _u32(0)
            out.append((rev[i] >> p) | hi)
    else:
        out = rev
    return _join(_apply_top_mask(spec, out))


def eq(a, b):
    return jnp.all(a == b, axis=-1)


def lt(a, b):
    """Lexicographic a < b over limb vectors."""
    res = jnp.zeros(a.shape[:-1], dtype=bool)
    eqs = jnp.ones(a.shape[:-1], dtype=bool)
    for i in range(a.shape[-1]):
        res = res | (eqs & (a[..., i] < b[..., i]))
        eqs = eqs & (a[..., i] == b[..., i])
    return res


def min_rc_flip(spec: KmerSpec, a):
    """Canonical form: (min(kmer, rc), flipped?).  lib.rs:224-231.

    Matches the reference exactly: flipped is True when ``not (kmer < rc)``
    (palindromes report flipped=True with unchanged value).
    """
    r = rc(spec, a)
    flip = ~lt(a, r)
    return jnp.where(flip[..., None], r, a), flip


def min_rc(spec: KmerSpec, a):
    r = rc(spec, a)
    return jnp.where(lt(a, r)[..., None], a, r)


def is_palindrome(spec: KmerSpec, a):
    """lib.rs:244-246: only even K can match its own rc."""
    if spec.k % 2 == 1:
        return jnp.zeros(a.shape[:-1], dtype=bool)
    return eq(a, rc(spec, a))


def get_base(spec: KmerSpec, a, pos: int):
    """Base at static position ``pos`` (0 = leftmost).  Mer::get."""
    shift = spec.nbits - 2 - 2 * pos
    il = spec.w - 1 - shift // 32
    sh = np.uint32(shift % 32)
    return (a[..., il] >> sh) & np.uint32(3)


def set_base(spec: KmerSpec, a, pos: int, v):
    """Set base at static position ``pos``.  Mer::set_mut."""
    shift = spec.nbits - 2 - 2 * pos
    il = spec.w - 1 - shift // 32
    sh = np.uint32(shift % 32)
    cleared = a[..., il] & ~(np.uint32(3) << sh)
    return a.at[..., il].set(cleared | (_u32(v) << sh))


def get_base_dyn(spec: KmerSpec, a, pos):
    """Base at a *traced* position array (same batch shape as a[..., 0])."""
    shift = spec.nbits - 2 - 2 * jnp.asarray(pos, jnp.int32)
    il = spec.w - 1 - shift // 32
    sh = (shift % 32).astype(jnp.uint32)
    limb = jnp.take_along_axis(a, il[..., None].astype(jnp.int32), axis=-1)[..., 0]
    return (limb >> sh) & np.uint32(3)


def first_base(spec: KmerSpec, a):
    return get_base(spec, a, 0)


def last_base(spec: KmerSpec, a):
    return get_base(spec, a, spec.k - 1)


def _popcount(x):
    x = x - ((x >> np.uint32(1)) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> np.uint32(2)) & np.uint32(0x33333333))
    x = (x + (x >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return (x * np.uint32(0x01010101)) >> np.uint32(24)


def hamming_dist(spec: KmerSpec, a, b):
    """Number of differing bases.  kmer.rs:405-409."""
    total = jnp.zeros(a.shape[:-1], dtype=jnp.uint32)
    for i in range(spec.w):
        d = a[..., i] ^ b[..., i]
        two = (d | (d >> np.uint32(1))) & np.uint32(0x55555555)
        total = total + _popcount(two)
    return total


def at_count(spec: KmerSpec, a):
    """Count of A/T bases (upper^lower bit == 0).  kmer.rs:354-360."""
    total = jnp.zeros(a.shape[:-1], dtype=jnp.uint32)
    for i in range(spec.w):
        v = a[..., i]
        mix = ~((v >> np.uint32(1)) ^ v)
        bits = mix & np.uint32(0x55555555) & spec.limb_mask(i)
        total = total + _popcount(bits)
    # limb_mask clears the pad bits, so zero padding never counts as A's
    return total


def gc_count(spec: KmerSpec, a):
    """Count of G/C bases.  kmer.rs:362-368."""
    total = jnp.zeros(a.shape[:-1], dtype=jnp.uint32)
    for i in range(spec.w):
        v = a[..., i]
        mix = (v >> np.uint32(1)) ^ v
        bits = mix & np.uint32(0x55555555) & spec.limb_mask(i)
        total = total + _popcount(bits)
    return total


def hamming_neighbors(spec: KmerSpec, a):
    """Candidates for all Hamming-distance-1 neighbors of each kmer.

    neighbors.rs:4-52 equivalent, fully vectorized.  Returns
    ``(cands (..., 4K, W), mask (..., 4K))``: one candidate per
    (position, base) in position-major / base-ascending order, with
    ``mask`` False where the base equals the original (so exactly 3K
    entries are True per kmer — the reference iterator's output set).
    """
    outs = []
    for pos in range(spec.k):
        cur = get_base(spec, a, pos)
        for b in range(4):
            cand = set_base(spec, a, pos, jnp.full_like(cur, b))
            outs.append((cand, cur != b))
    # stable order with skips: emit candidates where mask, keeping reference
    # order == for pos, for b in 0..4 if b != orig.  With vector masks we
    # instead return all 4K candidates + mask; callers mostly need the set.
    cands = jnp.stack([c for c, _ in outs], axis=-2)
    mask = jnp.stack([m for _, m in outs], axis=-1)
    return cands, mask
