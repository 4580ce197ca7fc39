"""Extension bitmask (Exts) algebra and Dir, vectorized over int32 arrays.

Capability-equivalent to the reference's ``Exts`` (/root/reference/src/
lib.rs:569-749) and ``Dir`` (lib.rs:537-567).  One byte per kmer/node:
bit layout ``T G C A | T G C A`` — high nibble = right extensions, low
nibble = left extensions, bit b set means an extension with base b exists.

All ops are elementwise on integer arrays (we carry the byte in int32,
the lane width of every other per-kmer array).  Scalar convenience wrappers (class ``Exts``) exist for
host-side/graph-API use.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Direction of motion in the graph (lib.rs:537).  LEFT=0, RIGHT=1.
LEFT = 0
RIGHT = 1


class Dir:
    """Namespace mirroring the reference Dir enum; directions are ints."""

    Left = LEFT
    Right = RIGHT

    @staticmethod
    def flip(d):
        return 1 - d if isinstance(d, int) else 1 - jnp.asarray(d)

    @staticmethod
    def cond_flip(d, do_flip):
        if isinstance(d, int) and isinstance(do_flip, (bool, np.bool_)):
            return 1 - d if do_flip else d
        return jnp.where(jnp.asarray(do_flip), 1 - jnp.asarray(d), jnp.asarray(d))

    @staticmethod
    def pick(d, if_left, if_right):
        return if_left if d == LEFT else if_right


# ---------------------------------------------------------------------------
# vectorized ops (arrays of exts bytes)
# ---------------------------------------------------------------------------


def merge(left, right):
    """Left nibble from ``left``, right nibble from ``right``.  lib.rs:597."""
    return (left & 0x0F) | (right & 0xF0)


def add(a, b):
    """Union of extensions.  lib.rs:603."""
    return a | b


def set_ext(e, d, base):
    """Set extension ``base`` in direction ``d``.  lib.rs:609."""
    return e | (1 << (base + 4 * d))


def dir_bits(e, d):
    """The 4 extension bits for direction ``d`` (right = high nibble)."""
    return (e >> (4 * d)) & 0xF


def has_ext(e, d, base):
    return (dir_bits(e, d) & (1 << base)) > 0


def num_ext_dir(e, d):
    """Popcount of the direction nibble.  lib.rs:687."""
    b = dir_bits(e, d)
    return (b & 1) + ((b >> 1) & 1) + ((b >> 2) & 1) + ((b >> 3) & 1)


def mk_left(base):
    return 1 << base


def mk_right(base):
    return (1 << base) << 4


def mk(left_base, right_base):
    return mk_left(left_base) | mk_right(right_base)


def unique_extension(e, d):
    """(has_unique, base) for direction d.  lib.rs:704-717.

    base is only meaningful where has_unique; it is the index of the single
    set bit.
    """
    b = dir_bits(e, d)
    uniq = num_ext_dir(e, d) == 1
    base = ((b >> 1) & 1) * 1 + ((b >> 2) & 1) * 2 + ((b >> 3) & 1) * 3
    return uniq, base


def single_dir(e, d):
    """Keep only direction d's bits, moved to the low nibble.  lib.rs:719."""
    return dir_bits(e, d)


def complement_bits(e):
    """Reverse the bit order within each nibble (base -> complement base).

    lib.rs:729-738: swap adjacent bits then adjacent pairs.
    """
    r = ((e & 0x55) << 1) | ((e >> 1) & 0x55)
    return ((r & 0x33) << 2) | ((r >> 2) & 0x33)


def reverse(e):
    """Swap the left/right nibbles.  lib.rs:740."""
    return ((e & 0x0F) << 4) | ((e >> 4) & 0x0F)


def rc(e):
    """Reverse complement = reverse then complement.  lib.rs:746."""
    return complement_bits(reverse(e))


def from_single_dirs(left, right):
    """lib.rs:591: low nibble of left + (low nibble of right) << 4."""
    return ((right & 0x0F) << 4) | (left & 0x0F)


def from_slice_bounds(src, start: int, length: int):
    """Exts of a substring within its parent read.  lib.rs:645-660.

    ``src`` is a host array of 2-bit codes.
    """
    src = np.asarray(src)
    l_ext = (1 << int(src[start - 1])) if start > 0 else 0
    r_ext = (1 << int(src[start + length])) if start + length < len(src) else 0
    return (r_ext << 4) | l_ext


# ---------------------------------------------------------------------------
# scalar convenience wrapper (host / graph API)
# ---------------------------------------------------------------------------


class Exts:
    """Scalar Exts value with the reference's method surface (lib.rs:582)."""

    __slots__ = ("val",)

    def __init__(self, val: int = 0):
        self.val = int(val) & 0xFF

    # constructors
    @staticmethod
    def empty() -> "Exts":
        return Exts(0)

    @staticmethod
    def new(val: int) -> "Exts":
        return Exts(val)

    @staticmethod
    def from_single_dirs(left: "Exts", right: "Exts") -> "Exts":
        return Exts(from_single_dirs(left.val, right.val))

    @staticmethod
    def merge(left: "Exts", right: "Exts") -> "Exts":
        return Exts(merge(left.val, right.val))

    @staticmethod
    def mk(left_base: int, right_base: int) -> "Exts":
        return Exts(mk(left_base, right_base))

    @staticmethod
    def mk_left(base: int) -> "Exts":
        return Exts(mk_left(base))

    @staticmethod
    def mk_right(base: int) -> "Exts":
        return Exts(mk_right(base))

    @staticmethod
    def from_slice_bounds(src, start: int, length: int) -> "Exts":
        return Exts(from_slice_bounds(src, start, length))

    # ops
    def add(self, other: "Exts") -> "Exts":
        return Exts(self.val | other.val)

    def set(self, d: int, base: int) -> "Exts":
        return Exts(set_ext(self.val, d, base))

    def get(self, d: int):
        b = dir_bits(self.val, d)
        return [i for i in range(4) if b & (1 << i)]

    def has_ext(self, d: int, base: int) -> bool:
        return bool(has_ext(self.val, d, base))

    def num_ext_dir(self, d: int) -> int:
        return int(num_ext_dir(self.val, d))

    def num_exts_l(self) -> int:
        return self.num_ext_dir(LEFT)

    def num_exts_r(self) -> int:
        return self.num_ext_dir(RIGHT)

    def get_unique_extension(self, d: int):
        u, b = unique_extension(self.val, d)
        return int(b) if u else None

    def single_dir(self, d: int) -> "Exts":
        return Exts(single_dir(self.val, d))

    def complement(self) -> "Exts":
        return Exts(complement_bits(self.val))

    def reverse(self) -> "Exts":
        return Exts(reverse(self.val))

    def rc(self) -> "Exts":
        return Exts(rc(self.val))

    def __eq__(self, other):
        return isinstance(other, Exts) and self.val == other.val

    def __hash__(self):
        return hash(self.val)

    def __repr__(self):
        l = "".join("ACGT"[b] for b in self.get(LEFT))
        r = "".join("ACGT"[b] for b in self.get(RIGHT))
        return f"{l}|{r}"
