"""Packed DNA sequence containers (L2 host/IO layer).

Capability-equivalent to the reference's DnaString / DnaStringSlice /
PackedDnaStringSet (src/dna_string.rs:72-822): arbitrary
length 2-bit packed sequences with slicing, reverse complement, kmer
extraction, and a many-sequences-in-one-buffer set used as unitig storage.

Storage is uint32 words, 16 bases per word, first base in the most
significant bits (32-bit words like the device limbs; the reference uses
u64/32).
These are host-side containers — the device pipeline consumes the padded
base matrices / limb arrays directly.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np

from tpu_debruijn import bases as B
from tpu_debruijn import kmer as KM
from tpu_debruijn.kmer import KmerSpec


def pack_bases(bases: np.ndarray) -> np.ndarray:
    """(L,) 2-bit codes -> (ceil(L/16),) uint32 words (MSB-first)."""
    bases = np.asarray(bases, np.uint32)
    l = len(bases)
    nw = -(-l // 16) if l else 0
    buf = np.zeros(nw * 16, np.uint32)
    buf[:l] = bases
    buf = buf.reshape(nw, 16)
    shifts = (30 - 2 * np.arange(16, dtype=np.uint32)).astype(np.uint32)
    return (buf << shifts).sum(axis=1, dtype=np.uint32)


def unpack_bases(words: np.ndarray, length: int) -> np.ndarray:
    """(nw,) uint32 words -> (length,) 2-bit codes."""
    words = np.asarray(words, np.uint32)
    shifts = (30 - 2 * np.arange(16, dtype=np.uint32)).astype(np.uint32)
    all_b = ((words[:, None] >> shifts[None, :]) & 3).reshape(-1)
    return all_b[:length].astype(np.uint8)


class DnaSeq:
    """A 2-bit packed DNA sequence (DnaString equivalent, dna_string.rs:72).

    Also covers the DnaBytes/DnaSlice/Lmer roles (lib.rs:428-533, vmer.rs):
    any base buffer converts via from_bases; slices are cheap numpy views.
    """

    __slots__ = ("words", "length")

    def __init__(self, words: np.ndarray, length: int):
        self.words = words
        self.length = int(length)

    # constructors -------------------------------------------------------
    @staticmethod
    def from_bases(bases) -> "DnaSeq":
        bases = np.asarray(bases, np.uint8)
        return DnaSeq(pack_bases(bases), len(bases))

    @staticmethod
    def from_dna_string(s: str) -> "DnaSeq":
        """ACGT string (unknown chars -> A; dna_string.rs:187)."""
        return DnaSeq.from_bases(B.ascii_to_bases(s))

    @staticmethod
    def from_dna_only_string(s: str) -> List["DnaSeq"]:
        """Split on non-ACGT characters (dna_string.rs:198)."""
        if isinstance(s, str):
            s = s.encode()
        arr = np.frombuffer(bytes(s), dtype=np.uint8)
        valid = B._ASCII_VALID[arr]
        out = []
        start = None
        for i, v in enumerate(valid):
            if v and start is None:
                start = i
            elif not v and start is not None:
                out.append(DnaSeq.from_bases(B._ASCII_TO_BITS[arr[start:i]]))
                start = None
        if start is not None:
            out.append(DnaSeq.from_bases(B._ASCII_TO_BITS[arr[start:]]))
        return out

    @staticmethod
    def from_acgt_bytes(b) -> "DnaSeq":
        """ASCII bytes, non-ACGT -> A (dna_string.rs:228; the native-codec
        bulk path replaces the reference's AVX2 fast path)."""
        from tpu_debruijn.io.native import ascii_to_codes

        return DnaSeq.from_bases(ascii_to_codes(b))

    @staticmethod
    def from_acgt_bytes_hashn(b, name: bytes) -> "DnaSeq":
        """ASCII bytes; non-ACGT positions become a repeatable pseudo-random
        base from a hash of (read name, position) (dna_string.rs:255-277)."""
        from tpu_debruijn.io.native import ascii_to_codes

        if isinstance(b, str):
            b = b.encode()
        codes, mask, bad = ascii_to_codes(b, with_mask=True)
        if bad:
            import hashlib

            pos = np.nonzero(~mask)[0]
            seed = hashlib.blake2b(bytes(name), digest_size=8).digest()
            rnd = np.array(
                [
                    hashlib.blake2b(
                        seed + int(i).to_bytes(8, "little"), digest_size=8
                    ).digest()[0]
                    % 4
                    for i in pos
                ],
                np.uint8,
            )
            codes = codes.copy()
            codes[pos] = rnd
        return DnaSeq.from_bases(codes)

    @staticmethod
    def blank(length: int) -> "DnaSeq":
        return DnaSeq.from_bases(np.zeros(length, np.uint8))

    # incremental builders (dna_string.rs:303-380).  DnaSeq is an
    # immutable value type here, so these return NEW sequences; use
    # DnaSeqBuilder for amortized O(1)-per-base accumulation.
    def push(self, base: int) -> "DnaSeq":
        """Append one 0-3 base (DnaString::push, dna_string.rs:303)."""
        return DnaSeq.from_bases(np.append(self.bases(), np.uint8(base & 3)))

    def extend(self, bases) -> "DnaSeq":
        """Append many 0-3 bases (DnaString::extend, dna_string.rs:312)."""
        bs = np.fromiter((int(b) & 3 for b in bases), np.uint8)
        return DnaSeq.from_bases(np.concatenate([self.bases(), bs]))

    def push_bytes(self, packed: bytes, seq_length: int) -> "DnaSeq":
        """Append ``seq_length`` bases read from 2-bit packed bytes,
        LSB-first within each byte (DnaString::push_bytes,
        dna_string.rs:351-366)."""
        arr = np.frombuffer(bytes(packed), np.uint8)
        if seq_length > len(arr) * 4:
            raise ValueError("Number of elements to push exceeds array length")
        i = np.arange(seq_length)
        vals = (arr[i // 4] >> ((i % 4) * 2).astype(np.uint8)) & 3
        return DnaSeq.from_bases(
            np.concatenate([self.bases(), vals.astype(np.uint8)])
        )

    # accessors ----------------------------------------------------------
    def __len__(self):
        return self.length

    def is_empty(self) -> bool:
        return self.length == 0

    def bases(self) -> np.ndarray:
        return unpack_bases(self.words, self.length)

    def get(self, pos: int) -> int:
        w, o = divmod(pos, 16)
        return int((self.words[w] >> np.uint32(30 - 2 * o)) & 3)

    def get_kmer(self, k: int, pos: int) -> np.ndarray:
        """Kmer limbs at position pos (Vmer::get_kmer, lib.rs:366)."""
        return KM.from_bases(KmerSpec(k), self.bases()[pos : pos + k])

    def first_kmer(self, k: int) -> np.ndarray:
        return self.get_kmer(k, 0)

    def last_kmer(self, k: int) -> np.ndarray:
        return self.get_kmer(k, self.length - k)

    def set(self, pos: int, val: int) -> "DnaSeq":
        """New sequence with base ``pos`` replaced (MerImmut, lib.rs:331)."""
        w, o = divmod(pos, 16)
        words = self.words.copy()
        sh = np.uint32(30 - 2 * o)
        words[w] = (words[w] & ~(np.uint32(3) << sh)) | (np.uint32(val & 3) << sh)
        return DnaSeq(words, self.length)

    def iter_kmers(self, k: int):
        b = self.bases()
        spec = KmerSpec(k)
        for i in range(self.length - k + 1):
            yield KM.from_bases(spec, b[i : i + k])

    def iter_kmer_exts(self, k: int, seq_exts: int = 0):
        """Yield (kmer limbs, exts) per position (Vmer::iter_kmer_exts,
        lib.rs:408-421): each kmer's extensions are its neighboring bases
        within this sequence, falling back to ``seq_exts`` at the ends."""
        from tpu_debruijn import exts as E

        b = self.bases()
        spec = KmerSpec(k)
        n = self.length - k + 1
        for i in range(n):
            e = E.from_slice_bounds(b, i, k)
            if i == 0:
                e |= seq_exts & 0x0F
            if i == n - 1:
                e |= seq_exts & 0xF0
            yield KM.from_bases(spec, b[i : i + k]), int(e)

    def slice(self, start: int, end: int) -> "DnaSeq":
        return DnaSeq.from_bases(self.bases()[start:end])

    def slice_view(self, start: int, end: int) -> "SeqSlice":
        """Zero-copy view (DnaString::slice, dna_string.rs:430-439)."""
        return SeqSlice(self, start, end - start, False)

    def prefix(self, n: int) -> "DnaSeq":
        return self.slice(0, n)

    def suffix(self, n: int) -> "DnaSeq":
        return self.slice(self.length - n, self.length)

    def rc(self) -> "DnaSeq":
        return DnaSeq.from_bases((3 - self.bases()[::-1]).astype(np.uint8))

    def reverse(self) -> "DnaSeq":
        return DnaSeq.from_bases(self.bases()[::-1])

    def hamming_distance(self, other: "DnaSeq") -> int:
        return int((self.bases() != other.bases()).sum())

    def ndiffs(self, other: "DnaSeq") -> int:
        """Differing-base count via packed-word XOR + popcount, the
        reference's block-wise fast path (dna_string.rs:523-539)."""
        if self.length != other.length:
            raise ValueError("ndiffs requires equal lengths")
        x = self.words ^ other.words
        pair = (x | (x >> np.uint32(1))) & np.uint32(0x55555555)
        return int(
            np.unpackbits(pair.view(np.uint8)).sum()
        )

    def at_count(self) -> int:
        """Number of A/T bases (Mer::at_count, lib.rs:151-158)."""
        b = self.bases()
        return int(((b == 0) | (b == 3)).sum())

    def gc_count(self) -> int:
        """Number of G/C bases (Mer::gc_count, lib.rs:161)."""
        return self.length - self.at_count()

    def to_dna_string(self) -> str:
        return B.bases_to_str(self.bases())

    def to_ascii(self) -> bytes:
        return B.bases_to_ascii(self.bases())

    def __eq__(self, other):
        return (
            isinstance(other, DnaSeq)
            and self.length == other.length
            and np.array_equal(self.bases(), other.bases())
        )

    def __repr__(self):
        s = self.to_dna_string()
        return s if len(s) <= 60 else s[:57] + "..."


class DnaSeqBuilder:
    """Amortized incremental builder for DnaSeq (the mutable-accumulation
    role of DnaString::push/extend, dna_string.rs:303-349)."""

    def __init__(self):
        self._chunks: List[np.ndarray] = []
        self._len = 0

    def __len__(self):
        return self._len

    def push(self, base: int) -> None:
        self._chunks.append(np.array([base & 3], np.uint8))
        self._len += 1

    def extend(self, bases) -> None:
        arr = (
            np.asarray(
                list(bases) if not isinstance(bases, np.ndarray) else bases,
                np.uint8,
            )
            & 3
        )
        self._chunks.append(arr)
        self._len += len(arr)

    def clear(self) -> None:
        self._chunks = []
        self._len = 0

    def build(self) -> DnaSeq:
        if not self._chunks:
            return DnaSeq.from_bases(np.zeros(0, np.uint8))
        return DnaSeq.from_bases(np.concatenate(self._chunks))


class SeqSlice:
    """Zero-copy view ``{parent, start, length, is_rc}`` of a DnaSeq
    (DnaStringSlice equivalent, dna_string.rs:541-758).

    No bases are copied: ``get`` applies the complement-and-mirror remap
    when ``is_rc`` (dna_string.rs:577-583); ``rc()`` just flips the flag
    (dna_string.rs:596-603); re-slicing remaps coordinates under rc
    (dna_string.rs:668-695).  ``to_owned`` materializes a DnaSeq.
    """

    __slots__ = ("parent", "start", "length", "is_rc")

    def __init__(self, parent: "DnaSeq", start: int, length: int, is_rc: bool = False):
        if start < 0 or start + length > len(parent):
            raise ValueError("slice out of range")
        self.parent = parent
        self.start = int(start)
        self.length = int(length)
        self.is_rc = bool(is_rc)

    def __len__(self):
        return self.length

    def is_empty(self) -> bool:
        return self.length == 0

    def get(self, pos: int) -> int:
        """dna_string.rs:577-583: mirror + complement under rc."""
        if self.is_rc:
            return 3 - self.parent.get(self.start + self.length - 1 - pos)
        return self.parent.get(self.start + pos)

    def rc(self) -> "SeqSlice":
        """Flip the orientation flag only (dna_string.rs:596-603)."""
        return SeqSlice(self.parent, self.start, self.length, not self.is_rc)

    def slice(self, start: int, end: int) -> "SeqSlice":
        """Re-slice, remapping coordinates under rc (dna_string.rs:668-695)."""
        if not (0 <= start <= end <= self.length):
            raise ValueError("slice out of range")
        ln = end - start
        if self.is_rc:
            return SeqSlice(self.parent, self.start + self.length - end, ln, True)
        return SeqSlice(self.parent, self.start + start, ln, False)

    def prefix(self, n: int) -> "SeqSlice":
        return self.slice(0, n)

    def suffix(self, n: int) -> "SeqSlice":
        return self.slice(self.length - n, self.length)

    def bases(self) -> np.ndarray:
        b = self.parent.bases()[self.start : self.start + self.length]
        return (3 - b[::-1]).astype(np.uint8) if self.is_rc else b

    def get_kmer(self, k: int, pos: int) -> np.ndarray:
        """Pull from the parent and rc if needed (dna_string.rs:616-626)."""
        return KM.from_bases(KmerSpec(k), self.bases()[pos : pos + k])

    def first_kmer(self, k: int) -> np.ndarray:
        return self.get_kmer(k, 0)

    def last_kmer(self, k: int) -> np.ndarray:
        return self.get_kmer(k, self.length - k)

    def iter_kmers(self, k: int):
        b = self.bases()
        spec = KmerSpec(k)
        for i in range(self.length - k + 1):
            yield KM.from_bases(spec, b[i : i + k])

    def to_owned(self) -> "DnaSeq":
        """Materialize (dna_string.rs:642-666)."""
        return DnaSeq.from_bases(self.bases())

    to_dna_seq = to_owned

    def to_dna_string(self) -> str:
        return B.bases_to_str(self.bases())

    def to_ascii(self) -> bytes:
        return B.bases_to_ascii(self.bases())

    def __eq__(self, other):
        if isinstance(other, (SeqSlice, DnaSeq)):
            return self.length == len(other) and np.array_equal(
                self.bases(),
                other.bases(),
            )
        return NotImplemented

    def __repr__(self):
        s = self.to_dna_string()
        return s if len(s) <= 60 else s[:57] + "..."


class PackedSeqSet:
    """Many sequences in one packed buffer (PackedDnaStringSet,
    dna_string.rs:762-822).  The unitig storage of the graph.

    The AUTHORITATIVE storage is 2-bit packed uint32 words (16 bases per
    word, MSB-first — the reference packs 32/u64, dna_string.rs:72), so a
    100M-base unitig store holds 25MB resident instead of 100MB of uint8
    codes.  Appends queue uint8 chunks and
    are packed on consolidation (carrying a <16-base mid-word tail
    between consolidations); ``_flat()`` unpacks the whole stream
    TRANSIENTLY for one-shot bulk consumers (graph indexing, stitching,
    combine) and is never cached; ``get_bases`` unpacks only the word
    range covering one sequence.

    Bulk ``add_flat`` appends a whole flat buffer + length array with no
    per-node loop (the million-unitig path — graph.rs:71-141's combine).
    """

    def __init__(self):
        self._words = np.zeros(0, np.uint32)  # packed full words
        self._tail = np.zeros(0, np.uint8)  # <16 bases past the last word
        self._total = 0  # bases covered by _words + _tail
        self._lengths = np.zeros(0, np.int64)
        self._starts = np.zeros(0, np.int64)
        self._chunks: List[np.ndarray] = []
        self._len_chunks: List[np.ndarray] = []
        self._n = 0

    @staticmethod
    def from_arrays(seqs: Iterable[np.ndarray]) -> "PackedSeqSet":
        s = PackedSeqSet()
        for q in seqs:
            s.add(q)
        return s

    @staticmethod
    def from_flat(flat: np.ndarray, lengths: np.ndarray) -> "PackedSeqSet":
        """Bulk constructor: concatenated bases + per-sequence lengths."""
        s = PackedSeqSet()
        s.add_flat(flat, lengths)
        return s

    @staticmethod
    def from_packed(words: np.ndarray, lengths: np.ndarray) -> "PackedSeqSet":
        """Bulk constructor from already-packed words (checkpoint load)."""
        s = PackedSeqSet()
        lengths = np.asarray(lengths, np.int64)
        total = int(lengths.sum())
        if len(words) * 16 < total:
            raise ValueError("packed words shorter than lengths imply")
        s._words = np.asarray(words, np.uint32)[: (total + 15) // 16]
        # move any partial-word remainder into the tail so appends align
        nw = total // 16
        rem = total - nw * 16
        if rem:
            s._tail = unpack_bases(s._words[nw : nw + 1], rem)
            s._words = s._words[:nw]
        s._total = total
        s._lengths = lengths
        s._starts = np.zeros(len(lengths), np.int64)
        np.cumsum(lengths[:-1], out=s._starts[1:])
        s._n = len(lengths)
        return s

    def add(self, bases) -> None:
        bases = np.asarray(bases, np.uint8)
        self._chunks.append(bases)
        self._len_chunks.append(np.array([len(bases)], np.int64))
        self._n += 1

    def add_flat(self, flat: np.ndarray, lengths: np.ndarray) -> None:
        """Append many sequences at once (flat buffer + lengths)."""
        lengths = np.asarray(lengths, np.int64)
        flat = np.asarray(flat, np.uint8)
        if int(lengths.sum()) != len(flat):
            raise ValueError("lengths do not sum to flat buffer size")
        self._chunks.append(flat)
        self._len_chunks.append(lengths)
        self._n += len(lengths)

    def _consolidate(self) -> None:
        if self._chunks:
            pend = np.concatenate([self._tail] + self._chunks)
            self._chunks = []
            nw = len(pend) // 16
            if nw:
                self._words = np.concatenate(
                    [self._words, pack_bases(pend[: nw * 16])]
                )
            self._tail = pend[nw * 16 :]
            self._total = len(self._words) * 16 + len(self._tail)
            self._lengths = np.concatenate([self._lengths] + self._len_chunks)
            self._len_chunks = []
            self._starts = np.zeros(len(self._lengths), np.int64)
            np.cumsum(self._lengths[:-1], out=self._starts[1:])

    def _flat(self) -> np.ndarray:
        """The whole base stream as uint8 codes — a TRANSIENT unpacked
        copy for one-shot bulk consumers; not cached."""
        self._consolidate()
        out = np.empty(self._total, np.uint8)
        nw = len(self._words)
        out[: nw * 16] = unpack_bases(self._words, nw * 16)
        out[nw * 16 :] = self._tail
        return out

    @property
    def length(self) -> np.ndarray:
        self._consolidate()
        return self._lengths

    @property
    def start(self) -> np.ndarray:
        self._consolidate()
        return self._starts

    def __len__(self):
        return self._n

    def is_empty(self) -> bool:
        return self._n == 0

    def get_bases(self, i: int) -> np.ndarray:
        """Unpack only the word range covering sequence i."""
        self._consolidate()
        s = int(self._starts[i])
        ln = int(self._lengths[i])
        w0, off = divmod(s, 16)
        w1 = (s + ln + 15) // 16
        nw = len(self._words)
        if w1 <= nw:
            seg = unpack_bases(self._words[w0:w1], (w1 - w0) * 16)
        else:
            head = unpack_bases(self._words[w0:nw], (nw - w0) * 16)
            seg = np.concatenate([head, self._tail])
        return seg[off : off + ln]

    def get(self, i: int) -> DnaSeq:
        return DnaSeq.from_bases(self.get_bases(i))

    def packed_words(self) -> np.ndarray:
        """Whole buffer as packed uint32 words (checkpoint format)."""
        self._consolidate()
        if len(self._tail):
            return np.concatenate([self._words, pack_bases(self._tail)])
        return self._words

    def total_bases(self) -> int:
        self._consolidate()
        return int(self._lengths.sum())
