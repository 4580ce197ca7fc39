"""FASTA/FASTQ readers feeding the device pipeline.

The reference library takes pre-parsed byte buffers (its pipelines parse
files upstream); a standalone device pipeline needs its own fast reader
to keep the device fed.  Parsing/encoding runs in the native C++ codec when
available (tpu_debruijn/io/native.py), with a pure-Python fallback.
Supports plain and gzip files.
"""

from __future__ import annotations

import gzip
from typing import Iterator, List, Optional

import numpy as np

from tpu_debruijn.io import native as N


def _read_bytes(path: str) -> bytes:
    if str(path).endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def read_fastx(path: str, max_records: Optional[int] = None) -> List[np.ndarray]:
    """Read all sequences of a FASTA/FASTQ(.gz) file as 2-bit code arrays.

    Non-ACGT characters are encoded as 0 (A), matching
    DnaString::from_acgt_bytes (dna_string.rs:228).
    """
    data = _read_bytes(path)
    buf = np.frombuffer(data, np.uint8)
    if len(buf) == 0:
        return []
    if N.native_available():
        cap = max_records or max(16, len(buf) // 32)
        rs, re_, n = N.fastx_scan(buf, cap)
        if n > cap:  # rescan with exact capacity
            rs, re_, n = N.fastx_scan(buf, n)
        out = []
        for i in range(min(n, max_records or n)):
            codes, _ = N.fastx_extract(buf, int(rs[i]), int(re_[i]))
            out.append(codes)
        return out
    return _read_fastx_py(data, max_records)


def _read_fastx_py(data: bytes, max_records: Optional[int]) -> List[np.ndarray]:
    out: List[np.ndarray] = []
    if data[:1] == b"@":  # FASTQ
        lines = data.split(b"\n")
        for i in range(1, len(lines), 4):
            if max_records and len(out) >= max_records:
                break
            if i < len(lines) and lines[i]:
                out.append(N.ascii_to_codes(lines[i]))
    else:  # FASTA
        seq: List[bytes] = []
        for line in data.split(b"\n"):
            if line.startswith(b">"):
                if seq:
                    out.append(N.ascii_to_codes(b"".join(seq)))
                    seq = []
                if max_records and len(out) >= max_records:
                    return out
            elif line:
                seq.append(line.strip())
        if seq and (not max_records or len(out) < max_records):
            out.append(N.ascii_to_codes(b"".join(seq)))
    return out


def read_fasta(path: str, max_records: Optional[int] = None) -> List[np.ndarray]:
    return read_fastx(path, max_records)


def read_fastq(path: str, max_records: Optional[int] = None) -> List[np.ndarray]:
    return read_fastx(path, max_records)


def stream_fastx_blocks(path: str, block_reads: int = 8192,
                        width: Optional[int] = None):
    """Stream a FASTA/FASTQ(.gz) file as device-ready packed read blocks.

    Yields :class:`tpu_debruijn.filter.PackedReadBlock` items: the native
    batch extractor (db_fastx_extract_batch) decodes ``block_reads``
    records per call straight into the 2-bit packed upload format, so the
    feeder does no per-read Python work — feed the generator directly to
    ``filter_kmers_streaming(..., merge='device')``.

    ``width``: unpacked row width in bases (multiple of 16); default =
    the longest record in the file, rounded up.  Longer records are
    truncated to it.
    """
    from tpu_debruijn.filter import PackedReadBlock

    if not N.native_available():
        raise RuntimeError(
            "stream_fastx_blocks requires the native library "
            "(native/libdebruijn_native.so); build with `make -C native`"
        )
    data = _read_bytes(path)
    buf = np.frombuffer(data, np.uint8)
    if len(buf) == 0:
        return
    cap = max(16, len(buf) // 32)
    rs, re_, n = N.fastx_scan(buf, cap)
    if n > cap:
        rs, re_, n = N.fastx_scan(buf, n)
    rs, re_ = rs[:n], re_[:n]
    if width is None:
        # span length bounds the sequence length (it includes newlines)
        width = int((re_ - rs).max(initial=16))
    width = -(-width // 16) * 16
    stride = width // 4
    for lo in range(0, n, block_reads):
        hi = min(lo + block_reads, n)
        rows, lengths, _bad = N.fastx_extract_batch(
            buf, rs[lo:hi], re_[lo:hi], stride
        )
        yield PackedReadBlock(rows, lengths, width)
