"""ctypes bindings for the native host codec (native/debruijn_native.cpp).

The host counterpart of the reference's AVX2 kernels
(src/bitops_avx2.rs, used by DnaString::from_acgt_bytes,
dna_string.rs:228-245): auto-vectorized C++ doing ASCII<->2-bit conversion,
validation, and word packing on the host IO path, with a NumPy fallback
when the library cannot be built.

The library is compiled from the committed source at first use, on the
machine that loads it, into a path that git ignores.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger("tpu_debruijn.io.native")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_SO_PATH = os.path.join(os.path.dirname(__file__), "libdebruijn_native.so")
_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "debruijn_native.cpp",
)
# portable code: no -march=native, so a library built on one host never
# meets an instruction another host lacks
_CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared", "-Wall", "-Wextra"]


def _build() -> bool:
    """Compile the codec into ``_SO_PATH`` unless an up-to-date one exists.

    The compiler writes a temporary file in the same directory, which is
    then renamed over ``_SO_PATH``: the rename is atomic, so processes
    racing to build at first use each load a complete library.
    """
    if not os.path.exists(_SRC):
        return os.path.exists(_SO_PATH)
    if (os.path.exists(_SO_PATH)
            and os.path.getmtime(_SO_PATH) >= os.path.getmtime(_SRC)):
        return True
    cxx = os.environ.get("CXX", "g++")
    tmp = None
    try:
        fd, tmp = tempfile.mkstemp(
            prefix=".libdebruijn_native.", suffix=".so",
            dir=os.path.dirname(_SO_PATH),
        )
        os.close(fd)
        res = subprocess.run(
            [cxx, *_CXXFLAGS, "-o", tmp, _SRC], capture_output=True, text=True
        )
        if res.returncode != 0:
            log.warning("native codec build failed; using NumPy:\n%s",
                        res.stderr[-2000:])
            return False
        os.replace(tmp, _SO_PATH)
        return True
    except OSError as exn:
        log.warning("native codec build failed (%s); using NumPy", exn)
        return False
    finally:
        if tmp is not None and os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not _build():
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.db_ascii_to_codes.restype = ctypes.c_int64
        lib.db_ascii_to_codes.argtypes = [u8p, ctypes.c_int64, u8p, u8p]
        lib.db_codes_to_ascii.restype = None
        lib.db_codes_to_ascii.argtypes = [u8p, ctypes.c_int64, u8p]
        lib.db_pack_codes_u32.restype = None
        lib.db_pack_codes_u32.argtypes = [u8p, ctypes.c_int64, u32p]
        lib.db_unpack_codes_u32.restype = None
        lib.db_unpack_codes_u32.argtypes = [u32p, ctypes.c_int64, u8p]
        lib.db_rc_codes.restype = None
        lib.db_rc_codes.argtypes = [u8p, ctypes.c_int64, u8p]
        lib.db_fastx_scan.restype = ctypes.c_int64
        lib.db_fastx_scan.argtypes = [u8p, ctypes.c_int64, i64p, i64p, ctypes.c_int64]
        lib.db_fastx_extract.restype = ctypes.c_int64
        lib.db_fastx_extract.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, u8p, i64p]
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.db_fastx_extract_batch.restype = ctypes.c_int64
        lib.db_fastx_extract_batch.argtypes = [
            u8p, i64p, i64p, ctypes.c_int64, u8p, ctypes.c_int64, i32p,
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def native_available() -> bool:
    return _load() is not None


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def ascii_to_codes(ascii_bytes, with_mask: bool = False):
    """ASCII -> 2-bit codes; invalid chars become 0.

    Returns codes, or (codes, valid_mask, n_invalid) if with_mask.
    base_to_bits / dna_only_base_to_bits equivalent (lib.rs:65-92) on the
    bulk path.
    """
    arr = np.frombuffer(bytes(ascii_bytes), dtype=np.uint8).copy() if not isinstance(
        ascii_bytes, np.ndarray
    ) else np.ascontiguousarray(ascii_bytes, np.uint8)
    n = len(arr)
    codes = np.empty(n, np.uint8)
    lib = _load()
    if lib is not None:
        mask = np.empty(n, np.uint8) if with_mask else None
        bad = lib.db_ascii_to_codes(
            _u8p(arr), n, _u8p(codes), _u8p(mask) if with_mask else None
        )
        if with_mask:
            return codes, mask.astype(bool), int(bad)
        return codes
    # NumPy fallback
    x = (arr >> 1) & 3
    codes = (x ^ ((x >> 1) & 1)).astype(np.uint8)
    up = arr & 0xDF
    ok = (up == 65) | (up == 67) | (up == 71) | (up == 84)
    codes[~ok] = 0
    if with_mask:
        return codes, ok, int((~ok).sum())
    return codes


def codes_to_ascii(codes: np.ndarray) -> bytes:
    codes = np.ascontiguousarray(codes, np.uint8)
    lib = _load()
    if lib is not None:
        out = np.empty(len(codes), np.uint8)
        lib.db_codes_to_ascii(_u8p(codes), len(codes), _u8p(out))
        return out.tobytes()
    return np.frombuffer(b"ACGT", np.uint8)[codes & 3].tobytes()


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """2-bit codes -> uint32 words (16/word, MSB-first)."""
    codes = np.ascontiguousarray(codes, np.uint8)
    n = len(codes)
    nw = -(-n // 16) if n else 0
    lib = _load()
    if lib is not None:
        out = np.empty(nw, np.uint32)
        lib.db_pack_codes_u32(_u8p(codes), n, _u32p(out))
        return out
    from tpu_debruijn.dna import pack_bases

    return pack_bases(codes)


def unpack_codes(words: np.ndarray, length: int) -> np.ndarray:
    words = np.ascontiguousarray(words, np.uint32)
    lib = _load()
    if lib is not None:
        out = np.empty(length, np.uint8)
        lib.db_unpack_codes_u32(_u32p(words), length, _u8p(out))
        return out
    from tpu_debruijn.dna import unpack_bases

    return unpack_bases(words, length)


def rc_codes(codes: np.ndarray) -> np.ndarray:
    codes = np.ascontiguousarray(codes, np.uint8)
    lib = _load()
    if lib is not None:
        out = np.empty(len(codes), np.uint8)
        lib.db_rc_codes(_u8p(codes), len(codes), _u8p(out))
        return out
    return (3 - codes[::-1]).astype(np.uint8)


def fastx_scan(buf: np.ndarray, max_records: int) -> Tuple[np.ndarray, np.ndarray, int]:
    lib = _load()
    rs = np.empty(max_records, np.int64)
    re_ = np.empty(max_records, np.int64)
    n = lib.db_fastx_scan(_u8p(buf), len(buf), _i64p(rs), _i64p(re_), max_records)
    return rs, re_, int(n)


def fastx_extract(buf: np.ndarray, start: int, end: int):
    lib = _load()
    codes = np.empty(end - start, np.uint8)
    bad = np.zeros(1, np.int64)
    m = lib.db_fastx_extract(_u8p(buf), start, end, _u8p(codes), _i64p(bad))
    return codes[:m], int(bad[0])


def fastx_extract_batch(buf: np.ndarray, rec_start: np.ndarray,
                        rec_end: np.ndarray, row_stride: int):
    """Decode a batch of record spans into one (m, row_stride) 2-bit
    PACKED row matrix (4 bases/byte, little-endian in the byte — the
    device streaming upload format) + per-record lengths.  One native
    call replaces m Python-side round trips.  Returns (rows, lengths,
    n_invalid)."""
    lib = _load()
    rs = np.ascontiguousarray(rec_start, np.int64)
    re_ = np.ascontiguousarray(rec_end, np.int64)
    m = len(rs)
    rows = np.empty((m, row_stride), np.uint8)
    lengths = np.empty(m, np.int32)
    bad = lib.db_fastx_extract_batch(
        _u8p(buf), _i64p(rs), _i64p(re_), m, _u8p(rows), row_stride,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return rows, lengths, int(bad)
