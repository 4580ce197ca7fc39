// Native host runtime for tpu_debruijn: ASCII<->2-bit codec + FASTA/FASTQ IO.
//
// This is the host counterpart of the reference's native layer
// (src/bitops_avx2.rs: AVX2 convert_bases + pack_32_bases, wired into
// DnaString::from_acgt_bytes, dna_string.rs:228-245).  Written as portable
// C++ that the compiler auto-vectorizes (-O3, no -march=native, so the
// library runs on any x86-64 host); exposed to Python via ctypes.
// tpu_debruijn/io/native.py compiles it at first use.
//
// Functions
//   db_ascii_to_codes  : ASCII bytes -> 2-bit codes, returns invalid count
//   db_codes_to_ascii  : 2-bit codes -> ACGT ASCII
//   db_pack_codes_u32  : 2-bit codes -> uint32 words, 16 bases/word MSB-first
//   db_unpack_codes_u32: inverse of pack
//   db_fastx_scan      : scan a FASTA/FASTQ buffer -> record offsets
//   db_fastx_extract   : extract + encode all sequences into one code buffer

#include <cstdint>
#include <cstring>
#include <cstddef>

extern "C" {

// ASCII -> 2-bit codes (A/a=0 C/c=1 G/g=2 T/t=3).  Invalid characters get
// code 0 and are counted; callers wanting hash-seeded randomization
// (from_acgt_bytes_hashn, dna_string.rs:255) post-process via the mask.
int64_t db_ascii_to_codes(const uint8_t* ascii, int64_t n, uint8_t* codes,
                          uint8_t* valid_mask /* nullable */) {
    // bit trick: code = ((c>>1)&3) with 2<->3 swapped = x ^ ((x>>1)&1)
    int64_t n_invalid = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint8_t c = ascii[i];
        uint8_t x = (c >> 1) & 3;
        uint8_t code = x ^ ((x >> 1) & 1);
        uint8_t up = c & 0xDF;  // uppercase
        uint8_t ok = (up == 'A') | (up == 'C') | (up == 'G') | (up == 'T');
        codes[i] = ok ? code : 0;
        if (valid_mask) valid_mask[i] = ok;
        n_invalid += !ok;
    }
    return n_invalid;
}

void db_codes_to_ascii(const uint8_t* codes, int64_t n, uint8_t* ascii) {
    static const uint8_t LUT[4] = {'A', 'C', 'G', 'T'};
    for (int64_t i = 0; i < n; ++i) ascii[i] = LUT[codes[i] & 3];
}

// 2-bit codes -> uint32 words, 16 bases per word, first base in the two
// most significant bits (the engine's canonical packing; kmer.py layout).
void db_pack_codes_u32(const uint8_t* codes, int64_t n, uint32_t* words) {
    int64_t nw = (n + 15) / 16;
    for (int64_t w = 0; w < nw; ++w) {
        uint32_t acc = 0;
        int64_t base = w * 16;
        int64_t lim = n - base < 16 ? n - base : 16;
        for (int64_t j = 0; j < lim; ++j)
            acc |= (uint32_t)(codes[base + j] & 3) << (30 - 2 * j);
        words[w] = acc;
    }
}

void db_unpack_codes_u32(const uint32_t* words, int64_t n, uint8_t* codes) {
    for (int64_t i = 0; i < n; ++i)
        codes[i] = (words[i / 16] >> (30 - 2 * (i % 16))) & 3;
}

// Reverse complement of a code buffer.
void db_rc_codes(const uint8_t* codes, int64_t n, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) out[i] = 3 - codes[n - 1 - i];
}

// ---------------------------------------------------------------------------
// FASTA/FASTQ scanning (host IO; the reference has no file IO — callers
// pass byte buffers — but a device pipeline needs a fast reader to keep
// the device fed).
// ---------------------------------------------------------------------------

// Scan a FASTA ('>') or FASTQ ('@') text buffer.  Fills (seq_start, seq_len)
// pairs for up to max_records sequences; multi-line FASTA records report the
// span of the first line only if they contain internal newlines -- so we
// instead report (record_start, record_end) of the raw sequence region and
// let db_fastx_extract stitch the lines.  Returns the number of records
// found (may exceed max_records; only max_records offsets are written).
int64_t db_fastx_scan(const uint8_t* buf, int64_t n, int64_t* rec_start,
                      int64_t* rec_end, int64_t max_records) {
    if (n == 0) return 0;
    int is_fastq = buf[0] == '@';
    int64_t count = 0;
    int64_t i = 0;
    while (i < n) {
        if (is_fastq) {
            // @header\nSEQ\n+\nQUAL\n
            while (i < n && buf[i] != '\n') ++i;            // header
            ++i;
            int64_t s = i;
            while (i < n && buf[i] != '\n') ++i;            // sequence
            if (count < max_records) { rec_start[count] = s; rec_end[count] = i; }
            ++count;
            ++i;
            while (i < n && buf[i] != '\n') ++i;            // '+'
            ++i;
            while (i < n && buf[i] != '\n') ++i;            // qual
            ++i;
        } else {
            if (buf[i] == '>') {
                while (i < n && buf[i] != '\n') ++i;        // header
                ++i;
                int64_t s = i;
                while (i < n && buf[i] != '>') ++i;         // seq lines
                if (count < max_records) { rec_start[count] = s; rec_end[count] = i; }
                ++count;
            } else {
                ++i;
            }
        }
    }
    return count;
}

// Extract record [start, end) spans into a dense code buffer, skipping
// newlines/whitespace, encoding ASCII -> 2-bit.  Returns encoded length;
// n_invalid accumulates non-ACGT characters (encoded as 0).
int64_t db_fastx_extract(const uint8_t* buf, int64_t start, int64_t end,
                         uint8_t* codes, int64_t* n_invalid) {
    int64_t m = 0;
    int64_t bad = 0;
    for (int64_t i = start; i < end; ++i) {
        uint8_t c = buf[i];
        if (c == '\n' || c == '\r' || c == ' ' || c == '\t') continue;
        uint8_t x = (c >> 1) & 3;
        uint8_t code = x ^ ((x >> 1) & 1);
        uint8_t up = c & 0xDF;
        uint8_t ok = (up == 'A') | (up == 'C') | (up == 'G') | (up == 'T');
        codes[m++] = ok ? code : 0;
        bad += !ok;
    }
    if (n_invalid) *n_invalid += bad;
    return m;
}

// Batched extract: decode ``m`` records (given their [start, end) spans)
// straight into one (m, row_stride) 2-BIT-PACKED row matrix (4 bases per
// byte, little-endian within the byte — the device streaming pipeline's
// upload format, filter._unpack2bit) plus per-record lengths.  One call
// replaces m Python-side ctypes round trips — the streaming feeder's
// per-record overhead at 1M+ reads.  Rows longer than row_stride*4 bases
// are truncated (callers size the stride from the corpus).  Returns the
// number of invalid (non-ACGT, encoded 0) characters seen.
int64_t db_fastx_extract_batch(const uint8_t* buf, const int64_t* rec_start,
                               const int64_t* rec_end, int64_t m,
                               uint8_t* packed_rows, int64_t row_stride,
                               int32_t* lengths) {
    int64_t bad = 0;
    for (int64_t r = 0; r < m; ++r) {
        uint8_t* row = packed_rows + r * row_stride;
        std::memset(row, 0, (size_t)row_stride);
        int64_t len = 0;
        int64_t cap = row_stride * 4;
        for (int64_t i = rec_start[r]; i < rec_end[r] && len < cap; ++i) {
            uint8_t c = buf[i];
            if (c == '\n' || c == '\r' || c == ' ' || c == '\t') continue;
            uint8_t x = (c >> 1) & 3;
            uint8_t code = x ^ ((x >> 1) & 1);
            uint8_t up = c & 0xDF;
            uint8_t ok = (up == 'A') | (up == 'C') | (up == 'G') | (up == 'T');
            bad += !ok;
            row[len >> 2] |= (uint8_t)((ok ? code : 0) << (2 * (len & 3)));
            ++len;
        }
        lengths[r] = (int32_t)len;
    }
    return bad;
}

}  // extern "C"
