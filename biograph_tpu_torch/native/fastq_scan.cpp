// Native FASTQ scanner: byte buffer -> padded 2-bit code matrix + lengths.
//
// Counterpart of the reference's C++ read importer hot loop
// (modules/build_seqset/read_importer.cpp, modules/bio_format/fastq.cpp):
// parsing and 2-bit encoding must keep up with the accelerator, so the
// per-byte work lives in C++ (exposed via ctypes, no pybind11 dependency).
//
// Layout contract (caller allocates):
//   codes  : uint8 [max_reads, max_len]   zero-padded 2-bit base codes
//   quals  : uint8 [max_reads, max_len]   phred+0 (raw - 33), optional
//   lengths: int32 [max_reads]
// Returns the number of reads parsed, or -1 on malformed input.
//
// The port's copy of biograph_tpu/native/fastq_scan.cpp: the FASTQ
// scanner, the BAM record scanner and the BGZF block scan.  The blocks are
// inflated by the caller (Python's zlib, which releases the GIL, over a
// thread pool), so this file links nothing beyond the C++ runtime and needs
// no zlib headers.

#include <cstdint>
#include <cstring>

namespace {

// A=0 C=1 G=2 T=3, everything else (incl. N) = 0 — matches
// modules/bio_base/kmer.h:69-88 kmer_bit_value.
struct BaseTable {
  uint8_t v[256];
  constexpr BaseTable() : v() {
    for (int i = 0; i < 256; i++) v[i] = 0;
    v['A'] = 0; v['a'] = 0;
    v['C'] = 1; v['c'] = 1;
    v['G'] = 2; v['g'] = 2;
    v['T'] = 3; v['t'] = 3;
  }
};
constexpr BaseTable kTable{};

inline const uint8_t* find_nl(const uint8_t* p, const uint8_t* end) {
  return static_cast<const uint8_t*>(
      memchr(p, '\n', static_cast<size_t>(end - p)));
}

}  // namespace

extern "C" {

// Parse FASTQ records from buf[0..n). Writes up to max_reads rows.
// Returns reads parsed; -1 if the stream is malformed.
long long fastq_scan(const uint8_t* buf, long long n, uint8_t* codes,
                     uint8_t* quals, int32_t* lengths, long long max_reads,
                     long long max_len, int with_quals) {
  const uint8_t* p = buf;
  const uint8_t* end = buf + n;
  long long r = 0;
  while (p < end && r < max_reads) {
    // skip blank lines between records
    while (p < end && (*p == '\n' || *p == '\r')) p++;
    if (p >= end) break;
    if (*p != '@') return -1;
    const uint8_t* nl = find_nl(p, end);
    if (!nl) return -1;
    p = nl + 1;  // sequence line
    nl = find_nl(p, end);
    if (!nl) return -1;
    const uint8_t* seq = p;
    long long slen = nl - p;
    if (slen > 0 && seq[slen - 1] == '\r') slen--;
    if (slen > max_len) return -1;
    uint8_t* crow = codes + r * max_len;
    for (long long i = 0; i < slen; i++) crow[i] = kTable.v[seq[i]];
    memset(crow + slen, 0, static_cast<size_t>(max_len - slen));
    lengths[r] = static_cast<int32_t>(slen);
    p = nl + 1;  // '+' line
    nl = find_nl(p, end);
    if (!nl) return -1;
    if (*p != '+') return -1;
    p = nl + 1;  // quality line (must cover the sequence)
    nl = find_nl(p, end);
    const uint8_t* qend = nl ? nl : end;
    long long qlen = qend - p;
    if (qlen > 0 && p[qlen - 1] == '\r') qlen--;
    if (qlen != slen) return -1;  // truncated / mismatched record
    if (with_quals) {
      uint8_t* qrow = quals + r * max_len;
      long long m = qlen < slen ? qlen : slen;
      for (long long i = 0; i < m; i++)
        qrow[i] = p[i] >= 33 ? static_cast<uint8_t>(p[i] - 33) : 0;
      memset(qrow + m, 0, static_cast<size_t>(max_len - m));
    }
    p = nl ? nl + 1 : end;
    r++;
  }
  return r;
}

// Scan once to report (num_reads, max_seq_len) so the caller can size
// buffers exactly. Returns 0 on success, -1 malformed.
int fastq_dims(const uint8_t* buf, long long n, long long* num_reads,
               long long* max_seq_len) {
  const uint8_t* p = buf;
  const uint8_t* end = buf + n;
  long long r = 0, maxlen = 0;
  while (p < end) {
    while (p < end && (*p == '\n' || *p == '\r')) p++;
    if (p >= end) break;
    if (*p != '@') return -1;
    const uint8_t* nl = find_nl(p, end);
    if (!nl) return -1;
    p = nl + 1;
    nl = find_nl(p, end);
    if (!nl) return -1;
    long long slen = nl - p;
    if (slen > 0 && p[slen - 1] == '\r') slen--;
    if (slen > maxlen) maxlen = slen;
    p = nl + 1;
    nl = find_nl(p, end);
    if (!nl || *p != '+') return -1;
    p = nl + 1;
    nl = find_nl(p, end);
    {
      const uint8_t* qend = nl ? nl : end;
      long long qlen = qend - p;
      if (qlen > 0 && p[qlen - 1] == '\r') qlen--;
      if (qlen != slen) return -1;  // truncated / mismatched record
    }
    p = nl ? nl + 1 : end;
    r++;
  }
  *num_reads = r;
  *max_seq_len = maxlen;
  return 0;
}

// 2-bit pack a code matrix into big-endian-ordered uint32 words
// (16 bases/word, first base in the top bits) — the device key layout.
void pack_codes_2bit(const uint8_t* codes, long long rows, long long len,
                     int32_t const* lengths, uint32_t* words,
                     long long words_per_row) {
  for (long long r = 0; r < rows; r++) {
    const uint8_t* crow = codes + r * len;
    long long L = lengths ? lengths[r] : len;
    uint32_t* wrow = words + r * words_per_row;
    for (long long w = 0; w < words_per_row; w++) {
      uint32_t acc = 0;
      long long base0 = w * 16;
      for (int i = 0; i < 16; i++) {
        long long b = base0 + i;
        uint32_t c = (b < L && b < len) ? (crow[b] & 3u) : 0u;
        acc = (acc << 2) | c;
      }
      wrow[w] = acc;
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// BAM record scanner over a decompressed (post-BGZF) alignment section.
//
// Counterpart of the reference's htslib-driven per-record loop
// (modules/build_seqset/read_importer.cpp bam path): emits 2-bit codes
// (reverse-strand reads restored to original orientation), phred qualities
// (a missing quality, 0xFF, becomes 0), lengths, flags and read-name
// offsets.
//
// Layout contract (caller allocates after calling bam_dims):
//   codes  : uint8 [max_reads, max_len]
//   quals  : uint8 [max_reads, max_len]
//   lengths: int32 [max_reads]
//   flags  : int32 [max_reads]
//   name_off: int64 [max_reads+1] offsets into name_buf
//   name_buf: uint8 [total_name_bytes]
// Skips secondary (0x100) and supplementary (0x800) records; keep_unmapped
// selects flag-0x4 handling.

namespace {
inline int32_t rd_i32(const uint8_t* p) {
  int32_t v;
  memcpy(&v, p, 4);
  return v;
}
constexpr uint8_t kNib2Code[16] = {0, 0, 1, 0, 2, 0, 0, 0, 3, 0, 0, 0, 0, 0, 0, 0};
}  // namespace

extern "C" {

// First pass: count kept records, max read length, total name bytes.
// buf points at the first alignment record (after header+refs).
int bam_dims(const uint8_t* buf, long long n, int keep_unmapped,
             long long* num_reads, long long* max_len,
             long long* name_bytes) {
  long long p = 0, r = 0, ml = 0, nb = 0;
  while (p + 4 <= n) {
    int32_t bs = rd_i32(buf + p);
    if (bs < 32 || p + 4 + bs > n) break;
    const uint8_t* rec = buf + p + 4;
    p += 4 + bs;
    uint8_t l_read_name = rec[8];
    uint16_t flag;
    memcpy(&flag, rec + 14, 2);
    int32_t l_seq = rd_i32(rec + 16);
    if ((flag & 0x100) || (flag & 0x800)) continue;
    if (!keep_unmapped && (flag & 0x4)) continue;
    r++;
    if (l_seq > ml) ml = l_seq;
    nb += l_read_name - 1;
  }
  *num_reads = r;
  *max_len = ml;
  *name_bytes = nb;
  return 0;
}

long long bam_scan(const uint8_t* buf, long long n, int keep_unmapped,
                   uint8_t* codes, uint8_t* quals, int32_t* lengths,
                   int32_t* flags_out, long long* name_off, uint8_t* name_buf,
                   long long max_reads, long long max_len) {
  long long p = 0, r = 0, nb = 0;
  name_off[0] = 0;
  while (p + 4 <= n && r < max_reads) {
    int32_t bs = rd_i32(buf + p);
    if (bs < 32 || p + 4 + bs > n) break;
    const uint8_t* rec = buf + p + 4;
    p += 4 + bs;
    uint8_t l_read_name = rec[8];
    uint16_t n_cigar;
    memcpy(&n_cigar, rec + 12, 2);
    uint16_t flag;
    memcpy(&flag, rec + 14, 2);
    int32_t l_seq = rd_i32(rec + 16);
    if ((flag & 0x100) || (flag & 0x800)) continue;
    if (!keep_unmapped && (flag & 0x4)) continue;
    const uint8_t* q = rec + 32;
    memcpy(name_buf + nb, q, l_read_name - 1);
    nb += l_read_name - 1;
    q += l_read_name + 4 * n_cigar;
    const uint8_t* seq_nib = q;
    const uint8_t* qual = q + (l_seq + 1) / 2;
    uint8_t* crow = codes + r * max_len;
    uint8_t* qrow = quals + r * max_len;
    if (flag & 0x10) {
      // reverse strand: restore original orientation (revcomp, reverse qual)
      for (int32_t i = 0; i < l_seq; i++) {
        uint8_t nib = (i & 1) ? (seq_nib[i >> 1] & 0xF) : (seq_nib[i >> 1] >> 4);
        crow[l_seq - 1 - i] = 3 - kNib2Code[nib];
        qrow[l_seq - 1 - i] = qual[i] == 0xFF ? 0 : qual[i];
      }
    } else {
      for (int32_t i = 0; i < l_seq; i++) {
        uint8_t nib = (i & 1) ? (seq_nib[i >> 1] & 0xF) : (seq_nib[i >> 1] >> 4);
        crow[i] = kNib2Code[nib];
        qrow[i] = qual[i] == 0xFF ? 0 : qual[i];
      }
    }
    memset(crow + l_seq, 0, (size_t)(max_len - l_seq));
    memset(qrow + l_seq, 0, (size_t)(max_len - l_seq));
    lengths[r] = l_seq;
    flags_out[r] = flag;
    r++;
    name_off[r] = nb;
  }
  return r;
}

// ---------------------------------------------------------------------------
// BGZF (blocked gzip, the BAM container layer): the block scan.  Every BGZF
// member carries its compressed size in the 'BC' extra subfield and its
// uncompressed size in ISIZE, so the blocks inflate independently (the
// reference leans on htslib's multi-threaded bgzf reader, hts_set_threads).
//
// Writes per-block compressed offset/size and uncompressed size.  Returns
// the block count; -1 if a member is not BGZF (no BC subfield), which the
// caller reads with the serial streaming walk.
long long bgzf_scan(const uint8_t* buf, long long n, long long* c_off,
                    int32_t* c_size, int32_t* u_size, long long max_blocks) {
  long long p = 0, k = 0;
  while (p + 18 <= n && k < max_blocks) {
    if (buf[p] != 0x1f || buf[p + 1] != 0x8b) break;
    if (buf[p + 2] != 8 || !(buf[p + 3] & 4)) return -1;  // no FEXTRA
    uint16_t xlen;
    memcpy(&xlen, buf + p + 10, 2);
    long long xend = p + 12 + xlen;
    if (xend > n) return -1;
    long long q = p + 12;
    long long bsize = -1;
    while (q + 4 <= xend) {
      uint8_t si1 = buf[q], si2 = buf[q + 1];
      uint16_t slen;
      memcpy(&slen, buf + q + 2, 2);
      if (si1 == 'B' && si2 == 'C' && slen == 2) {
        uint16_t bs16;
        memcpy(&bs16, buf + q + 4, 2);
        bsize = (long long)bs16 + 1;
        break;
      }
      q += 4 + slen;
    }
    if (bsize < 0 || p + bsize > n) return -1;
    uint32_t isize;
    memcpy(&isize, buf + p + bsize - 4, 4);
    c_off[k] = p;
    c_size[k] = (int32_t)bsize;
    u_size[k] = (int32_t)isize;
    k++;
    p += bsize;
  }
  return k;
}

}  // extern "C"
