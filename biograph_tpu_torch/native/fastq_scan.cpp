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
// The port's copy of biograph_tpu/native/fastq_scan.cpp, FASTQ half only:
// the BAM/BGZF scanners (the part that needs zlib) belong with io/bam.py,
// which is not ported yet, so this file links nothing beyond the C++
// runtime.

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
