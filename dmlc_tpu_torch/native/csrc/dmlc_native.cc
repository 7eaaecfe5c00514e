// The port's host native core: allocation-free text parsing (optionally
// multi-threaded), the RecordIO chunk scan with inline CRC32C, and the
// feed's packs, behind a plain C ABI loaded with ctypes.
//
// This is the JAX package's native core (dmlc_tpu/cpp/dmlc_native.cc,
// ABI 6) copied function for function, so both packages parse, scan and
// pack bit for bit alike: strtonum-style number parsing, the
// LibSVM/CSV/LibFM line scans with the parallel chunk fan-out at line
// boundaries (std::thread), the RecordIO magic/cflag chunk walk, and the
// span packs.  Only CRC-32C lives elsewhere: crc32c.cc, linked into the
// same library, provides dmlc_crc32c (the same values, with an SSE4.2
// route where the CPU has one).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC crc32c.cc dmlc_native.cc -pthread
// (dmlc_tpu_torch/native/__init__.py does this at first use).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline const char* skip_blank(const char* p, const char* end) {
  while (p != end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

// Fast float parse: sign, integer, fraction, exponent.  Digit-by-digit in
// double, matching strtof semantics closely enough for ML feature data.
inline const char* parse_float(const char* p, const char* end, double* out) {
  p = skip_blank(p, end);
  if (p == end) return nullptr;
  bool neg = false;
  if (*p == '+' || *p == '-') { neg = (*p == '-'); ++p; }
  double v = 0.0;
  bool any = false;
  while (p != end && *p >= '0' && *p <= '9') {
    v = v * 10.0 + (*p - '0'); ++p; any = true;
  }
  if (p != end && *p == '.') {
    ++p;
    double scale = 0.1;
    while (p != end && *p >= '0' && *p <= '9') {
      v += (*p - '0') * scale; scale *= 0.1; ++p; any = true;
    }
  }
  if (!any) return nullptr;
  if (p != end && (*p == 'e' || *p == 'E')) {
    ++p;
    bool eneg = false;
    if (p != end && (*p == '+' || *p == '-')) { eneg = (*p == '-'); ++p; }
    int ev = 0; bool eany = false;
    while (p != end && *p >= '0' && *p <= '9') {
      ev = ev * 10 + (*p - '0'); ++p; eany = true;
    }
    if (!eany) return nullptr;
    double pw = 1.0, base = eneg ? 0.1 : 10.0;
    for (int i = 0; i < ev; ++i) pw *= base;
    v *= pw;
  }
  *out = neg ? -v : v;
  return p;
}

inline const char* parse_uint(const char* p, const char* end, uint64_t* out) {
  p = skip_blank(p, end);
  uint64_t v = 0; bool any = false;
  while (p != end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0'); ++p; any = true;
  }
  if (!any) return nullptr;
  *out = v;
  return p;
}

// Per-thread sparse-parse accumulator (libsvm/libfm share it; libfm also
// fills fields).
struct SparseRows {
  std::vector<float> labels, weights, value;
  std::vector<uint64_t> rowlen;  // nnz per row (rebased to offsets on merge)
  std::vector<uint32_t> fields, index;
  int has_weight = 0;
  int rc = 0;  // 0 ok, -2 malformed
};

// Parse [p, end) as libsvm (with_fields=false) or libfm (true) rows into
// out.  The range must start/end at line boundaries.
void parse_sparse_range(const char* p, const char* end, bool with_fields,
                        SparseRows* out) {
  while (p != end) {
    const char* line_end = static_cast<const char*>(memchr(p, '\n', end - p));
    if (line_end == nullptr) line_end = end;
    const char* q = skip_blank(p, line_end);
    if (q != line_end) {
      double label;
      q = parse_float(q, line_end, &label);
      if (q == nullptr) { out->rc = -2; return; }
      double weight = 1.0;
      if (q != line_end && *q == ':') {
        q = parse_float(q + 1, line_end, &weight);
        if (q == nullptr) { out->rc = -2; return; }
        out->has_weight = 1;
      }
      out->labels.push_back(static_cast<float>(label));
      out->weights.push_back(static_cast<float>(weight));
      uint64_t nnz = 0;
      while (true) {
        q = skip_blank(q, line_end);
        if (q == line_end) break;
        uint64_t a;
        q = parse_uint(q, line_end, &a);
        if (q == nullptr) { out->rc = -2; return; }
        if (with_fields) {
          // strict field:idx:val triple (libfm_parser.h ParseTriple behavior)
          uint64_t idx; double val;
          if (q == line_end || *q != ':') { out->rc = -2; return; }
          q = parse_uint(q + 1, line_end, &idx);
          if (q == nullptr || q == line_end || *q != ':') { out->rc = -2; return; }
          q = parse_float(q + 1, line_end, &val);
          if (q == nullptr) { out->rc = -2; return; }
          out->fields.push_back(static_cast<uint32_t>(a));
          out->index.push_back(static_cast<uint32_t>(idx));
          out->value.push_back(static_cast<float>(val));
        } else {
          double val = 1.0;  // omitted value => implicit 1.0
          if (q != line_end && *q == ':') {
            q = parse_float(q + 1, line_end, &val);
            if (q == nullptr) { out->rc = -2; return; }
          }
          out->index.push_back(static_cast<uint32_t>(a));
          out->value.push_back(static_cast<float>(val));
        }
        ++nnz;
      }
      out->rowlen.push_back(nnz);
    }
    p = (line_end == end) ? end : line_end + 1;
  }
}

// Split [buf, buf+n) into up to nthread ranges at line boundaries, the
// text_parser.h:89-118 backward re-alignment: range k starts at the byte
// after the last '\n' strictly before the naive split point.
std::vector<std::pair<const char*, const char*>> line_ranges(
    const char* buf, long n, int nthread) {
  std::vector<std::pair<const char*, const char*>> out;
  if (nthread < 1) nthread = 1;
  long step = (n + nthread - 1) / nthread;
  long begin = 0;
  for (int k = 0; k < nthread && begin < n; ++k) {
    long end = (k + 1 == nthread) ? n : (k + 1) * step;
    if (end > n) end = n;
    if (end < n) {
      // advance end to the next line boundary so ranges cover whole lines
      const void* nl = memchr(buf + end, '\n', n - end);
      end = (nl == nullptr) ? n
                            : (static_cast<const char*>(nl) - buf) + 1;
    }
    if (end > begin) out.emplace_back(buf + begin, buf + end);
    begin = end;
  }
  return out;
}

long merge_sparse(const std::vector<SparseRows>& parts, bool with_fields,
                  float* labels, float* weights, uint64_t* offsets,
                  uint32_t* fields, uint32_t* index, float* value,
                  long max_rows, long max_nnz,
                  long* n_rows, long* n_nnz, int* has_weight) {
  long rows = 0, nnz = 0;
  int hw = 0;
  for (const auto& p : parts) {
    if (p.rc != 0) return p.rc;
    rows += static_cast<long>(p.rowlen.size());
    nnz += static_cast<long>(p.index.size());
    hw |= p.has_weight;
  }
  if (rows > max_rows || nnz > max_nnz) return -1;
  long r = 0, z = 0;
  offsets[0] = 0;
  for (const auto& p : parts) {
    std::memcpy(labels + r, p.labels.data(), p.labels.size() * 4);
    std::memcpy(weights + r, p.weights.data(), p.weights.size() * 4);
    std::memcpy(index + z, p.index.data(), p.index.size() * 4);
    std::memcpy(value + z, p.value.data(), p.value.size() * 4);
    if (with_fields)
      std::memcpy(fields + z, p.fields.data(), p.fields.size() * 4);
    for (size_t i = 0; i < p.rowlen.size(); ++i) {
      z += static_cast<long>(p.rowlen[i]);
      offsets[++r] = static_cast<uint64_t>(z);
    }
  }
  *n_rows = rows;
  *n_nnz = nnz;
  *has_weight = hw;
  return 0;
}

long parse_sparse_mt(const char* buf, long n, bool with_fields, int nthread,
                     float* labels, float* weights, uint64_t* offsets,
                     uint32_t* fields, uint32_t* index, float* value,
                     long max_rows, long max_nnz,
                     long* n_rows, long* n_nnz, int* has_weight) {
  auto ranges = line_ranges(buf, n, nthread);
  std::vector<SparseRows> parts(ranges.size());
  if (ranges.size() <= 1) {
    if (!ranges.empty())
      parse_sparse_range(ranges[0].first, ranges[0].second, with_fields,
                         &parts[0]);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(ranges.size());
    for (size_t k = 0; k < ranges.size(); ++k)
      threads.emplace_back(parse_sparse_range, ranges[k].first,
                           ranges[k].second, with_fields, &parts[k]);
    for (auto& t : threads) t.join();
  }
  return merge_sparse(parts, with_fields, labels, weights, offsets, fields,
                      index, value, max_rows, max_nnz, n_rows, n_nnz,
                      has_weight);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------
// LibSVM: "label[:weight] idx[:val] ..." per line.  Fills labels/weights
// [max_rows], offsets [max_rows+1], index/value [max_nnz].
// Returns 0 ok, -1 capacity exceeded, -2 malformed input.
// *has_weight set if any label carried ":weight".  nthread > 1 fans the
// chunk out over std::threads at line boundaries.
long dmlc_parse_libsvm(const char* buf, long n,
                       float* labels, float* weights, uint64_t* offsets,
                       uint32_t* index, float* value,
                       long max_rows, long max_nnz, int nthread,
                       long* n_rows, long* n_nnz, int* has_weight) {
  return parse_sparse_mt(buf, n, false, nthread, labels, weights, offsets,
                         nullptr, index, value, max_rows, max_nnz, n_rows,
                         n_nnz, has_weight);
}

// ---------------------------------------------------------------------
// LibFM: "label[:weight] field:idx:val ..." per line; adds fields[max_nnz].
long dmlc_parse_libfm(const char* buf, long n,
                      float* labels, float* weights, uint64_t* offsets,
                      uint32_t* fields, uint32_t* index, float* value,
                      long max_rows, long max_nnz, int nthread,
                      long* n_rows, long* n_nnz, int* has_weight) {
  return parse_sparse_mt(buf, n, true, nthread, labels, weights, offsets,
                         fields, index, value, max_rows, max_nnz, n_rows,
                         n_nnz, has_weight);
}

// ---------------------------------------------------------------------
// CSV (numeric): fills values row-major; all rows must share the first
// row's column count.  Returns 0 ok, -1 capacity, -2 non-numeric,
// -3 ragged rows.  nthread > 1 parses line ranges concurrently (two-pass:
// count then fill, so output stays row-major with no post-merge copy).
namespace {
struct CsvPart {
  std::vector<float> vals;
  long ncol = -1;
  int rc = 0;
};
void parse_csv_range(const char* p, const char* end, char delim,
                     CsvPart* out) {
  while (p != end) {
    const char* line_end = static_cast<const char*>(memchr(p, '\n', end - p));
    if (line_end == nullptr) line_end = end;
    const char* q = skip_blank(p, line_end);
    if (q != line_end) {
      long row_vals = 0;
      while (true) {
        double v;
        q = parse_float(q, line_end, &v);
        if (q == nullptr) { out->rc = -2; return; }
        out->vals.push_back(static_cast<float>(v));
        ++row_vals;
        q = skip_blank(q, line_end);
        if (q == line_end) break;
        if (*q != delim) { out->rc = -2; return; }
        ++q;
      }
      if (out->ncol < 0) out->ncol = row_vals;
      else if (row_vals != out->ncol) { out->rc = -3; return; }
    }
    p = (line_end == end) ? end : line_end + 1;
  }
}
}  // namespace

long dmlc_parse_csv(const char* buf, long n, char delim, int nthread,
                    float* out, long max_vals,
                    long* n_rows, long* n_cols) {
  auto ranges = line_ranges(buf, n, nthread);
  std::vector<CsvPart> parts(ranges.size());
  if (ranges.size() <= 1) {
    if (!ranges.empty())
      parse_csv_range(ranges[0].first, ranges[0].second, delim, &parts[0]);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(ranges.size());
    for (size_t k = 0; k < ranges.size(); ++k)
      threads.emplace_back(parse_csv_range, ranges[k].first,
                           ranges[k].second, delim, &parts[k]);
    for (auto& t : threads) t.join();
  }
  long ncol = -1, vals = 0;
  for (const auto& p : parts) {
    if (p.rc != 0) return p.rc;
    if (p.ncol >= 0) {
      if (ncol < 0) ncol = p.ncol;
      else if (p.ncol != ncol) return -3;
    }
    vals += static_cast<long>(p.vals.size());
  }
  if (vals > max_vals) return -1;
  long at = 0;
  for (const auto& p : parts) {
    std::memcpy(out + at, p.vals.data(), p.vals.size() * 4);
    at += static_cast<long>(p.vals.size());
  }
  *n_rows = (ncol > 0) ? vals / ncol : 0;
  *n_cols = (ncol < 0) ? 0 : ncol;
  return 0;
}

// ---------------------------------------------------------------------
// RecordIO chunk scan (format: recordio.h:16-45, plus the CRC32C record
// variant: cflag|4 with a crc word between lrec and payload).  Walks a
// 4-aligned chunk of [magic|lrec[|crc]|payload|pad4] cells; emits one
// (offset, len, flag) triple per *logical* record:
//   flag 0 => plain payload at offset, len bytes, zero-copy
//   flag 1 => plain multi-segment region [offset, offset+len) incl.
//             headers (Python reassembles)
//   flag 2 => checksummed payload at offset (its crc word sits at
//             offset-4), len bytes, zero-copy after verification
//   flag 3 => checksummed multi-segment region incl. headers
// Even flags are direct payload spans, odd flags need reassembly.
// Returns 0 ok, -1 capacity, -2 malformed.
long dmlc_recordio_spans(const uint8_t* buf, long n, uint32_t magic,
                         uint64_t* out, long max_spans, long* n_spans) {
  long count = 0;
  long pos = 0;
  while (pos + 8 <= n) {
    uint32_t m, lrec;
    memcpy(&m, buf + pos, 4);
    if (m != magic) return -2;
    memcpy(&lrec, buf + pos + 4, 4);
    uint32_t cflag = lrec >> 29u;
    uint32_t len = lrec & ((1u << 29u) - 1u);
    int ck = cflag >= 4u;              // checksummed variant
    long payload = pos + 8 + (ck ? 4 : 0);
    long next = payload + ((len + 3u) & ~3u);
    if (next > n || payload > n) return -2;
    if (cflag == 0 || cflag == 4) {
      if (count >= max_spans) return -1;
      out[3 * count] = static_cast<uint64_t>(payload);
      out[3 * count + 1] = len;
      out[3 * count + 2] = ck ? 2 : 0;
      ++count;
      pos = next;
    } else if (cflag == 1 || cflag == 5) {
      long start = pos;
      pos = next;
      // walk continuation cells (cflag 2 / 6) to the end cell (3 / 7)
      while (true) {
        if (pos + 8 > n) return -2;
        memcpy(&m, buf + pos, 4);
        if (m != magic) return -2;
        memcpy(&lrec, buf + pos + 4, 4);
        uint32_t cf = lrec >> 29u;
        uint32_t l2 = lrec & ((1u << 29u) - 1u);
        if (ck && pos + 12 > n) return -2;
        pos += 8 + (ck ? 4 : 0) + ((l2 + 3u) & ~3u);
        if (pos > n) return -2;
        if (cf == (ck ? 7u : 3u)) break;
        if (cf != (ck ? 6u : 2u)) return -2;
      }
      if (count >= max_spans) return -1;
      out[3 * count] = static_cast<uint64_t>(start);
      out[3 * count + 1] = static_cast<uint64_t>(pos - start);
      out[3 * count + 2] = ck ? 3 : 1;
      ++count;
    } else {
      return -2;  // chunk must start at a record head
    }
  }
  *n_spans = count;
  return (pos == n) ? 0 : -2;
}

// Backward scan for the last record head (magic at 4-aligned offset with
// a head cflag: 0/1 plain, 4/5 checksummed) — recordio_split.cc:26-42.
long dmlc_recordio_find_last(const uint8_t* buf, long n, uint32_t magic) {
  if (n < 8) return 0;
  for (long idx = ((n - 8) / 4) * 4; idx > 0; idx -= 4) {
    uint32_t m;
    memcpy(&m, buf + idx, 4);
    if (m == magic) {
      uint32_t lrec;
      memcpy(&lrec, buf + idx + 4, 4);
      uint32_t cf = lrec >> 29u;
      if (cf == 0 || cf == 1 || cf == 4 || cf == 5) return idx;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------
// CRC-32C (Castagnoli) of buf[0:n) chained from init: crc32c.cc.
uint32_t dmlc_crc32c(const uint8_t* buf, long n, uint32_t init);

// Shuffled-batch span gather (indexed_recordio_split.cc:158-211 role):
// copy n record spans from one mapped file into a packed output buffer.
// The copy VISITS spans in ascending source offset (order[] is the
// argsort of offs — sequential page touch restores readahead/cache
// locality that a shuffled walk destroys) while WRITING each span at
// dst_off[j], its position in the shuffled batch — so the output keeps
// the kRandMagic permutation order byte-for-byte.  Returns bytes copied
// or -1 on bounds violation (src_len guards a corrupt index).
long dmlc_gather_spans(const char* src, long src_len, char* dst,
                       const int64_t* offs, const int64_t* lens,
                       const int64_t* dst_off, const int64_t* order,
                       long n) {
  long total = 0;
  for (long i = 0; i < n; ++i) {
    const long j = order != nullptr ? static_cast<long>(order[i]) : i;
    const int64_t off = offs[j], len = lens[j];
    // overflow-free bounds check: off+len could wrap for a hostile index
    if (off < 0 || len < 0 || off > src_len || len > src_len - off)
      return -1;
    memcpy(dst + dst_off[j], src + off, static_cast<size_t>(len));
    total += len;
  }
  return total;
}

// Packed-batch assembly (recordio_packed_feed role): append record
// spans of src WHOLE into the static batch buffer dst, starting at
// dst_pos, until the batch is full — out of byte capacity or record
// slots.  ends[i] receives the i-th packed record's END offset in dst.
// A record that would overflow dst_cap ends the batch un-consumed,
// EXCEPT when the batch is empty (allow_truncate): then it is packed
// truncated to dst_cap so one oversized record cannot wedge the feed.
// Returns the number of spans consumed (*out_pos = new fill position,
// *out_full = 1 when the caller should emit), or -1 on a span that
// walks outside src (corrupt chunk index).
long dmlc_pack_spans(const char* src, long src_len, char* dst, long dst_cap,
                     long dst_pos, const int64_t* offs, const int64_t* lens,
                     long n, long slots, int allow_truncate, int64_t* ends,
                     long* out_pos, int* out_full) {
  long i = 0, pos = dst_pos;
  int full = 0;
  for (; i < n; ++i) {
    if (i >= slots) {
      full = 1;
      break;
    }
    const int64_t off = offs[i], len = lens[i];
    if (off < 0 || len < 0 || off > src_len || len > src_len - off)
      return -1;
    if (pos + len > dst_cap) {
      if (i == 0 && allow_truncate) {
        memcpy(dst + pos, src + off, static_cast<size_t>(dst_cap - pos));
        ends[i] = dst_cap;
        pos = dst_cap;
        ++i;
      }
      full = 1;
      break;
    }
    memcpy(dst + pos, src + off, static_cast<size_t>(len));
    pos += len;
    ends[i] = pos;
  }
  if (pos >= dst_cap) full = 1;
  *out_pos = pos;
  *out_full = full;
  return i;
}

// ---------------------------------------------------------------------
// Fused single-pass scan + verify (ABI 6).
//
// dmlc_recordio_spans_verify walks a chunk ONCE, CRC32C-verifying
// checksummed segments inline (verify != 0), and instead of failing the
// whole chunk on corruption it emits TYPED REJECT triples and resyncs
// to the next record head — the Python side routes rejects through the
// DMLC_INTEGRITY_POLICY machinery (raise / skip / quarantine) with no
// second pass over the bytes.  Good triples keep the flag 0-3 contract
// of dmlc_recordio_spans; reject triples use flag >= 8:
//
//   8  bad magic at a record head position
//   9  truncated payload (record extends past the chunk)
//   10 torn multi-segment record (continuation header gone)
//   11 missing end segment (continuation cflag wrong)
//   12 non-head cflag at a record head position
//   13 crc32c mismatch (span = [head, payload end))
//   14 torn tail: sub-word remainder no header fits in (suppressed
//      when the chunk already reported — the other report covers it)
//
// A reject's (offset, len) covers [begin, resync point) so Python can
// key the quarantine skip-list without re-walking.  The walk and the
// resync are EXACTLY the plain version's (scan_chunk_plain in
// feed/spans.py) — the differential test suite holds the two to
// byte-identical triple tables so the walkers can never drift.

namespace {

// find_next_record_head (io/recordio.py): first 4-aligned offset in
// [begin, end) holding the magic followed by a head-cflag lrec.
inline long find_head(const uint8_t* buf, long begin, long end,
                      uint32_t magic) {
  for (long idx = begin; idx + 8 <= end; idx += 4) {
    uint32_t m;
    memcpy(&m, buf + idx, 4);
    if (m != magic) continue;
    uint32_t lrec;
    memcpy(&lrec, buf + idx + 4, 4);
    uint32_t cf = lrec >> 29u;
    if (cf == 0 || cf == 1 || cf == 4 || cf == 5) return idx;
  }
  return end;
}

// resync target after corruption at pos: next aligned word, then the
// next record head within the whole-word prefix of the chunk.
inline long resync_from(const uint8_t* buf, long n, long pos,
                        uint32_t magic) {
  long nxt = pos + 4 < n ? pos + 4 : n;
  nxt += (4 - (nxt & 3)) & 3;
  long end = n - (n & 3);
  return nxt < end ? find_head(buf, nxt, end, magic) : end;
}

// stored_crc (io/recordio.py): a crc equal to the magic is written
// flipped in its low bit so no stored cell scans as a record head.
inline uint32_t stored_crc32(uint32_t c, uint32_t magic) {
  return c == magic ? c ^ 1u : c;
}

// CRC-verify every segment of one structurally-validated checksummed
// region [off, off+len) — the old _verify_region, fused into the scan.
inline bool region_crc_ok(const uint8_t* buf, long off, long len,
                          uint32_t magic) {
  long pos = off, end = off + len;
  while (pos + 12 <= end) {
    uint32_t lrec, want;
    memcpy(&lrec, buf + pos + 4, 4);
    memcpy(&want, buf + pos + 8, 4);
    uint32_t n = lrec & ((1u << 29u) - 1u);
    if (stored_crc32(dmlc_crc32c(buf + pos + 12, n, 0), magic) != want)
      return false;
    pos += 12 + ((n + 3u) & ~3u);
  }
  return true;
}

}  // namespace

long dmlc_recordio_spans_verify(const uint8_t* buf, long n, uint32_t magic,
                                int verify, uint64_t* out, long max_spans,
                                long* n_spans) {
  long count = 0;
  long pos = 0;
  int any_reject = 0;
#define EMIT(o, l, f)                      \
  do {                                     \
    if (count >= max_spans) return -1;     \
    out[3 * count] = (uint64_t)(o);        \
    out[3 * count + 1] = (uint64_t)(l);    \
    out[3 * count + 2] = (uint64_t)(f);    \
    ++count;                               \
  } while (0)
#define REJECT(o, l, f)                    \
  do {                                     \
    EMIT(o, l, f);                         \
    any_reject = 1;                        \
  } while (0)
  while (pos + 8 <= n) {
    uint32_t m, lrec;
    memcpy(&m, buf + pos, 4);
    if (m != magic) {
      long r = resync_from(buf, n, pos, magic);
      REJECT(pos, r - pos, 8);
      pos = r;
      continue;
    }
    memcpy(&lrec, buf + pos + 4, 4);
    uint32_t cflag = lrec >> 29u;
    uint32_t len = lrec & ((1u << 29u) - 1u);
    int ck = cflag >= 4u;
    long hdr = ck ? 12 : 8;
    if ((cflag & 3u) == 0u && (cflag == 0u || cflag == 4u)) {
      long nxt = pos + hdr + ((len + 3u) & ~3u);
      if (nxt > n) {
        long r = resync_from(buf, n, pos, magic);
        REJECT(pos, r - pos, 9);
        pos = r;
        continue;
      }
      if (ck && verify) {
        uint32_t want;
        memcpy(&want, buf + pos + 8, 4);
        if (stored_crc32(dmlc_crc32c(buf + pos + hdr, len, 0), magic)
            != want) {
          // span = [head, payload end): the quarantine key contract
          REJECT(pos, (pos + hdr + len) - pos, 13);
          pos = nxt;
          continue;
        }
      }
      EMIT(pos + hdr, len, ck ? 2 : 0);
      pos = nxt;
    } else if ((cflag & 3u) == 1u && (cflag == 1u || cflag == 5u)) {
      long start = pos;
      long p = pos + hdr + ((len + 3u) & ~3u);
      int kind = 0;  // 0 = structurally sound
      while (true) {
        if (p + hdr > n) {
          kind = 10;
          break;
        }
        memcpy(&m, buf + p, 4);
        if (m != magic) {
          kind = 10;
          break;
        }
        memcpy(&lrec, buf + p + 4, 4);
        uint32_t cf = lrec >> 29u;
        uint32_t l2 = lrec & ((1u << 29u) - 1u);
        if (((cf & 3u) != 2u && (cf & 3u) != 3u) || ((cf >= 4u) != ck)) {
          kind = 11;
          break;
        }
        p += hdr + ((l2 + 3u) & ~3u);
        if (p > n) {
          kind = 9;
          break;
        }
        if ((cf & 3u) == 3u) break;
      }
      if (kind != 0) {
        long r = resync_from(buf, n, start, magic);
        REJECT(start, r - start, kind);
        pos = r;
        continue;
      }
      if (ck && verify && !region_crc_ok(buf, start, p - start, magic)) {
        REJECT(start, p - start, 13);
      } else {
        EMIT(start, p - start, ck ? 3 : 1);
      }
      pos = p;
    } else {
      long r = resync_from(buf, n, pos, magic);
      REJECT(pos, r - pos, 12);
      pos = r;
    }
  }
  if (pos < n && !any_reject) EMIT(pos, n - pos, 14);
#undef EMIT
#undef REJECT
  *n_spans = count;
  return 0;
}

// ---------------------------------------------------------------------
// Pad-pack: span records of one chunk → padded [g, max_bytes] rows,
// written straight into the caller-provided batch slice (the staging
// BufferPool hand-off).  Replaces the Python-side broadcast gather
// (feed/spans.py gather_rows_into_plain), whose [g, max_bytes] int
// index array cost 4-8 bytes of traffic per padded byte.  Handles both
// direct-payload spans (flags 0/2: memcpy + zero tail) and the rare
// escaped-magic regions (flags 1/3: segment reassembly with magic
// re-insertion, truncated at max_bytes).  Returns 0, or -1 when a span
// walks outside the chunk (corrupt span table).
long dmlc_pad_pack_rows(const uint8_t* src, long src_len,
                        const uint64_t* spans, long n_rows, uint32_t magic,
                        long max_bytes, uint8_t* out_rows,
                        int32_t* out_lens) {
  for (long i = 0; i < n_rows; ++i) {
    long off = (long)spans[3 * i];
    long len = (long)spans[3 * i + 1];
    long flag = (long)spans[3 * i + 2];
    uint8_t* row = out_rows + i * max_bytes;
    if (off < 0 || len < 0 || off > src_len || len > src_len - off)
      return -1;
    if ((flag & 1) == 0) {
      long m = len < max_bytes ? len : max_bytes;
      memcpy(row, src + off, (size_t)m);
      if (m < max_bytes) memset(row + m, 0, (size_t)(max_bytes - m));
      out_lens[i] = (int32_t)m;
    } else {
      // multi-segment region: [magic|lrec[|crc]|payload|pad]* with the
      // elided magic re-inserted between segments
      long hdr = flag == 3 ? 12 : 8;
      long pos = off, end = off + len, at = 0;
      int first = 1;
      while (pos + hdr <= end && at < max_bytes) {
        uint32_t lrec;
        memcpy(&lrec, src + pos + 4, 4);
        long sl = (long)(lrec & ((1u << 29u) - 1u));
        if (pos + hdr + sl > end) return -1;
        if (!first) {
          long m = 4 < max_bytes - at ? 4 : max_bytes - at;
          memcpy(row + at, &magic, (size_t)m);
          at += m;
        }
        if (at < max_bytes) {
          long m = sl < max_bytes - at ? sl : max_bytes - at;
          memcpy(row + at, src + pos + hdr, (size_t)m);
          at += m;
        }
        first = 0;
        uint32_t cf = lrec >> 29u;
        pos += hdr + ((sl + 3u) & ~3u);
        if ((cf & 3u) == 0u || (cf & 3u) == 3u) break;
      }
      if (at < max_bytes) memset(row + at, 0, (size_t)(max_bytes - at));
      out_lens[i] = (int32_t)at;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------
// CSR → padded batch (feed/device_feed.py pack_rowblock, native): rows
// [0, b) of a CSR block written as {label [B], value [B,K], index
// [B,K], mask [B,K]} with per-row truncation at K, zero padding, and
// the num_col upper clamp — bit-identical to the numpy path (incl. its
// clamped-read behavior when offsets run past the value array).
long dmlc_pad_pack_csr(const float* labels, const uint64_t* offsets,
                       const uint32_t* index, const float* value,
                       long nnz_size, long b, long batch_size, long max_nnz,
                       long num_col, float* out_label, float* out_value,
                       int32_t* out_index, float* out_mask) {
  for (long i = 0; i < b; ++i) out_label[i] = labels[i];
  for (long i = b; i < batch_size; ++i) out_label[i] = 0.0f;
  long cells = batch_size * max_nnz;
  if (b == 0 || nnz_size == 0) {
    memset(out_value, 0, (size_t)cells * 4);
    memset(out_index, 0, (size_t)cells * 4);
    memset(out_mask, 0, (size_t)cells * 4);
    return 0;
  }
  for (long i = 0; i < b; ++i) {
    long off = (long)offsets[i];
    long rl = (long)(offsets[i + 1] - offsets[i]);
    // non-monotone (corrupt) offsets wrap the uint64 subtraction; the
    // numpy twin zero-fills such rows, and a negative m would start
    // the zero-fill loop out of bounds
    if (rl < 0) rl = 0;
    long m = rl < max_nnz ? rl : max_nnz;
    float* v = out_value + i * max_nnz;
    int32_t* x = out_index + i * max_nnz;
    float* mk = out_mask + i * max_nnz;
    for (long j = 0; j < m; ++j) {
      // numpy parity: reads are clamped to the last element (the mask
      // keeps them from mattering on well-formed CSR)
      long s = off + j < nnz_size ? off + j : nnz_size - 1;
      v[j] = value[s];
      x[j] = (int32_t)index[s];
      mk[j] = 1.0f;
    }
    for (long j = m; j < max_nnz; ++j) {
      v[j] = 0.0f;
      x[j] = 0;
      mk[j] = 0.0f;
    }
  }
  long pad = (batch_size - b) * max_nnz;
  if (pad > 0) {
    memset(out_value + b * max_nnz, 0, (size_t)pad * 4);
    memset(out_index + b * max_nnz, 0, (size_t)pad * 4);
    memset(out_mask + b * max_nnz, 0, (size_t)pad * 4);
  }
  if (num_col > 0) {
    int32_t cap = (int32_t)(num_col - 1);
    for (long i = 0; i < cells; ++i)
      if (out_index[i] > cap) out_index[i] = cap;
  }
  return 0;
}

// ---------------------------------------------------------------------
// LibSVM text → padded batch, fused (tokenize + pad-pack in ONE pass,
// no intermediate CSR): parses lines from buf[start:n] and writes each
// row straight into the caller's padded arrays at [*rows_out,
// batch_rows), zero-filling row tails, truncating (but still
// consuming) features past max_nnz, clamping indices to num_col-1 when
// num_col > 0.  Stops at batch_rows rows or end of input;
// *consumed_out is the offset of the first unparsed byte (a line
// boundary), so the caller re-enters after emitting the batch.  The
// feed runs one call per (chunk window, batch) with the GIL released,
// so DMLC_FEED_WORKERS partition threads genuinely overlap.
// Returns 0 ok, -2 malformed input.
long dmlc_parse_libsvm_into(const char* buf, long n, long start,
                            long row_base, long batch_rows, long max_nnz,
                            long num_col, float* out_label, float* out_value,
                            int32_t* out_index, float* out_mask,
                            long* rows_out, long* consumed_out) {
  const char* p = buf + start;
  const char* end = buf + n;
  long r = row_base;
  *rows_out = r;
  *consumed_out = start;
  while (p != end && r < batch_rows) {
    const char* line_end = static_cast<const char*>(memchr(p, '\n',
                                                           end - p));
    if (line_end == nullptr) line_end = end;
    const char* q = skip_blank(p, line_end);
    if (q != line_end) {
      double label;
      q = parse_float(q, line_end, &label);
      if (q == nullptr) return -2;
      if (q != line_end && *q == ':') {  // weight: consumed, not packed
        double w;
        q = parse_float(q + 1, line_end, &w);
        if (q == nullptr) return -2;
      }
      out_label[r] = (float)label;
      float* v = out_value + r * max_nnz;
      int32_t* x = out_index + r * max_nnz;
      float* mk = out_mask + r * max_nnz;
      long nnz = 0;
      while (true) {
        q = skip_blank(q, line_end);
        if (q == line_end) break;
        uint64_t a;
        q = parse_uint(q, line_end, &a);
        if (q == nullptr) return -2;
        double val = 1.0;  // omitted value => implicit 1.0
        if (q != line_end && *q == ':') {
          q = parse_float(q + 1, line_end, &val);
          if (q == nullptr) return -2;
        }
        if (nnz < max_nnz) {
          int32_t xi = (int32_t)(uint32_t)a;
          if (num_col > 0 && xi > (int32_t)(num_col - 1))
            xi = (int32_t)(num_col - 1);
          v[nnz] = (float)val;
          x[nnz] = xi;
          mk[nnz] = 1.0f;
        }
        ++nnz;  // features past max_nnz are consumed but not packed
      }
      for (long j = nnz < max_nnz ? nnz : max_nnz; j < max_nnz; ++j) {
        v[j] = 0.0f;
        x[j] = 0;
        mk[j] = 0.0f;
      }
      ++r;
    }
    p = (line_end == end) ? end : line_end + 1;
    *rows_out = r;
    *consumed_out = p - buf;
  }
  return 0;
}

int dmlc_native_abi_version() { return 6; }

}  // extern "C"
