// Sanitizer stress program for the port's native core
// (dmlc_tpu_torch/native/csrc/dmlc_native.cc with crc32c.cc): the
// multi-threaded parse fanout (parse_sparse_mt / dmlc_parse_csv
// std::thread workers) plus the ABI-6 fused feed entry points
// (dmlc_recordio_spans_verify, dmlc_pad_pack_rows, dmlc_pad_pack_csr,
// dmlc_parse_libsvm_into) exercised concurrently from several caller
// threads — the exact shape of the Python-side use, where ctypes
// releases the GIL so calls genuinely overlap.  A copy of the JAX
// package's program (dmlc_tpu/cpp/test_native_tsan.cc): the ABI is the
// same, function for function.  tests/test_torch_sanitizers.py builds
// and runs it under -fsanitize=thread and under -fsanitize=undefined
// (clean and corrupt chunks both walked, so the reject/resync paths get
// UB coverage too):
//
//   g++ -O1 -g -std=c++17 -fsanitize=thread crc32c.cc dmlc_native.cc \
//       test_native_tsan.cc -o test_native_tsan -pthread
//
// It is not part of libdmlc_native (native/__init__.py lists the
// library's sources by name).

#include <cassert>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {
long dmlc_parse_libsvm(const char* buf, long n, float* labels,
                       float* weights, uint64_t* offsets, uint32_t* index,
                       float* value, long max_rows, long max_nnz,
                       int nthread, long* n_rows, long* n_nnz,
                       int* has_weight);
long dmlc_parse_csv(const char* buf, long n, char delim, int nthread,
                    float* out, long max_vals, long* n_rows, long* n_cols);
uint32_t dmlc_crc32c(const uint8_t* buf, long n, uint32_t init);
long dmlc_recordio_spans_verify(const uint8_t* buf, long n, uint32_t magic,
                                int verify, uint64_t* out, long max_spans,
                                long* n_spans);
long dmlc_pad_pack_rows(const uint8_t* src, long src_len,
                        const uint64_t* spans, long n_rows, uint32_t magic,
                        long max_bytes, uint8_t* out_rows,
                        int32_t* out_lens);
long dmlc_pad_pack_csr(const float* labels, const uint64_t* offsets,
                       const uint32_t* index, const float* value,
                       long nnz_size, long b, long batch_size, long max_nnz,
                       long num_col, float* out_label, float* out_value,
                       int32_t* out_index, float* out_mask);
long dmlc_parse_libsvm_into(const char* buf, long n, long start,
                            long row_base, long batch_rows, long max_nnz,
                            long num_col, float* out_label, float* out_value,
                            int32_t* out_index, float* out_mask,
                            long* rows_out, long* consumed_out);
}

static const uint32_t kMagic = 0xced7230au;

// A small recordio chunk: plain + checksummed records, one escaped-magic
// (multi-segment) checksummed record.  Mirrors io/recordio.py's writer.
static std::string make_chunk(int recs) {
  std::string s;
  auto put32 = [&s](uint32_t v) { s.append((const char*)&v, 4); };
  for (int i = 0; i < recs; ++i) {
    std::string body(8 + (i % 13) * 4, (char)('a' + i % 23));
    int ck = i % 2;
    uint32_t cflag = ck ? 4u : 0u;
    put32(kMagic);
    put32((cflag << 29u) | (uint32_t)body.size());
    if (ck) {
      uint32_t c = dmlc_crc32c((const uint8_t*)body.data(),
                               (long)body.size(), 0);
      put32(c == kMagic ? c ^ 1u : c);
    }
    s += body;
    while (s.size() % 4) s.push_back('\0');
  }
  // one checksummed multi-segment record: start + end segments with the
  // elided magic between them (payload was "xxxx<magic>yyyy")
  const char* segs[2] = {"xxxx", "yyyy"};
  for (int k = 0; k < 2; ++k) {
    uint32_t cflag = (k == 0 ? 1u : 3u) | 4u;
    put32(kMagic);
    put32((cflag << 29u) | 4u);
    uint32_t c = dmlc_crc32c((const uint8_t*)segs[k], 4, 0);
    put32(c == kMagic ? c ^ 1u : c);
    s.append(segs[k], 4);
  }
  return s;
}

static std::string make_libsvm(int rows) {
  std::string s;
  char line[256];
  for (int i = 0; i < rows; ++i) {
    snprintf(line, sizeof line, "%d 0:%d.5 3:%d 7:0.25\n", i % 2, i, i * 2);
    s += line;
  }
  return s;
}

static std::string make_csv(int rows) {
  std::string s;
  char line[128];
  for (int i = 0; i < rows; ++i) {
    snprintf(line, sizeof line, "%d,%d.5,%d\n", i, i, i * 3);
    s += line;
  }
  return s;
}

int main() {
  const std::string svm = make_libsvm(5000);
  const std::string csv = make_csv(5000);
  const std::string chunk = make_chunk(400);
  // corrupt variants drive the reject/resync paths: flipped payload
  // byte (crc mismatch), flipped magic (bad magic + resync), and a
  // stray aligned word at the chunk tail (torn-tail reject)
  std::string bad_crc = chunk;
  bad_crc[bad_crc.size() / 2] ^= (char)0xff;
  std::string bad_magic = chunk;
  bad_magic[16] ^= (char)0xff;
  std::string stray_tail = chunk;
  stray_tail.append((const char*)&kMagic, 4);
  std::vector<std::thread> callers;
  std::vector<int> fails(8, 0);
  for (int c = 0; c < 8; ++c) {
    callers.emplace_back([&, c]() {
      for (int rep = 0; rep < 5; ++rep) {
        // libsvm with an internal 4-thread fanout
        std::vector<float> labels(6000), weights(6000), value(30000);
        std::vector<uint64_t> offsets(6001);
        std::vector<uint32_t> index(30000);
        long n_rows = 0, n_nnz = 0;
        int has_w = 0;
        long rc = dmlc_parse_libsvm(
            svm.data(), (long)svm.size(), labels.data(), weights.data(),
            offsets.data(), index.data(), value.data(), 6000, 30000, 4,
            &n_rows, &n_nnz, &has_w);
        if (rc != 0 || n_rows != 5000 || n_nnz != 15000) fails[c] = 1;
        // csv with an internal 4-thread fanout
        std::vector<float> out(20000);
        long cr = 0, cc = 0;
        rc = dmlc_parse_csv(csv.data(), (long)csv.size(), ',', 4,
                            out.data(), 20000, &cr, &cc);
        if (rc != 0 || cr != 5000 || cc != 3) fails[c] = 1;
        if (out[3] != 1.0f || out[4] != 1.5f) fails[c] = 1;
        // fused scan+verify over clean and corrupt chunks (ABI 6)
        std::vector<uint64_t> spans(3 * 600);
        long n_sp = 0;
        rc = dmlc_recordio_spans_verify(
            (const uint8_t*)chunk.data(), (long)chunk.size(), kMagic, 1,
            spans.data(), 600, &n_sp);
        if (rc != 0 || n_sp != 401) fails[c] = 1;
        for (long i = 0; i < n_sp; ++i)
          if (spans[3 * i + 2] >= 8) fails[c] = 1;  // clean chunk
        // pad-pack the scanned spans straight into padded rows
        const long kPad = 64;
        std::vector<uint8_t> rows((size_t)n_sp * kPad);
        std::vector<int32_t> lens(n_sp);
        if (dmlc_pad_pack_rows((const uint8_t*)chunk.data(),
                               (long)chunk.size(), spans.data(), n_sp,
                               kMagic, kPad, rows.data(),
                               lens.data()) != 0)
          fails[c] = 1;
        if (lens[n_sp - 1] != 12) fails[c] = 1;  // xxxx<magic>yyyy
        for (const std::string* s : {&bad_crc, &bad_magic, &stray_tail}) {
          long m = 0;
          if (dmlc_recordio_spans_verify(
                  (const uint8_t*)s->data(), (long)s->size(), kMagic, 1,
                  spans.data(), 600, &m) != 0)
            fails[c] = 1;
          bool any_reject = false;
          for (long i = 0; i < m; ++i)
            if (spans[3 * i + 2] >= 8) any_reject = true;
          if (!any_reject) fails[c] = 1;
        }
        // CSR pad-pack and the fused libsvm tokenizer
        float lab[4] = {1, 0, 1, 0};
        uint64_t offs[5] = {0, 2, 2, 5, 6};
        uint32_t idx[6] = {0, 3, 1, 2, 4, 9};
        float val[6] = {1, 2, 3, 4, 5, 6};
        float ol[6], ov[6 * 3], om[6 * 3];
        int32_t oi[6 * 3];
        if (dmlc_pad_pack_csr(lab, offs, idx, val, 6, 4, 6, 3, 5, ol, ov,
                              oi, om) != 0 ||
            ol[0] != 1.0f || ov[0] != 1.0f || oi[1] != 3 ||
            om[3] != 0.0f || oi[8] != 4)
          fails[c] = 1;
        long rows_out = 0, consumed = 0;
        if (dmlc_parse_libsvm_into(svm.data(), (long)svm.size(), 0, 0, 6,
                                   3, 0, ol, ov, oi, om, &rows_out,
                                   &consumed) != 0 ||
            rows_out != 6 || consumed <= 0)
          fails[c] = 1;
      }
    });
  }
  for (auto& t : callers) t.join();
  for (int f : fails)
    if (f) {
      fprintf(stderr, "FAIL: parse mismatch under concurrency\n");
      return 1;
    }
  printf("tsan stress OK\n");
  return 0;
}
