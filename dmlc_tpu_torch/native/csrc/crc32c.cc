// CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) for the port's
// host side: RecordIO checksums and checkpoint shard digests.
//
// dmlc_crc32c(buf, n, init) has the chaining contract of the JAX
// package's native core: the value of a buffer, chained from `init`
// (0 for a fresh digest), so crc(a + b) == crc(b, crc(a)).  Where the
// CPU has SSE4.2 the crc32 instruction runs over 8 bytes at a time; any
// other host takes the slicing-by-8 table loop.  Both give the same
// value for every input.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC crc32c.cc -o libcrc32c.so
// (dmlc_tpu_torch/native/__init__.py does this at first use).

#include <cstdint>
#include <cstring>

#if defined(__x86_64__) || defined(_M_X64)
#include <nmmintrin.h>
#define DMLC_CRC_X86 1
#endif

namespace {

constexpr uint32_t kPoly = 0x82F63B78u;

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1u) ? (c >> 1) ^ kPoly : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFFu];
  }
};

const Tables& tables() {
  static const Tables tab;
  return tab;
}

// The raw register update (no pre/post inversion) over n bytes.
uint32_t crc_table(uint32_t c, const uint8_t* buf, long n) {
  const uint32_t(*t)[256] = tables().t;
  long i = 0;
  for (; i + 8 <= n; i += 8) {
    uint32_t lo, hi;
    memcpy(&lo, buf + i, 4);
    memcpy(&hi, buf + i + 4, 4);
    lo ^= c;
    c = t[7][lo & 0xFFu] ^ t[6][(lo >> 8) & 0xFFu] ^
        t[5][(lo >> 16) & 0xFFu] ^ t[4][lo >> 24] ^ t[3][hi & 0xFFu] ^
        t[2][(hi >> 8) & 0xFFu] ^ t[1][(hi >> 16) & 0xFFu] ^ t[0][hi >> 24];
  }
  for (; i < n; ++i) c = t[0][(c ^ buf[i]) & 0xFFu] ^ (c >> 8);
  return c;
}

#ifdef DMLC_CRC_X86
__attribute__((target("sse4.2"))) uint32_t crc_hw(uint32_t c,
                                                  const uint8_t* buf,
                                                  long n) {
  uint64_t c64 = c;
  for (; n >= 8; n -= 8, buf += 8) {
    uint64_t w;
    memcpy(&w, buf, 8);
    c64 = _mm_crc32_u64(c64, w);
  }
  uint32_t c32 = static_cast<uint32_t>(c64);
  for (; n > 0; --n, ++buf) c32 = _mm_crc32_u8(c32, *buf);
  return c32;
}

bool have_sse42() {
  static const bool ok = __builtin_cpu_supports("sse4.2");
  return ok;
}
#endif

}  // namespace

extern "C" {

// CRC-32C of buf[0:n) chained from init (0 for a fresh digest).
uint32_t dmlc_crc32c(const uint8_t* buf, long n, uint32_t init) {
  uint32_t c = init ^ 0xFFFFFFFFu;
#ifdef DMLC_CRC_X86
  if (have_sse42()) return crc_hw(c, buf, n) ^ 0xFFFFFFFFu;
#endif
  return crc_table(c, buf, n) ^ 0xFFFFFFFFu;
}

// The table route alone, whatever the CPU (tests hold the two routes
// against each other).
uint32_t dmlc_crc32c_table(const uint8_t* buf, long n, uint32_t init) {
  return crc_table(init ^ 0xFFFFFFFFu, buf, n) ^ 0xFFFFFFFFu;
}

// 1 when dmlc_crc32c takes the SSE4.2 route on this CPU.
int dmlc_crc32c_hw(void) {
#ifdef DMLC_CRC_X86
  return have_sse42() ? 1 : 0;
#else
  return 0;
#endif
}
}
