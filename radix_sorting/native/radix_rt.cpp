// radix_rt — native host runtime for the sort framework.
//
// The reference's host-side machinery is C/C++: mmap'd dataset IO and
// hugepage placement (`radix_experiment.cpp:53-104`), dataset generation
// (`Makefile:79-82`), and always-on sort verification
// (`radix_experiment.cpp:137-174`). This library provides the
// framework's native equivalents, plus an independent host radix-sort
// oracle used by tests to cross-check device results. The oracle is a
// fresh implementation (single-digit passes with per-pass counting,
// prefix and placement loops fused per pass) — it reproduces the
// *semantics* of a stable LSD radix sort, not the reference's code.
//
// Exposed as a C ABI for ctypes (see radix_sorting/runtime/native.py).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// splitmix64: tiny, well-known PRNG for reproducible dataset generation.
inline uint64_t splitmix64(uint64_t& state) {
  uint64_t z = (state += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// Order-preserving unsigned mapping per key kind, mirroring the framework's
// KDF semantics (radix_sorting/ops/kdf.py): kind 0 = unsigned identity,
// kind 1 = signed sign-flip, kind 2 = float sign-mangle.
inline uint64_t derive(uint64_t raw, int kind, int bits) {
  const uint64_t high = 1ull << (bits - 1);
  switch (kind) {
    case 1:
      return raw ^ high;
    case 2: {
      const uint64_t live = (bits == 64) ? ~0ull : ((1ull << bits) - 1);
      const uint64_t m = (raw & high) ? live : high;
      return raw ^ m;
    }
    default:
      return raw;
  }
}

template <typename W>
int is_sorted_derived(const W* data, int64_t n, int kind, int descending) {
  const int bits = 8 * static_cast<int>(sizeof(W));
  for (int64_t i = 1; i < n; ++i) {
    uint64_t a = derive(data[i - 1], kind, bits);
    uint64_t b = derive(data[i], kind, bits);
    if (descending ? (a < b) : (a > b)) return 0;
  }
  return 1;
}

// Stable LSD radix oracle over derived keys, one byte per round.
// Returns false on allocation failure (data untouched) so the C ABI can
// report it instead of handing back unsorted data labeled as sorted.
template <typename W>
bool oracle_sort(W* data, int64_t n, int kind) {
  if (n < 2) return true;
  const int bits = 8 * static_cast<int>(sizeof(W));
  const int rounds = bits / 8;
  W* spare = static_cast<W*>(std::malloc(sizeof(W) * static_cast<size_t>(n)));
  if (!spare) return false;
  W* cur = data;
  W* next = spare;
  for (int r = 0; r < rounds; ++r) {
    const int shift = 8 * r;
    int64_t bucket_count[256] = {0};
    for (int64_t i = 0; i < n; ++i) {
      ++bucket_count[(derive(cur[i], kind, bits) >> shift) & 0xFF];
    }
    int64_t offsets[256];
    int64_t running = 0;
    for (int b = 0; b < 256; ++b) {
      offsets[b] = running;
      running += bucket_count[b];
    }
    if (bucket_count[(derive(cur[0], kind, bits) >> shift) & 0xFF] == n) {
      continue;  // constant digit: nothing moves this round
    }
    for (int64_t i = 0; i < n; ++i) {
      next[offsets[(derive(cur[i], kind, bits) >> shift) & 0xFF]++] = cur[i];
    }
    W* t = cur; cur = next; next = t;
  }
  if (cur != data) std::memcpy(data, cur, sizeof(W) * static_cast<size_t>(n));
  std::free(spare);
  return true;
}

// Stable rank (argsort) oracle: permutes an index vector, input untouched.
template <typename W>
bool oracle_rank(const W* data, uint32_t* idx, int64_t n, int kind) {
  if (n < 1) return true;
  const int bits = 8 * static_cast<int>(sizeof(W));
  const int rounds = bits / 8;
  for (int64_t i = 0; i < n; ++i) idx[i] = static_cast<uint32_t>(i);
  uint32_t* spare =
      static_cast<uint32_t*>(std::malloc(sizeof(uint32_t) * static_cast<size_t>(n)));
  if (!spare) return false;
  uint32_t* cur = idx;
  uint32_t* next = spare;
  for (int r = 0; r < rounds; ++r) {
    const int shift = 8 * r;
    int64_t bucket_count[256] = {0};
    for (int64_t i = 0; i < n; ++i) {
      ++bucket_count[(derive(data[cur[i]], kind, bits) >> shift) & 0xFF];
    }
    int64_t offsets[256];
    int64_t running = 0;
    for (int b = 0; b < 256; ++b) {
      offsets[b] = running;
      running += bucket_count[b];
    }
    for (int64_t i = 0; i < n; ++i) {
      next[offsets[(derive(data[cur[i]], kind, bits) >> shift) & 0xFF]++] = cur[i];
    }
    uint32_t* t = cur; cur = next; next = t;
  }
  if (cur != idx) std::memcpy(idx, cur, sizeof(uint32_t) * static_cast<size_t>(n));
  std::free(spare);
  return true;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- dataset IO

// Read n items of `itemsize` bytes from a raw key file into out.
// mmap-based (one copy, no buffered-IO overhead — the native equivalent of
// `radix_experiment.cpp:78-104`). Returns items read, or -1 on error.
int64_t rrt_read_keyfile(const char* path, void* out, int64_t n, int itemsize) {
  if (itemsize <= 0) return -1;  // divide-by-zero guard (SIGFPE via ctypes)
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -1; }
  int64_t avail = st.st_size / itemsize;
  int64_t take = n < avail ? n : avail;
  size_t bytes = static_cast<size_t>(take) * itemsize;
  if (bytes > 0) {
    void* m = mmap(nullptr, bytes, PROT_READ, MAP_PRIVATE, fd, 0);
    if (m == MAP_FAILED) { close(fd); return -1; }
    madvise(m, bytes, MADV_SEQUENTIAL);
    std::memcpy(out, m, bytes);
    munmap(m, bytes);
  }
  close(fd);
  return take;
}

// Generate n uniform u32 keys (splitmix64 stream) straight to a file.
// Returns 0 on success. The native `make genkeys` (`Makefile:79-82`),
// deterministic instead of /dev/urandom for reproducible benchmarks.
int rrt_generate_keyfile(const char* path, int64_t n, uint64_t seed) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  const int64_t kChunk = 1 << 18;
  uint32_t* buf =
      static_cast<uint32_t*>(std::malloc(sizeof(uint32_t) * kChunk));
  if (!buf) { std::fclose(f); return -1; }
  uint64_t state = seed;
  int64_t left = n;
  while (left > 0) {
    int64_t take = left < kChunk ? left : kChunk;
    for (int64_t i = 0; i < take; i += 2) {
      uint64_t r = splitmix64(state);
      buf[i] = static_cast<uint32_t>(r);
      if (i + 1 < take) buf[i + 1] = static_cast<uint32_t>(r >> 32);
    }
    if (std::fwrite(buf, sizeof(uint32_t), static_cast<size_t>(take), f) !=
        static_cast<size_t>(take)) {
      std::free(buf); std::fclose(f); return -1;
    }
    left -= take;
  }
  std::free(buf);
  return std::fclose(f) == 0 ? 0 : -1;
}

// ---------------------------------------------------------------- verification

// kind: 0 unsigned, 1 signed, 2 float; width in {1,2,4,8} bytes.
// Returns 1 if sorted in KDF order, 0 if not, -1 on bad args.
int rrt_is_sorted(const void* data, int64_t n, int width, int kind,
                  int descending) {
  switch (width) {
    case 1: return is_sorted_derived(static_cast<const uint8_t*>(data), n, kind, descending);
    case 2: return is_sorted_derived(static_cast<const uint16_t*>(data), n, kind, descending);
    case 4: return is_sorted_derived(static_cast<const uint32_t*>(data), n, kind, descending);
    case 8: return is_sorted_derived(static_cast<const uint64_t*>(data), n, kind, descending);
    default: return -1;
  }
}

// ---------------------------------------------------------------- oracles

// In-place stable LSD radix sort in KDF order. Returns 0, or -1 on bad args.
int rrt_oracle_sort(void* data, int64_t n, int width, int kind) {
  switch (width) {  // -2 = allocation failure (data untouched)
    case 1: return oracle_sort(static_cast<uint8_t*>(data), n, kind) ? 0 : -2;
    case 2: return oracle_sort(static_cast<uint16_t*>(data), n, kind) ? 0 : -2;
    case 4: return oracle_sort(static_cast<uint32_t*>(data), n, kind) ? 0 : -2;
    case 8: return oracle_sort(static_cast<uint64_t*>(data), n, kind) ? 0 : -2;
    default: return -1;
  }
}

// Stable rank/argsort: fills idx with the unique stable permutation.
int rrt_oracle_rank(const void* data, uint32_t* idx, int64_t n, int width,
                    int kind) {
  switch (width) {  // -2 = allocation failure (idx incomplete)
    case 1: return oracle_rank(static_cast<const uint8_t*>(data), idx, n, kind) ? 0 : -2;
    case 2: return oracle_rank(static_cast<const uint16_t*>(data), idx, n, kind) ? 0 : -2;
    case 4: return oracle_rank(static_cast<const uint32_t*>(data), idx, n, kind) ? 0 : -2;
    case 8: return oracle_rank(static_cast<const uint64_t*>(data), idx, n, kind) ? 0 : -2;
    default: return -1;
  }
}

}  // extern "C"
