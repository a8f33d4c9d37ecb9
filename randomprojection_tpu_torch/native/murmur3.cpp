// MurmurHash3 x86_32 (Austin Appleby, public domain) + batch token hashing.
//
// The port's own copy of the host-side hashing component of the feature
// hasher (randomprojection_tpu/native/murmur3.cpp): the C++ counterpart of
// sklearn's `feature_extraction/_hashing_fast.pyx`.  native/build.py
// compiles it with g++ at first use into build/native/ and binds it with
// ctypes.
//
// Contract (sklearn FeatureHasher semantics):
//   h    = signed 32-bit murmur3 of the token bytes, seed 0
//   idx  = |h| mod n_features
//   sign = +1 if h >= 0 else -1        (alternate_sign)

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

static inline uint32_t rotl32(uint32_t x, int8_t r) {
  return (x << r) | (x >> (32 - r));
}

static inline uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// Threading: token i's outputs depend only on token i, so splitting the
// range over threads is bit-identical to the serial loop at any thread
// count.  Engages only for large batches (>= 2^18 tokens) on multi-core
// hosts.  The worker count comes from the explicit `n_threads` argument
// of the *_t entry points (the streaming path's per-call opt-in — no
// process-global state, safe for concurrent streams); the legacy entry
// points pass 0 = consult RP_HASH_THREADS / hardware concurrency
// (0/1 = serial).
static int64_t hash_worker_count(int64_t n_tokens, int64_t requested) {
  int64_t hc = requested;
  if (hc <= 0) {
    hc = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (const char* env = std::getenv("RP_HASH_THREADS")) {
      const long v = std::strtol(env, nullptr, 10);
      hc = v > 0 ? v : 1;
    }
  }
  if (hc <= 1 || n_tokens < (int64_t{1} << 18)) return 1;
  // keep >= 64k tokens per thread so spawn cost stays negligible
  return std::max<int64_t>(1, std::min(hc, n_tokens >> 16));
}

template <typename Fn>
static void parallel_over(int64_t n, int64_t requested, Fn fn) {
  const int64_t nw = hash_worker_count(n, requested);
  if (nw == 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(nw);
  const int64_t chunk = (n + nw - 1) / nw;
  int64_t dispatched = 0;  // rows [0, dispatched) are owned by threads
  // spawn failure (e.g. EAGAIN under RLIMIT_NPROC) must not escape the
  // extern "C" boundary into ctypes: finish the rest serially instead
  try {
    for (int64_t w = 0; w < nw; w++) {
      const int64_t lo = w * chunk;
      const int64_t hi = std::min(n, lo + chunk);
      if (lo >= hi) break;
      threads.emplace_back(fn, lo, hi);
      dispatched = hi;
    }
  } catch (...) {
  }
  if (dispatched < n) fn(dispatched, n);
  for (auto& t : threads) t.join();
}

extern "C" {

uint32_t murmur3_32(const uint8_t* data, int64_t len, uint32_t seed) {
  const int64_t nblocks = len / 4;
  uint32_t h1 = seed;
  const uint32_t c1 = 0xcc9e2d51u;
  const uint32_t c2 = 0x1b873593u;

  for (int64_t i = 0; i < nblocks; i++) {
    uint32_t k1;
    std::memcpy(&k1, data + i * 4, 4);  // little-endian assumed (x86/ARM)
    k1 *= c1;
    k1 = rotl32(k1, 15);
    k1 *= c2;
    h1 ^= k1;
    h1 = rotl32(h1, 13);
    h1 = h1 * 5 + 0xe6546b64u;
  }

  const uint8_t* tail = data + nblocks * 4;
  uint32_t k1 = 0;
  switch (len & 3) {
    case 3: k1 ^= static_cast<uint32_t>(tail[2]) << 16; [[fallthrough]];
    case 2: k1 ^= static_cast<uint32_t>(tail[1]) << 8;  [[fallthrough]];
    case 1:
      k1 ^= tail[0];
      k1 *= c1;
      k1 = rotl32(k1, 15);
      k1 *= c2;
      h1 ^= k1;
  }

  h1 ^= static_cast<uint32_t>(len);
  return fmix32(h1);
}

// Batch with an explicit worker count (`n_threads`; <= 0 = consult
// RP_HASH_THREADS / hardware default): tokens concatenated in `buf`,
// token i = buf[offsets[i], offsets[i+1]).  Writes idx (|h| mod
// n_features) and sign (±1) per token.
void hash_tokens_t(const uint8_t* buf, const int64_t* offsets,
                   int64_t n_tokens, uint32_t seed, uint32_t n_features,
                   int32_t* out_idx, int8_t* out_sign, int64_t n_threads) {
  parallel_over(n_tokens, n_threads, [=](int64_t a, int64_t b) {
    for (int64_t i = a; i < b; i++) {
      const int64_t lo = offsets[i];
      const int64_t len = offsets[i + 1] - lo;
      const int32_t h = static_cast<int32_t>(murmur3_32(buf + lo, len, seed));
      const int64_t habs = h < 0 ? -static_cast<int64_t>(h) : h;
      out_idx[i] = static_cast<int32_t>(habs % n_features);
      out_sign[i] = h >= 0 ? 1 : -1;
    }
  });
}

// Worker count from the environment (RP_HASH_THREADS / hardware).
void hash_tokens(const uint8_t* buf, const int64_t* offsets, int64_t n_tokens,
                 uint32_t seed, uint32_t n_features, int32_t* out_idx,
                 int8_t* out_sign) {
  hash_tokens_t(buf, offsets, n_tokens, seed, n_features, out_idx, out_sign,
                0);
}

// Strided batch: token i = buf[i*stride, i*stride + lengths[i]).  This is
// the zero-copy layout of a numpy fixed-width bytes ('S<w>') array, so a
// whole token column ingests in ONE call with no per-token Python work —
// the vectorized path for the streaming TF-IDF workload.
void hash_tokens_strided_t(const uint8_t* buf, int64_t stride,
                           const int64_t* lengths, int64_t n_tokens,
                           uint32_t seed, uint32_t n_features,
                           int32_t* out_idx, int8_t* out_sign,
                           int64_t n_threads) {
  parallel_over(n_tokens, n_threads, [=](int64_t a, int64_t b) {
    for (int64_t i = a; i < b; i++) {
      const int32_t h = static_cast<int32_t>(
          murmur3_32(buf + i * stride, lengths[i], seed));
      const int64_t habs = h < 0 ? -static_cast<int64_t>(h) : h;
      out_idx[i] = static_cast<int32_t>(habs % n_features);
      out_sign[i] = h >= 0 ? 1 : -1;
    }
  });
}

void hash_tokens_strided(const uint8_t* buf, int64_t stride,
                         const int64_t* lengths, int64_t n_tokens,
                         uint32_t seed, uint32_t n_features,
                         int32_t* out_idx, int8_t* out_sign) {
  hash_tokens_strided_t(buf, stride, lengths, n_tokens, seed, n_features,
                        out_idx, out_sign, 0);
}

}  // extern "C"
