// Batched Bloom-filter probe for Hopper (sm_90a): for every key and every
// one of n byte-packed indicator bitmaps, whether all k probed bits are set.
//
// Replaces the TPU kernel src/repro/kernels/bloom/bloom.py (_probe_kernel,
// launched by _bloom_probe_jit through bloom_probe_pallas and
// ops.bloom_probe).  Same function, same hash family (the JAX package's
// kernels/bloom/ref.py):
//   h1    = mix32(key ^ seed * 0x9E3779B9)        (seed word from the host)
//   h2    = mix32(key ^ 0x85EBCA6B) | 1           (once per key)
//   idx_i = (h1 + i * h2) mod 2^32 mod m,  i = 0 .. k-1
//   out[key, j] = AND_i bit idx_i of bitmap j     (byte idx >> 3, lane idx & 7)
// in native uint32 arithmetic, keys taken as their low 32 bits.  A probe
// loop stops at the first zero bit, which gives the AND's value.
//
// Not carried over: the TPU design's iota-compare/select-reduce over
// 2048-byte blocks (a TPU has no fast gather) and its m_bytes % 2048
// tiling rule.  Here a probe is one byte load through the read-only path
// (__ldg), and any m_bytes with 8 * m_bytes < 2^32 is taken.
//
// Bound.  What bounds it depends on where the bitmaps live:
//   * small bitmaps (the paper shape: 8 x 17,500 bytes, which sit in the
//     50 MB L2) -- integer issue: about 10 operations for h2 per key, 9
//     for h1 per (key, cache) and 8 per probe (multiply, add, modulo,
//     shift, mask, bit test), against 132 SMs x 64 INT32 lanes;
//   * bitmaps far larger than L2 (the fleet shape: 16 x 70 MB = 1.12 GB,
//     22x the L2) -- gathered 32-byte sectors from device memory, one per
//     distinct sector that the needed probes touch.
// This first design is one thread per key (grid-stride), h2 computed once
// per key, a loop over the n caches and their probes, and the key's n
// int8 results written contiguously.  Staging small bitmaps in shared
// memory and replacing the runtime modulo by a multiply-high are later
// work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 64;   // grid-stride beyond this

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

template <typename Key>
__global__ void __launch_bounds__(kThreads)
bloom_probe_kernel(const uint8_t* __restrict__ bits, int n, long long m_bytes,
                   uint32_t m, const long long* __restrict__ seed_words,
                   const Key* __restrict__ keys, long long rows, int k,
                   int8_t* __restrict__ out) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < rows; t += step) {
    const uint32_t key = static_cast<uint32_t>(keys[t]);   // low 32 bits
    const uint32_t h2 = mix32(key ^ 0x85EBCA6Bu) | 1u;
    int8_t* o = out + t * n;
    for (int j = 0; j < n; ++j) {
      const uint32_t h1 =
          mix32(key ^ static_cast<uint32_t>(__ldg(seed_words + j)));
      const uint8_t* row = bits + (long long)j * m_bytes;
      int8_t hit = 1;
      for (int i = 0; i < k; ++i) {
        const uint32_t idx = (h1 + static_cast<uint32_t>(i) * h2) % m;
        if (!((__ldg(row + (idx >> 3)) >> (idx & 7u)) & 1u)) {
          hit = 0;
          break;
        }
      }
      o[j] = hit;
    }
  }
}

int grid_for(long long rows) {
  const long long blocks = (rows + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).  Callers
// guarantee rows >= 1, n >= 1, k >= 1, 1 <= m_bytes < 2^29, contiguous
// buffers on the current device: bits [n, m_bytes] uint8, seed_words [n]
// int64 (seed * 0x9E3779B9 mod 2^32), keys [rows] int64 when keys_are_64
// else int32, out [rows, n] int8.
int bloom_probe(const void* bits, int n, long long m_bytes,
                const void* seed_words, const void* keys, int keys_are_64,
                long long rows, int k, void* out, void* stream) {
  const uint32_t m = static_cast<uint32_t>(m_bytes * 8);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto b = static_cast<const uint8_t*>(bits);
  const auto w = static_cast<const long long*>(seed_words);
  const auto o = static_cast<int8_t*>(out);
  if (keys_are_64) {
    bloom_probe_kernel<long long><<<grid_for(rows), kThreads, 0, s>>>(
        b, n, m_bytes, m, w, static_cast<const long long*>(keys), rows, k, o);
  } else {
    bloom_probe_kernel<int><<<grid_for(rows), kThreads, 0, s>>>(
        b, n, m_bytes, m, w, static_cast<const int*>(keys), rows, k, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
