// Batched Bloom-filter probe for Hopper (sm_90a): for every key and every
// one of n byte-packed indicator bitmaps, whether all k probed bits are set.
//
// Replaces the TPU kernel src/repro/kernels/bloom/bloom.py:30
// (_probe_kernel, launched by _bloom_probe_jit through bloom_probe_pallas
// and ops.bloom_probe).  Same function, same hash family (the JAX package's
// kernels/bloom/ref.py):
//   h1    = mix32(key ^ seed * 0x9E3779B9)        (seed word from the host)
//   h2    = mix32(key ^ 0x85EBCA6B) | 1           (once per key)
//   idx_i = (h1 + i * h2) mod 2^32 mod m,  i = 0 .. k-1
//   out[key, j] = AND_i bit idx_i of bitmap j     (byte idx >> 3, lane idx & 7)
// in native uint32 arithmetic, keys taken as their low 32 bits.  A chain of
// probes stops at the first zero bit, which gives the AND's value.
//
// Not carried over: the TPU design's iota-compare/select-reduce over
// 2048-byte blocks (a TPU has no fast gather) and its m_bytes % 2048
// tiling rule.  Here a probe is one byte load, and any m_bytes with
// 8 * m_bytes < 2^32 is taken.
//
// Bound.  What bounds it depends on where the bitmaps live:
//   * small bitmaps (the paper shape: 8 x 17,500 bytes) -- integer issue
//     (132 SMs x 64 INT32 lanes x 1.98 GHz): the two mix32 hashes and the
//     probes, one operation per operator of ref.py's formula;
//   * bitmaps far larger than L2 (the fleet shape: 16 x 70 MB = 1.12 GB,
//     22x the 50 MB L2) -- gathered 32-byte sectors from device memory, one
//     per distinct sector that the needed probes touch.
//
// Design.
//   * No division on the probe path.  h1 mod m (per key and bitmap) and h2
//     mod m (per key) come from Lemire's fastmod (a multiply by a 64-bit
//     magic from the host, then the high word of a product; exact for every
//     32-bit value and every m < 2^32).  Each next index is then an add
//     and a conditional subtract modulo m: x_{i+1} = x_i + h2 wraps mod
//     2^32 exactly when it comes out below h2, and then the residue takes
//     (h2 - 2^32) mod m = (h2 mod m - 2^32 mod m) mod m instead of h2 mod
//     m, with 2^32 mod m from the host.
//   * Small bitmaps in shared memory: when all n fit a block's dynamic
//     shared memory (the card's opt-in limit, set by cudaFuncSetAttribute),
//     each block stages them once and takes keys grid-stride, one block
//     per SM or as many as fit; probes are then shared-memory loads.
//     Larger bitmaps are probed through the read-only path (__ldg).  Both
//     are kernels; the size picks one.
//   * Loads in flight: a thread takes its key's bitmaps eight at a time
//     and issues all eight first probes before it tests a bit (every
//     (key, bitmap) needs its first probe, so no sector beyond the needed
//     ones is read); then only the chains still positive go on, each to
//     its first zero bit.
//   * Results: each eight-bitmap group of the key's n results is packed
//     into one 8-byte store where it is 8-byte aligned (n a multiple of
//     8), else stored byte by byte.
//
// Measured by chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W): the paper
// shape 0.0727 ms, 5.2x its operations bound (one 1024-thread block an SM,
// as the 140 KB of bitmaps allow; a warp's chain runs as long as its
// longest lane's, and some key of a warp is usually a member); the fleet
// shape 1.37 ms a launch, 0.99 TB/s of 32-byte sectors counting one a
// needed probe -- above a PyTorch gather of as many random bytes over the
// same 1.12 GB (0.92 TB/s) and nearly flat from a 280 MB span (1.06 TB/s),
// so the bound there is the card's random-sector rate, not the TLB's
// reach.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGlobalThreads = 256;
constexpr int kSharedThreads = 1024;
constexpr long long kMaxBlocks = 1LL << 20;   // grid-stride beyond this
constexpr int kGroup = 8;                     // bitmaps probed together

struct Hash {
  uint64_t magic;      // UINT64_MAX / m + 1 (fastmod)
  uint32_t m;          // bits per bitmap
  uint32_t wrap;       // 2^32 mod m
  long long m_bytes;
  int n;
  int k;
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t fastmod(uint32_t a, const Hash& h) {
  return static_cast<uint32_t>(__umul64hi(h.magic * a, h.m));
}

// (y + a) mod m for y, a in [0, m), given m - a: no overflow for m < 2^32.
__device__ __forceinline__ uint32_t add_mod(uint32_t y, uint32_t a,
                                            uint32_t m_minus_a) {
  return y >= m_minus_a ? y - m_minus_a : y + a;
}

template <bool kShared, typename Key>
__global__ void __launch_bounds__(kShared ? kSharedThreads : kGlobalThreads)
bloom_probe_kernel(const uint8_t* __restrict__ bits,
                   const long long* __restrict__ seed_words,
                   const Key* __restrict__ keys, long long rows,
                   int8_t* __restrict__ out, const Hash h) {
  extern __shared__ uint4 s_raw[];
  uint8_t* s_bits = reinterpret_cast<uint8_t*>(s_raw);
  if constexpr (kShared) {
    const long long total = (long long)h.n * h.m_bytes;
    long long done = 0;
    if ((reinterpret_cast<uintptr_t>(bits) & 15) == 0) {
      const uint4* src = reinterpret_cast<const uint4*>(bits);
      for (long long i = threadIdx.x; i < total / 16; i += blockDim.x) {
        s_raw[i] = __ldg(src + i);
      }
      done = total / 16 * 16;
    }
    for (long long i = done + threadIdx.x; i < total; i += blockDim.x) {
      s_bits[i] = __ldg(bits + i);
    }
    __syncthreads();
  }
  // byte ``byte`` of the bitmap that starts at ``row`` (staged bitmaps
  // take 32-bit offsets)
  auto load = [&](long long row, uint32_t byte) -> uint32_t {
    if constexpr (kShared) {
      return s_bits[static_cast<uint32_t>(row) + byte];
    } else {
      return __ldg(bits + row + byte);
    }
  };
  const long long step = (long long)gridDim.x * blockDim.x;
  // a block's threads run the same trip count (the tail's lanes idle)
  for (long long base = (long long)blockIdx.x * blockDim.x; base < rows;
       base += step) {
    const long long t = base + threadIdx.x;
    const bool active = t < rows;
    const uint32_t key = active ? static_cast<uint32_t>(keys[t]) : 0u;
    const uint32_t h2 = mix32(key ^ 0x85EBCA6Bu) | 1u;
    // residue steps: h2 mod m without a wrap, (h2 - 2^32) mod m with one
    const uint32_t d = fastmod(h2, h);
    const uint32_t e = d >= h.wrap ? d - h.wrap : d + (h.m - h.wrap);
    const uint32_t md = h.m - d, me = h.m - e;
    for (int c0 = 0; c0 < h.n; c0 += kGroup) {
      const int cnt = active ? min(kGroup, h.n - c0) : 0;
      uint32_t x[kGroup], y[kGroup];
      unsigned alive = 0;             // bit q: bitmap c0 + q still positive
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        // hashed for every q (the last bitmap's seed past the end), so the
        // eight hashes issue without a branch; only the loads are guarded
        const long long word = __ldg(seed_words + c0 + min(q, h.n - c0 - 1));
        x[q] = mix32(key ^ static_cast<uint32_t>(word));
        y[q] = fastmod(x[q], h);
        if (q < cnt) {
          const uint32_t v = load((long long)(c0 + q) * h.m_bytes, y[q] >> 3);
          alive |= ((v >> (y[q] & 7u)) & 1u) << q;
        }
      }
      // then each chain still positive, on to its first zero bit
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        if ((alive >> q) & 1u) {
          const long long row = (long long)(c0 + q) * h.m_bytes;
          uint32_t xi = x[q], yi = y[q];
          for (int i = 1; i < h.k; ++i) {
            xi += h2;
            const bool wrapped = xi < h2;
            yi = add_mod(yi, wrapped ? e : d, wrapped ? me : md);
            if (!((load(row, yi >> 3) >> (yi & 7u)) & 1u)) {
              alive &= ~(1u << q);
              break;
            }
          }
        }
      }
      if (cnt == 0) continue;
      uint64_t packed = 0;
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        packed |= static_cast<uint64_t>((alive >> q) & 1u) << (8 * q);
      }
      int8_t* dst = out + t * h.n + c0;
      if (cnt == kGroup && (reinterpret_cast<uintptr_t>(dst) & 7) == 0) {
        *reinterpret_cast<uint64_t*>(dst) = packed;
      } else {
        for (int q = 0; q < cnt; ++q) {
          dst[q] = static_cast<int8_t>((packed >> (8 * q)) & 0xFF);
        }
      }
    }
  }
}

int grid_for(long long rows, int threads, long long cap) {
  const long long blocks = (rows + threads - 1) / threads;
  return (int)(blocks < cap ? blocks : cap);
}

// Largest bitmap bytes (n * m_bytes, rounded up to 16) one block can stage
// in shared memory on the current device: its per-block opt-in maximum.
cudaError_t stage_limit(long long* limit) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  *limit = optin;
  return err;
}

template <typename Key>
int launch(const uint8_t* bits, const long long* words, const Key* keys,
           long long rows, int8_t* out, const Hash& h, cudaStream_t s) {
  long long limit = 0;
  cudaError_t err = stage_limit(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem = ((long long)h.n * h.m_bytes + 15) / 16 * 16;
  if (smem > limit) {
    bloom_probe_kernel<false, Key>
        <<<grid_for(rows, kGlobalThreads, kMaxBlocks), kGlobalThreads, 0,
           s>>>(bits, words, keys, rows, out, h);
    return static_cast<int>(cudaGetLastError());
  }
  auto kernel = bloom_probe_kernel<true, Key>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kSharedThreads, (size_t)smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<grid_for(rows, kSharedThreads, (long long)per_sm * sms),
           kSharedThreads, (size_t)smem, s>>>(bits, words, keys, rows, out,
                                              h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns 0 once launched, else the CUDA error (a refused attribute,
// occupancy query or launch).  Callers guarantee rows >= 1, n >= 1,
// k >= 1, 1 <= m_bytes < 2^29, contiguous buffers on the current device:
// bits [n, m_bytes] uint8, seed_words [n] int64 (seed * 0x9E3779B9 mod
// 2^32), keys [rows] int64 when keys_are_64 else int32, out [rows, n] int8.
int bloom_probe(const void* bits, int n, long long m_bytes,
                const void* seed_words, const void* keys, int keys_are_64,
                long long rows, int k, void* out, void* stream) {
  Hash h;
  h.m = static_cast<uint32_t>(m_bytes * 8);
  h.magic = UINT64_MAX / h.m + 1;
  h.wrap = static_cast<uint32_t>((1ULL << 32) % h.m);
  h.m_bytes = m_bytes;
  h.n = n;
  h.k = k;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto b = static_cast<const uint8_t*>(bits);
  const auto w = static_cast<const long long*>(seed_words);
  const auto o = static_cast<int8_t*>(out);
  if (keys_are_64) {
    return launch(b, w, static_cast<const long long*>(keys), rows, o, h, s);
  }
  return launch(b, w, static_cast<const int*>(keys), rows, o, h, s);
}

// The shared-memory staging limit in bytes of bitmaps on the current
// device (the per-block opt-in maximum), or -1 on a CUDA error.
long long bloom_stage_limit(void) {
  long long limit = 0;
  return stage_limit(&limit) == cudaSuccess ? limit : -1;
}

}  // extern "C"
