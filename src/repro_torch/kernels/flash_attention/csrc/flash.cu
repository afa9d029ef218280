// Flash-attention forward (GQA, causal or not) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash.py:32
// (_flash_kernel, wrapper flash_attention_pallas).  That kernel walks a
// sequential grid (B, Hq, nQ, nK) and carries the online-softmax state
// (m, l, acc) in VMEM scratch from one KV block to the next.  Here blocks
// run in parallel and in no order, so one block owns one (batch, query
// head, 32-row query tile) and loops over the KV tiles itself, with m, l
// and acc in registers.
//
// Layout: q [B,Sq,Hq,D], k/v [B,Sk,Hkv,D], o [B,Sq,Hq,D] (the model's
// layout, contiguous); query head h reads KV head h / (Hq / Hkv), so the
// KV heads are never repeated in memory.  Any Sq and Sk: the last query
// tile and the last KV tile are masked at their edges (the TPU wrapper's
// sq % block_q == 0 rule was its tiling, not the function's).
//
// Arithmetic kept from the TPU kernel: q is cast to float32 and then
// scaled (flash.py:50); scores, m, l and acc are float32; a causally
// masked score is -1e30 (flash.py:29); p is rounded to v's type before
// the PV product (flash.py:64), l sums it unrounded; the final divide
// clamps l at 1e-30 (flash.py:69).  Causal masking compares positions that
// both start at 0 (query i sees keys j <= i, flash.py:44,55-57): prefill
// only.  KV tiles wholly above the diagonal are not visited.
//
// What bounds it: in bf16 at the serving shapes the bytes (q, k, v read
// once, o written once) and the launch; at long prefills the operations
// (4 * Hq * D * Sq * (Sq + 1) / 2 flops causal).  This first version does
// its products on the CUDA cores in float32, not on the tensor cores:
// four threads share a query row, each holding D/4 of q and of acc, the
// KV tile staged in shared memory as float32 and read as float4
// broadcasts, the four partial dot products summed with warp shuffles.
// wgmma, TMA and a pipeline of KV tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 32;               // query rows per block
constexpr int LANES = 4;             // threads per query row
constexpr int BK = 32;               // keys per staged KV tile
constexpr int THREADS = BQ * LANES;  // 128
constexpr float MASKED = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and back (p rounded to v's type before the PV product)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int Hq, int Hkv, int causal, float scale) {
  constexpr int V4 = D / (4 * LANES);  // float4 groups of q/acc per thread
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hk = h / (Hq / Hkv);
  const int row = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int qi = q0 + row;
  const bool live = qi < Sq;

  // this thread's dims: 16 * g + 4 * lane + (0..3) for g < V4
  float qr[V4][4], acc[V4][4];
  const long long qoff = ((long long)(b * (long long)Sq + qi) * Hq + h) * D;
#pragma unroll
  for (int g = 0; g < V4; ++g)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 16 * g + 4 * lane + c;
      qr[g][c] = live ? to_f(q[qoff + d]) * scale : 0.f;
      acc[g][c] = 0.f;
    }
  float m = MASKED, l = 0.f;

  // keys past the tile's last query row are masked for every row: skip
  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < BK * D; idx += THREADS) {
      const int j = idx / D, d = idx % D, kj = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kj < Sk) {
        const long long off = ((long long)(b * (long long)Sk + kj) * Hkv + hk) * D + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      ks[j][d] = kx;
      vs[j][d] = vx;
    }
    __syncthreads();

    float s[BK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int g = 0; g < V4; ++g) {
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[j][16 * g + 4 * lane]);
        part += qr[g][0] * k4.x + qr[g][1] * k4.y + qr[g][2] * k4.z + qr[g][3] * k4.w;
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kj = k0 + j;
      if (kj >= Sk)
        part = -INFINITY;              // past the last key: no key at all
      else if (causal && kj > qi)
        part = MASKED;
      s[j] = part;
      m_new = fmaxf(m_new, part);
    }
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      s[j] = round_to<T>(p);
    }
    l = l * alpha + psum;
#pragma unroll
    for (int g = 0; g < V4; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[g][c] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int g = 0; g < V4; ++g) {
        const float4 v4 = *reinterpret_cast<const float4*>(&vs[j][16 * g + 4 * lane]);
        acc[g][0] += s[j] * v4.x;
        acc[g][1] += s[j] * v4.y;
        acc[g][2] += s[j] * v4.z;
        acc[g][3] += s[j] * v4.w;
      }
    }
    m = m_new;
  }

  if (live) {
#pragma unroll
    for (int g = 0; g < V4; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        o[qoff + 16 * g + 4 * lane + c] = from_f<T>(acc[g][c] / fmaxf(l, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                   float scale, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, Hq, Hkv, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, int B, int Sq, int Sk, int Hq, int Hkv,
                       int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and o alike).  Returns the launch's
// CUDA error code (0 on success); the wrapper checks every argument first.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int Sq,
                                   int Sk, int Hq, int Hkv, int D, int dtype,
                                   int causal, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || Hq % Hkv != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, scale, s);
  return cudaErrorInvalidValue;
}
