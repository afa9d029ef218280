// Flash-attention forward (GQA, causal or not) in float32 on the CUDA
// cores, for Hopper (sm_90a).  The bf16 inputs take the tensor-core kernel
// in flash_wgmma.cu; this one serves float32, whose 2e-5 gate a TF32
// tensor-core product could not hold.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash.py:32
// (_flash_kernel, wrapper flash_attention_pallas) for float32 inputs.
// That kernel walks a sequential grid (B, Hq, nQ, nK) and carries the
// online-softmax state (m, l, acc) in VMEM scratch from one KV block to
// the next.  Here blocks run in parallel and in no order, so one block
// owns one (batch, query head, 32-row query tile) and loops over the KV
// tiles itself, with m, l and acc in registers.
//
// Layout: q [B,Sq,Hq,D], k/v [B,Sk,Hkv,D], o [B,Sq,Hq,D] (the model's
// layout, contiguous); query head h reads KV head h / (Hq / Hkv), so the
// KV heads are never repeated in memory.  Any Sq and Sk: the last query
// tile and the last KV tile are masked at their edges (the TPU wrapper's
// sq % block_q == 0 rule was its tiling, not the function's).
//
// Arithmetic kept from the TPU kernel: q is cast to float32 and then
// scaled (flash.py:50); scores, m, l, p and acc are float32 (flash.py:52
// casts v to float32, so p.astype(v.dtype) at :64 keeps p in float32); a
// causally masked score is -1e30 (flash.py:29); the final divide clamps l
// at 1e-30 (flash.py:69).  Causal masking compares positions that both
// start at 0 (query i sees keys j <= i, flash.py:44,55-57): prefill only.
// KV tiles wholly above the diagonal are not visited.
//
// What bounds it: at long prefills the operations (4 * Hq * D * Sq *
// (Sq + 1) / 2 flops causal), here float32 FMAs on the CUDA cores: four
// threads share a query row, each holding D/4 of q and of acc, the KV tile
// staged in shared memory as float32 and read as float4 broadcasts, the
// four partial dot products summed with warp shuffles.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 32;               // query rows per block
constexpr int LANES = 4;             // threads per query row
constexpr int THREADS = BQ * LANES;  // 128
constexpr float MASKED = -1e30f;

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
                 int Hq, int Hkv, int causal, float scale) {
  constexpr int V4 = D / (4 * LANES);  // float4 groups of q/acc per thread
  // keys per staged KV tile: 32, or 16 above D = 128, where 32 rows of K
  // and V would pass the 48 KB of static shared memory (D = 224: 28 KB)
  constexpr int BK = D > 128 ? 16 : 32;
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
      qr[g][c] = live ? q[qoff + d] * scale : 0.f;
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
        kx = k[off];
        vx = v[off];
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
      s[j] = expf(s[j] - m_new);
      psum += s[j];
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
        o[qoff + 16 * g + 4 * lane + c] = acc[g][c] / fmaxf(l, 1e-30f);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                   float scale, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<D><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, Hq, Hkv,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v and o float32.  Returns the launch's CUDA error code (0 on
// success); the wrapper checks every argument first.
extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, void* o, int B, int Sq,
                                       int Sk, int Hq, int Hkv, int D,
                                       int causal, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || Hq % Hkv != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, scale, s);
    case 32: return launch<32>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, scale, s);
    case 64: return launch<64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, scale, s);
    case 112: return launch<112>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, scale, s);
    case 128: return launch<128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, scale, s);
    case 224: return launch<224>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
