// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd/ssd.py:28 (_ssd_kernel,
// wrapper ssd_pallas).  That kernel walks a sequential grid (b, h, chunk)
// and carries the state [P, N] in VMEM scratch from chunk to chunk.  Here
// one block owns one (batch, head), loops over the chunks itself, and
// keeps the float32 state in shared memory (32 KB at P = 64, N = 128).
// Per chunk of L rows (ssd.py:44-62):
//
//   cum    = inclusive cumsum of dt * A
//   y[i]   = exp(cum_i) (C_i . state)                           inter-chunk
//          + sum_{j<=i} exp(cum_i - cum_j) dt_j (C_i . B_j) x_j  intra-chunk
//   state  = state exp(cum_L) + sum_j exp(cum_L - cum_j) dt_j x_j (x) B_j
//
// Shared memory: C of the chunk as float32 with a padded row stride (L x
// (N + 4): 132 KB at L = 256, N = 128), the state, and B and x streamed
// in tiles of 32 rows — B and C of a whole chunk in float32 would not fit
// beside the state in the 227 KB a block may have, and the [L, L] decay
// matrix is never staged.  One thread per chunk row i keeps y[i] (P
// floats) in registers; the intra-chunk weight exp(cum_i - cum_j) is taken
// only for j <= i (the upper triangle overflows, and inf * 0 would be
// NaN).  Each thread also owns P*N/256 state entries and accumulates their
// update in registers while the B and x tiles stream past.  A sequence
// that is not a multiple of L reads zeros past its end (dt = 0 there: the
// state is unchanged, as ssd_chunked's zero padding gives) and writes no y
// there.
//
// What bounds it: the operations, float32 on the CUDA cores (C.B^T is
// L^2/2 * N multiply-adds per chunk, the PV-like sum L^2/2 * P, the
// inter-chunk product and the state update L * P * N each, per head).
// This first version recomputes C.B^T for every head (the heads of one
// batch row share B and C) and runs B * H blocks: 32 at mamba2-370m with
// one sequence, on 132 SMs.  Splitting the chunks across blocks (the
// chunk states first, then the carry), wgmma for the products and TMA for
// the tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;  // one thread per chunk row: L <= 256
constexpr int TJ = 32;        // rows of B and x per streamed tile
constexpr int ST_MAX = 32;    // state entries per thread: P * N <= 8192
constexpr int CPAD = 4;       // C row padding (floats): 16-byte rows, banks shifted

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

__host__ __device__ constexpr size_t smem_floats(int L, int P, int N) {
  return (size_t)L * (N + CPAD) + (size_t)P * N + (size_t)TJ * (N + P) + 3 * (size_t)L;
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS, 1)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ init_state,
               T* __restrict__ y, float* __restrict__ final_state, int S,
               int H, int N, int L) {
  extern __shared__ __align__(16) float smem[];
  const int cs = N + CPAD;
  float* c_s = smem;                 // [L][cs]
  float* st_s = c_s + L * cs;        // [P][N]
  float* b_s = st_s + P * N;         // [TJ][N]
  float* x_s = b_s + TJ * N;         // [TJ][P]
  float* cum_s = x_s + TJ * P;       // [L]
  float* dt_s = cum_s + L;           // [L]
  float* end_s = dt_s + L;           // [L]  exp(cum_L - cum_j) dt_j

  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const float a = A[h];
  const int PN = P * N;
  const long long bh = (long long)b * H + h;
  for (int e = t; e < PN; e += THREADS)
    st_s[e] = init_state ? init_state[bh * PN + e] : 0.f;

  const int i = t;              // this thread's chunk row
  const bool row = i < L;
  const int nchunks = (S + L - 1) / L;
  for (int c = 0; c < nchunks; ++c) {
    const int s0 = c * L;
    __syncthreads();  // last chunk's state update and tile reads are done
    for (int r = t; r < L; r += THREADS) {
      const int si = s0 + r;
      dt_s[r] = si < S ? dt[((long long)b * S + si) * H + h] : 0.f;
    }
    for (int idx = t; idx < L * N; idx += THREADS) {
      const int r = idx / N, n = idx % N, si = s0 + r;
      c_s[r * cs + n] = si < S ? to_f(Cm[((long long)b * S + si) * N + n]) : 0.f;
    }
    __syncthreads();
    if (t == 0) {
      float run = 0.f;
      for (int r = 0; r < L; ++r) {
        run += dt_s[r] * a;
        cum_s[r] = run;
      }
    }
    __syncthreads();
    const float cum_end = cum_s[L - 1];
    for (int r = t; r < L; r += THREADS)
      end_s[r] = expf(cum_end - cum_s[r]) * dt_s[r];

    // inter-chunk term from the state entering the chunk
    float acc[P];
    const float cum_i = row ? cum_s[i] : 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = 0.f;
    if (row) {
      for (int n = 0; n < N; n += 4) {
        const float4 c4 = *reinterpret_cast<const float4*>(&c_s[i * cs + n]);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float4 s4 = *reinterpret_cast<const float4*>(&st_s[p * N + n]);
          acc[p] += c4.x * s4.x + c4.y * s4.y + c4.z * s4.z + c4.w * s4.w;
        }
      }
      const float e_i = expf(cum_i);
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] *= e_i;
    }

    float sacc[ST_MAX];
#pragma unroll
    for (int k = 0; k < ST_MAX; ++k) sacc[k] = 0.f;

    for (int j0 = 0; j0 < L; j0 += TJ) {
      __syncthreads();  // previous tile consumed (and end_s written)
      for (int idx = t; idx < TJ * N; idx += THREADS) {
        const int j = idx / N, n = idx % N, sj = s0 + j0 + j;
        b_s[idx] = (j0 + j < L && sj < S)
                       ? to_f(Bm[((long long)b * S + sj) * N + n]) : 0.f;
      }
      for (int idx = t; idx < TJ * P; idx += THREADS) {
        const int j = idx / P, p = idx % P, sj = s0 + j0 + j;
        x_s[idx] = (j0 + j < L && sj < S)
                       ? to_f(x[(((long long)b * S + sj) * H + h) * P + p]) : 0.f;
      }
      __syncthreads();
      const int jn = min(TJ, L - j0);

      // intra-chunk: rows i >= j0 see some j of this tile
      if (row && i >= j0) {
        float dot[TJ];
#pragma unroll
        for (int j = 0; j < TJ; ++j) dot[j] = 0.f;
        for (int n = 0; n < N; n += 4) {
          const float4 c4 = *reinterpret_cast<const float4*>(&c_s[i * cs + n]);
#pragma unroll
          for (int j = 0; j < TJ; ++j) {
            const float4 b4 = *reinterpret_cast<const float4*>(&b_s[j * N + n]);
            dot[j] += c4.x * b4.x + c4.y * b4.y + c4.z * b4.z + c4.w * b4.w;
          }
        }
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          const int jj = j0 + j;
          if (jj <= i) {  // i < L, so jj < L too
            const float w = dot[j] * expf(cum_i - cum_s[jj]) * dt_s[jj];
#pragma unroll
            for (int p = 0; p < P; p += 4) {
              const float4 x4 = *reinterpret_cast<const float4*>(&x_s[j * P + p]);
              acc[p] += w * x4.x;
              acc[p + 1] += w * x4.y;
              acc[p + 2] += w * x4.z;
              acc[p + 3] += w * x4.w;
            }
          }
        }
      }

      // state update of this thread's entries e = t + k * THREADS
#pragma unroll
      for (int k = 0; k < ST_MAX; ++k) {
        const int e = t + k * THREADS;
        if (e < PN) {
          const int p = e / N, n = e % N;
          float sum = sacc[k];
          for (int j = 0; j < jn; ++j)
            sum += end_s[j0 + j] * x_s[j * P + p] * b_s[j * N + n];
          sacc[k] = sum;
        }
      }
    }
    __syncthreads();  // every read of the entering state is done
    const float decay = expf(cum_end);
#pragma unroll
    for (int k = 0; k < ST_MAX; ++k) {
      const int e = t + k * THREADS;
      if (e < PN) st_s[e] = st_s[e] * decay + sacc[k];
    }
    if (row && s0 + i < S) {
      T* yo = y + (((long long)b * S + s0 + i) * H + h) * P;
#pragma unroll
      for (int p = 0; p < P; ++p) yo[p] = from_f<T>(acc[p]);
    }
  }
  __syncthreads();
  for (int e = t; e < PN; e += THREADS) final_state[bh * PN + e] = st_s[e];
}

template <typename T, int P>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* init_state,
                   void* y, void* final_state, int batch, int S, int H,
                   int N, int L, cudaStream_t stream) {
  const size_t bytes = smem_floats(L, P, N) * sizeof(float);
  auto kernel = ssd_fwd_kernel<T, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, batch), THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(init_state),
      static_cast<T*>(y), static_cast<float*>(final_state), S, H, N, L);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_p(int P, const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* init_state,
                       void* y, void* final_state, int batch, int S, int H,
                       int N, int L, cudaStream_t stream) {
  switch (P) {
    case 16: return launch<T, 16>(x, dt, A, Bm, Cm, init_state, y, final_state, batch, S, H, N, L, stream);
    case 32: return launch<T, 32>(x, dt, A, Bm, Cm, init_state, y, final_state, batch, S, H, N, L, stream);
    case 64: return launch<T, 64>(x, dt, A, Bm, Cm, init_state, y, final_state, batch, S, H, N, L, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of dynamic shared memory one block needs (the wrapper checks them
// against the card's per-block limit before launching).
extern "C" long long ssd_scan_smem_bytes(int P, int N, int L) {
  return (long long)(smem_floats(L, P, N) * sizeof(float));
}

// dtype: 0 float32, 1 bfloat16 (x, B, C and y alike; dt, A and the states
// are float32).  init_state may be null (zeros).  Returns the launch's CUDA
// error code (0 on success); the wrapper checks every argument first.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm,
                            const void* init_state, void* y,
                            void* final_state, int batch, int S, int H,
                            int P, int N, int L, int dtype, void* stream) {
  if (batch < 1 || S < 1 || H < 1 || L < 1 || L > THREADS || N < 4 ||
      N % 4 != 0 || P * N > THREADS * ST_MAX)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_p<float>(P, x, dt, A, Bm, Cm, init_state, y, final_state, batch, S, H, N, L, s);
  if (dtype == 1)
    return dispatch_p<__nv_bfloat16>(P, x, dt, A, Bm, Cm, init_state, y, final_state, batch, S, H, N, L, s);
  return cudaErrorInvalidValue;
}
