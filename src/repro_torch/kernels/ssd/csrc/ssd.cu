// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a),
// chunk-parallel in five stages.
//
// Replaces the TPU kernel src/repro/kernels/ssd/ssd.py:28 (_ssd_kernel,
// wrapper ssd_pallas).  That kernel walks a sequential grid (b, h, chunk)
// and carries the state [P, N] in VMEM from chunk to chunk.  On this card
// a walk per (batch, head) would give 32 blocks to 132 SMs at mamba2-370m,
// each doing its chunks in sequence.  Here the work is split as
// models.ssm.ssd_chunked splits it: everything that does not depend on
// the entering state is done for all chunks at once, and only a cheap
// elementwise carry runs in chunk order.  Per chunk of L rows
// (ssd.py:44-62):
//
//   cum    = inclusive cumsum of dt * A
//   y[i]   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j   intra
//          + exp(cum_i) (C_i . state_in)                          inter
//   state  = state_in exp(cum_L) + sum_j exp(cum_L - cum_j) dt_j x_j (x) B_j
//
// Each call launches five kernels on the current stream (the wrapper
// counts the call once):
//   1. ssd_cumsum_kernel: cum for each (b, h, chunk), one warp a row, a
//      shuffle scan;
//   2. ssd_cb_kernel: CB = C_c . B_c^T once per (b, group, chunk) for the
//      group's heads (they share its B and C), the lower 64 x 64 tiles of
//      [L, L]; bf16
//      on the tensor cores (mma.sync m16n8k16, float32 accumulate: the
//      products of bf16 values are exact in float32, only the order of
//      the sums changes), float32 on the CUDA cores;
//   3. ssd_states_kernel: the chunk states S_c [P, N], grid (b, chunk,
//      N-tile) x h (bf16: ssd_states_kernel_mma, grid (b, chunk) x h);
//   4. ssd_carry_kernel: for each (b, h) and float4 of the state, walk the
//      chunks in order: state_in[c] = carry (written over S_c), carry =
//      carry exp(cum_L[c]) + S_c; the last carry is the final state;
//   5. ssd_out_kernel: y for each (b, chunk, 64-row tile) x h, intra and
//      inter terms (bf16: ssd_out_kernel_mma, grid (b, chunk) x h).
// float32 inputs: stages 3 and 5 are float32 products on the CUDA cores,
// register-tiled: each thread owns a 4 x 4 output tile and reads two float4
// from shared memory per 16 multiply-adds (no TF32).
// bf16 inputs: stages 3 and 5 run on the tensor cores (mma.sync m16n8k16,
// float32 accumulate).  Each of their products has one operand exact in
// bf16 (x, B or C) and one float32 operand: the intra weights W_ij = CB_ij
// exp(cum_i - cum_j) dt_j, the entering state S_in (the carry's output)
// and w_j x_j with w_j = exp(cum_L - cum_j) dt_j.  The float32 operand is
// split once into hi = bf16(v) and lo = bf16(v - hi); v - hi is exact in
// float32, so hi + lo carries v to about 2^-16 relative, each bf16 x bf16
// product is exact in float32 and the sum stays float32: two products (hi
// and lo) into one accumulator give the float32 result to within the order
// of the sums, as flash_wgmma.cu splits p for P.V.  W and w x are formed in
// float32 as the CUDA-core stages form them, in registers, in the A
// fragment's layout; S_in is split into shared memory once a block; x and
// B are staged as they lie in memory (cp.async) and read transposed by
// ldmatrix.
// exp(cum_i - cum_j) is taken only for j <= i: above the diagonal it
// overflows, and inf * 0 would be NaN.  Rows past the sequence read as
// zeros (dt = 0 keeps the state, as ssd_chunked's zero padding gives) and
// write no y.
//
// B and C come in G groups, [b, S, G, N]: head h reads group h / (H / G)
// (Mamba2's ngroups; G = 1 is the [b, S, N] of one group).  The kernels
// take the groups as a template flag GR: with GR false (G = 1) every index
// folds to the one-group code.
//
// What bounds it on an H100 (80GB HBM3, 700 W): at mamba2-370m, [1, 4090,
// 32, 64], N 128, L 256, the products are 0.13 GFLOP of C.B^T and 6.4 GFLOP
// in stages 3 and 5.  On the CUDA cores (float32; bf16 inputs too, before
// the split) those took 0.54 ms of a 0.59 ms call.  In bf16 the split
// doubles them to about 13 GFLOP on the tensor cores (13 us at the bf16
// peak) and the call takes 0.15 ms: the output stage 0.076, bound by
// forming W in float32 (its exp, CB's loads and the diagonal's selects, one
// a kept pair and head; without its products the stage is 5% faster) and,
// for 20 us of it, by staging x and S_in (bytes); the states stage 0.031
// (its bytes alone 0.010), the C.B^T stage 0.017.  At 32,768 tokens the
// carry's walk over 128 chunks, 0.43 ms of 1.37, comes next.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int T64 = 64;   // rows of a CB / output tile
constexpr int JT = 32;    // rows (or n) per staged reduction tile
constexpr int PAD = 4;    // floats of row padding where a tile is written
                          // transposed (4-way instead of 32-way conflicts)

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

// acc[r][c] += a[r] * b[c] over a 4 x 4 tile (a, b float4 from shared)
__device__ __forceinline__ void mac4x4(float (&acc)[4][4], const float4 a,
                                       const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] += av[r] * bv[c];
}

__device__ __forceinline__ const float4& f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ---------------------------------------------------------------------------
// 1. cumsum: row r = (b * H + h) * nc + c of cum [b, H, nc, L]
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(128)
ssd_cumsum_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                  float* __restrict__ cum, int rows, int S, int H, int nc,
                  int L) {
  const int r = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= rows) return;
  const int c = r % nc, bh = r / nc, h = bh % H, b = bh / H;
  const float a = A[h];
  const int per = (L + 31) / 32, p0 = lane * per, s0 = c * L;
  float v[8];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int pos = p0 + e, si = s0 + pos;
    const float d = (e < per && pos < L && si < S)
                        ? dt[((long long)b * S + si) * H + h] : 0.f;
    run += d * a;
    v[e] = run;
  }
  float pre = run;  // inclusive scan of the lanes' totals
#pragma unroll
  for (int sh = 1; sh < 32; sh <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, pre, sh);
    if (lane >= sh) pre += o;
  }
  const float base = pre - run;
  float* out = cum + (long long)r * L;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < per && p0 + e < L) out[p0 + e] = base + v[e];
}

// ---------------------------------------------------------------------------
// 2. CB [b, nc, L, L] = C_c . B_c^T, lower 64 x 64 tiles only
// ---------------------------------------------------------------------------
constexpr int CB_THREADS = 256;
constexpr int KC = 64;          // n per staged chunk
constexpr int KPAD = KC + 8;    // bf16 row stride: conflict-free fragments

__device__ __forceinline__ void tri_tile(int t, int& ti, int& tj) {
  ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  tj = t - ti * (ti + 1) / 2;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; TRANS hands each thread a column pair
template <bool TRANS>
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  if constexpr (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)) : "memory");
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)) : "memory");
}

// BYTES (16 or 8) from global to shared memory, zeros where !ok (src is
// then not read)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 8 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) = hi + lo: hi = bf16(v), lo = bf16(v - hi), packed in pairs
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h)));
}

// a bf16 pair times (w0, w1) in float32, split
__device__ __forceinline__ void scale_split(uint32_t xv, float w0, float w1,
                                            uint32_t& hi, uint32_t& lo) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&xv));
  split2(v.x * w0, v.y * w1, hi, lo);
}

// d += (hi + lo) . b
__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4], uint32_t b0,
                                          uint32_t b1) {
  mma_bf16(d, hi, b0, b1);
  mma_bf16(d, lo, b0, b1);
}

template <typename T, bool GR>
__global__ void __launch_bounds__(CB_THREADS)
ssd_cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
              float* __restrict__ cb, int S, int N, int L, int nc, int ntri,
              int G) {
  // bc: chunk c of group g of batch row b, cb's [b, G, nc] index
  const int tri = blockIdx.x % ntri, bc = blockIdx.x / ntri;
  const int c = bc % nc, g = GR ? (bc / nc) % G : 0;
  const int b = GR ? bc / nc / G : bc / nc;
  const long long GN = GR ? (long long)G * N : N;
  if (GR) {
    Bm += (long long)g * N;
    Cm += (long long)g * N;
  }
  int ti, tj;
  tri_tile(tri, ti, tj);
  const int i0 = ti * T64, j0 = tj * T64, s0 = c * L;
  const int tid = threadIdx.x;
  float* out = cb + (long long)bc * L * L;
  // row r of a tile at chunk row t0 + r: its sequence row, or -1 if none
  auto seq = [&](int t0, int r) {
    const int i = t0 + r;
    return (i < L && s0 + i < S) ? s0 + i : -1;
  };

  if constexpr (sizeof(T) == 2) {
    __shared__ __align__(16) __nv_bfloat16 cs[T64][KPAD], bs[T64][KPAD];
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int wr = (warp % 4) * 16, wc = (warp / 4) * 32;  // warp's 16 x 32
    float acc[4][4] = {};
    for (int n0 = 0; n0 < N; n0 += KC) {
      __syncthreads();
      for (int e = tid; e < T64 * KC; e += CB_THREADS) {
        const int r = e / KC, k = e % KC, n = n0 + k;
        const int si = seq(i0, r), sj = seq(j0, r);
        const __nv_bfloat16 z = __float2bfloat16(0.f);
        cs[r][k] = (si >= 0 && n < N) ? Cm[((long long)b * S + si) * GN + n] : z;
        bs[r][k] = (sj >= 0 && n < N) ? Bm[((long long)b * S + sj) * GN + n] : z;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(&cs[wr + g][kk + 2 * t]);
        a[1] = *reinterpret_cast<const uint32_t*>(&cs[wr + g + 8][kk + 2 * t]);
        a[2] = *reinterpret_cast<const uint32_t*>(&cs[wr + g][kk + 8 + 2 * t]);
        a[3] = *reinterpret_cast<const uint32_t*>(&cs[wr + g + 8][kk + 8 + 2 * t]);
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8) {
          const int col = wc + 8 * n8 + g;
          mma_bf16(acc[n8], a,
                   *reinterpret_cast<const uint32_t*>(&bs[col][kk + 2 * t]),
                   *reinterpret_cast<const uint32_t*>(&bs[col][kk + 8 + 2 * t]));
        }
      }
    }
#pragma unroll
    for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + wr + g + 8 * (e / 2);
        const int j = j0 + wc + 8 * n8 + 2 * t + (e % 2);
        if (i < L && j < L) out[(long long)i * L + j] = acc[n8][e];
      }
  } else {
    __shared__ __align__(16) float ct[JT][T64 + PAD], bt[JT][T64 + PAD];
    const int tr = tid / 16, tc = tid % 16;
    float acc[4][4] = {};
    for (int n0 = 0; n0 < N; n0 += JT) {
      __syncthreads();
      for (int e = tid; e < T64 * JT; e += CB_THREADS) {
        const int r = e / JT, k = e % JT, n = n0 + k;
        const int si = seq(i0, r), sj = seq(j0, r);
        ct[k][r] = (si >= 0 && n < N) ? to_f(Cm[((long long)b * S + si) * GN + n]) : 0.f;
        bt[k][r] = (sj >= 0 && n < N) ? to_f(Bm[((long long)b * S + sj) * GN + n]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < JT; ++k)
        mac4x4(acc, f4(&ct[k][4 * tr]), f4(&bt[k][4 * tc]));
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + 4 * tr + r, j = j0 + 4 * tc + q;
        if (i < L && j < L) out[(long long)i * L + j] = acc[r][q];
      }
  }
}

// ---------------------------------------------------------------------------
// 3. chunk states st [b, H, nc, P, N]: S_c = sum_j w_j x_j (x) B_j
// ---------------------------------------------------------------------------
// The reduction over the chunk's rows runs in tiles of JT rows; the row
// weights w_j = exp(cum_L - cum_j) dt_j are taken once a row.
template <typename T, int P, bool GR>
__global__ void __launch_bounds__(128)
ssd_states_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const T* __restrict__ Bm, const float* __restrict__ cum,
                  float* __restrict__ st, int S, int H, int N, int L, int nc,
                  int ntile, int G) {
  constexpr int NT = 2048 / P;  // state columns per block
  __shared__ __align__(16) float xs[JT][P], bs[JT][NT];
  __shared__ float w_s[256];
  const int h = blockIdx.y, nt = blockIdx.x % ntile, bc = blockIdx.x / ntile;
  const int c = bc % nc, b = bc / nc, n0 = nt * NT, s0 = c * L;
  const int tid = threadIdx.x, tr = tid / (NT / 4), tc = tid % (NT / 4);
  const long long row = ((long long)b * H + h) * nc + c;
  const float* cr = cum + row * L;
  const int jn = min(L, S - s0);  // real rows of this chunk
  const float cum_end = cr[L - 1];
  for (int j = tid; j < jn; j += 128)
    w_s[j] = expf(cum_end - cr[j]) * dt[((long long)b * S + s0 + j) * H + h];
  const T* xb = x + (((long long)b * S + s0) * H + h) * P;  // row j: + j H P
  const long long GN = GR ? (long long)G * N : N;          // B's row
  const T* bb = Bm + ((long long)b * S + s0) * GN +
                (GR ? (long long)(h / (H / G)) * N : 0) + n0;  // row j: + j GN
  float acc[4][4] = {};
  for (int j0 = 0; j0 < jn; j0 += JT) {
    __syncthreads();  // last tile consumed (and w_s written)
#pragma unroll 4
    for (int e = tid; e < JT * P; e += 128) {
      const int j = e / P, jj = j0 + j;
      xs[j][e % P] = jj < jn ? to_f(xb[(long long)jj * H * P + e % P]) * w_s[jj]
                             : 0.f;
    }
#pragma unroll 4
    for (int e = tid; e < JT * NT; e += 128) {
      const int j = e / NT, k = e % NT, jj = j0 + j;
      bs[j][k] = (jj < jn && n0 + k < N) ? to_f(bb[(long long)jj * GN + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < JT; ++j)
      mac4x4(acc, f4(&xs[j][4 * tr]), f4(&bs[j][4 * tc]));
  }
  const int n = n0 + 4 * tc;
  if (n < N) {
    float* out = st + row * P * N;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(out + (long long)(4 * tr + r) * N + n) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// 3, bf16: S_c[p, n] = sum_j (w_j x_j[p]) B_j[n] on the tensor cores, one
// block a (b, chunk) x h.  A = (w o x)^T (float32, split), B = B's rows.
// Warp k takes 16 rows of p and 128 columns of n (8192 / P >= N columns in
// all); the chunk's rows come in stages of JK, double-buffered.
template <int P, bool GR>
__global__ void __launch_bounds__(128)
ssd_states_kernel_mma(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ dt,
                      const __nv_bfloat16* __restrict__ Bm,
                      const float* __restrict__ cum, float* __restrict__ st,
                      int S, int H, int N, int L, int nc, int G) {
  constexpr int WM = P / 16, NW = 128, NB = 4 / WM * NW;
  constexpr int JK = P == 16 ? 16 : 32;  // rows a stage (within 48 KB of shared)
  constexpr int XS = P + 8, BS = NB + 8;  // conflict-free ldmatrix rows
  __shared__ __align__(16) __nv_bfloat16 xs[2][JK][XS], bs[2][JK][BS];
  __shared__ float w_s[256];
  const int h = blockIdx.y, c = blockIdx.x % nc, b = blockIdx.x / nc;
  const int s0 = c * L, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int pw = (warp % WM) * 16, nw = (warp / WM) * NW;  // the warp's tile
  const long long row = ((long long)b * H + h) * nc + c;
  const float* cr = cum + row * L;
  const int jn = min(L, S - s0);  // real rows of this chunk
  const float cum_end = cr[L - 1];
  for (int j = tid; j < 256; j += 128)
    w_s[j] = j < jn ? expf(cum_end - cr[j]) * dt[((long long)b * S + s0 + j) * H + h]
                    : 0.f;
  const __nv_bfloat16* xb = x + (((long long)b * S + s0) * H + h) * P;  // + j H P
  const long long GN = GR ? (long long)G * N : N;                      // B's row
  const __nv_bfloat16* bb =
      Bm + ((long long)b * S + s0) * GN + (GR ? (long long)(h / (H / G)) * N : 0);
  const int nq = (N + 15) / 16 * 4;  // 4-column pieces of B's row, zeros past N
  auto stage = [&](int buf, int j0) {
    for (int e = tid; e < JK * P / 8; e += 128) {
      const int j = e / (P / 8), q = 8 * (e % (P / 8)), jj = j0 + j;
      cp_async<16>(&xs[buf][j][q], jj < jn ? xb + (long long)jj * H * P + q : xb,
                   jj < jn);
    }
    for (int e = tid; e < JK * nq; e += 128) {
      const int j = e / nq, n = 4 * (e % nq), jj = j0 + j;
      const bool ok = jj < jn && n < N;
      cp_async<8>(&bs[buf][j][n], ok ? bb + (long long)jj * GN + n : bb, ok);
    }
    cp_commit();
  };
  float acc[NW / 8][4] = {};
  stage(0, 0);
  for (int j0 = 0, buf = 0; j0 < jn; j0 += JK, buf ^= 1) {
    if (j0 + JK < jn) {
      stage(buf ^ 1, j0 + JK);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // the stage has landed (and w_s is written)
#pragma unroll
    for (int kk = 0; kk < JK; kk += 16) {
      // A[p][j] = x[j][p] w_j: x^T's fragment, then scaled and split
      uint32_t a[4], hi[4], lo[4];
      ldsm4<true>(a, &xs[buf][kk + lane % 8 + 8 * (lane / 16)][pw + 8 * (lane / 8 % 2)]);
      const int j = j0 + kk + 2 * t;
      scale_split(a[0], w_s[j], w_s[j + 1], hi[0], lo[0]);
      scale_split(a[1], w_s[j], w_s[j + 1], hi[1], lo[1]);
      scale_split(a[2], w_s[j + 8], w_s[j + 9], hi[2], lo[2]);
      scale_split(a[3], w_s[j + 8], w_s[j + 9], hi[3], lo[3]);
#pragma unroll
      for (int np = 0; np < NW / 16; ++np) {  // two 8-column tiles of n
        if (nw + 16 * np >= N) continue;
        uint32_t bq[4];
        ldsm4<true>(bq, &bs[buf][kk + lane % 8 + 8 * (lane / 8 % 2)]
                           [nw + 16 * np + 8 * (lane / 16)]);
        mma_split(acc[2 * np], hi, lo, bq[0], bq[1]);
        mma_split(acc[2 * np + 1], hi, lo, bq[2], bq[3]);
      }
    }
    __syncthreads();  // consumed before the next stage overwrites it
  }
  float* out = st + row * P * N;
#pragma unroll
  for (int nt = 0; nt < NW / 8; ++nt) {
    const int n = nw + 8 * nt + 2 * t;
    if (n >= N) continue;
    *reinterpret_cast<float2*>(out + (long long)(pw + g) * N + n) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(out + (long long)(pw + g + 8) * N + n) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ---------------------------------------------------------------------------
// 4. carry across chunks, in place: st[c] becomes the state entering c
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(128)
ssd_carry_kernel(float* __restrict__ st, const float* __restrict__ cum,
                 const float* __restrict__ init_state,
                 float* __restrict__ final_state, int PN, int nc, int L) {
  const int e = (blockIdx.x * 128 + threadIdx.x) * 4;
  const long long bh = blockIdx.y;
  if (e >= PN) return;
  float4 carry = init_state
                     ? *reinterpret_cast<const float4*>(init_state + bh * PN + e)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc; ++c) {
    float4* slot = reinterpret_cast<float4*>(st + (bh * nc + c) * PN + e);
    const float4 s = *slot;
    *slot = carry;
    const float d = expf(cum[(bh * nc + c) * L + L - 1]);
    carry = make_float4(carry.x * d + s.x, carry.y * d + s.y,
                        carry.z * d + s.z, carry.w * d + s.w);
  }
  *reinterpret_cast<float4*>(final_state + bh * PN + e) = carry;
}

// ---------------------------------------------------------------------------
// 5. y for one (b, chunk, 64-row tile) x h
// ---------------------------------------------------------------------------
// Two reductions in tiles of JT: the inter term over n (C rows, the
// entering state), then the intra term over the keys j <= i (weights from
// CB, x rows).  The chunk's cum and dt are staged once.
template <typename T, int P, bool GR>
__global__ void __launch_bounds__(4 * P)
ssd_out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const T* __restrict__ Cm, const float* __restrict__ cum,
               const float* __restrict__ cb, const float* __restrict__ st,
               T* __restrict__ y, int S, int H, int N, int L, int nc,
               int nrt, int G) {
  constexpr int THREADS = 4 * P;  // 16 x (P / 4) threads of 4 x 4
  __shared__ __align__(16) float sa[JT][T64 + PAD], sb[JT][P + PAD];
  __shared__ float cum_s[256], dt_s[256];
  const int h = blockIdx.y, rt = blockIdx.x % nrt, bc = blockIdx.x / nrt;
  const int c = bc % nc, b = bc / nc, s0 = c * L, i0 = rt * T64;
  const int jn = min(L, S - s0);  // real rows of this chunk
  if (i0 >= jn) return;
  const int in = min(T64, jn - i0);  // real rows of this tile
  const int tid = threadIdx.x, tr = tid / (P / 4), tc = tid % (P / 4);
  const long long row = ((long long)b * H + h) * nc + c;
  const float* state = st + row * P * N;
  const int g = GR ? h / (H / G) : 0;
  const long long GN = GR ? (long long)G * N : N;                    // C's row
  const float* cbc = cb + (GR ? (long long)(b * G + g) * nc + c : (long long)bc) *
                              L * L + (long long)i0 * L;             // tile rows
  const T* cm = Cm + ((long long)b * S + s0 + i0) * GN + (GR ? (long long)g * N : 0);
  const T* xb = x + (((long long)b * S + s0) * H + h) * P;           // + j H P
  const int j_end = i0 + in;  // keys this tile's rows can see
  for (int j = tid; j < j_end; j += THREADS) {
    cum_s[j] = cum[row * L + j];
    dt_s[j] = dt[((long long)b * S + s0 + j) * H + h];
  }

  // inter: C_i . state_in, over n in tiles of JT
  float inter[4][4] = {}, intra[4][4] = {};
  for (int n0 = 0; n0 < N; n0 += JT) {
    __syncthreads();
#pragma unroll 4
    for (int e = tid; e < T64 * JT; e += THREADS) {
      const int r = e / JT, k = e % JT;
      sa[k][r] = (r < in && n0 + k < N) ? to_f(cm[(long long)r * GN + n0 + k]) : 0.f;
    }
#pragma unroll 4
    for (int e = tid; e < P * JT; e += THREADS) {
      const int p = e / JT, k = e % JT;
      sb[k][p] = n0 + k < N ? state[(long long)p * N + n0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < JT; ++k)
      mac4x4(inter, f4(&sa[k][4 * tr]), f4(&sb[k][4 * tc]));
  }

  // intra: sum over j <= i of CB_ij exp(cum_i - cum_j) dt_j x_j
  for (int j0 = 0; j0 < j_end; j0 += JT) {
    __syncthreads();
#pragma unroll 4
    for (int e = tid; e < T64 * JT; e += THREADS) {
      const int r = e / JT, j = e % JT, jj = j0 + j;
      // the exponential only for j <= i (above it overflows; inf * 0 = NaN)
      sa[j][r] = (r < in && jj <= i0 + r)
                     ? cbc[(long long)r * L + jj] * expf(cum_s[i0 + r] - cum_s[jj]) *
                           dt_s[jj]
                     : 0.f;
    }
#pragma unroll 4
    for (int e = tid; e < JT * P; e += THREADS) {
      const int j = e / P, jj = j0 + j;
      sb[j][e % P] = jj < jn ? to_f(xb[(long long)jj * H * P + e % P]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < JT; ++j)
      mac4x4(intra, f4(&sa[j][4 * tr]), f4(&sb[j][4 * tc]));
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 4 * tr + r;
    if (i >= in) continue;
    const float ei = expf(cum_s[i0 + i]);
    T* yo = y + (((long long)b * S + s0 + i0 + i) * H + h) * P + 4 * tc;
#pragma unroll
    for (int q = 0; q < 4; ++q) yo[q] = from_f<T>(intra[r][q] + ei * inter[r][q]);
  }
}

// 5, bf16: y for one (b, chunk) x h on the tensor cores.  The chunk's x
// rows (as they lie in memory) and S_in (split into s_hi + s_lo) are staged
// once into shared memory, behind one barrier; then each warp computes its
// 16-row slabs on its own: slab w and slab 15 - w of warp w, whose key
// counts add up alike.  Inter: A = C's rows, B = S_in.  Intra: A = W
// (float32, formed and split in registers), B = x's rows.  C's and CB's
// values are loaded a step ahead.
template <int P>
struct OutMma {
  static constexpr int SS = 8192 / P + 8;  // s_hi / s_lo row: the widest state
  static constexpr int XS = P + 8;         // x row (conflict-free ldmatrix)
  static constexpr int SMEM = 2 * P * SS * 2 + 256 * XS * 2 + 2 * 256 * 4;
};

template <int P, bool GR>
__global__ void __launch_bounds__(256, 2)
ssd_out_kernel_mma(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ dt,
                   const __nv_bfloat16* __restrict__ Cm,
                   const float* __restrict__ cum, const float* __restrict__ cb,
                   const float* __restrict__ st, __nv_bfloat16* __restrict__ y,
                   int S, int H, int N, int L, int nc, int G) {
  constexpr int SS = OutMma<P>::SS, XS = OutMma<P>::XS, NP = P / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  auto s_hi = reinterpret_cast<__nv_bfloat16(*)[SS]>(smem);
  auto s_lo = s_hi + P;
  auto xs = reinterpret_cast<__nv_bfloat16(*)[XS]>(s_lo + P);
  float* cum_s = reinterpret_cast<float*>(xs + 256);
  float* dt_s = cum_s + 256;
  const int h = blockIdx.y, c = blockIdx.x % nc, b = blockIdx.x / nc;
  const int s0 = c * L, jn = min(L, S - s0);  // real rows of this chunk
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long row = ((long long)b * H + h) * nc + c;
  const float* state = st + row * P * N;
  const int gr = GR ? h / (H / G) : 0;
  const long long GN = GR ? (long long)G * N : N;  // C's row
  const float* cbc =
      cb + (GR ? (long long)(b * G + gr) * nc + c : (long long)blockIdx.x) * L * L;
  const __nv_bfloat16* cm =
      Cm + ((long long)b * S + s0) * GN + (GR ? (long long)gr * N : 0);
  const __nv_bfloat16* xb = x + (((long long)b * S + s0) * H + h) * P;  // + j H P
  const int slabs = (jn + 15) / 16;
  // x's rows, zeros to the last slab's end
  for (int e = tid; e < 16 * slabs * (P / 8); e += 256) {
    const int j = e / (P / 8), q = 8 * (e % (P / 8));
    cp_async<16>(&xs[j][q], j < jn ? xb + (long long)j * H * P + q : xb, j < jn);
  }
  cp_commit();
  for (int j = tid; j < jn; j += 256) {
    cum_s[j] = cum[row * L + j];
    dt_s[j] = dt[((long long)b * S + s0 + j) * H + h];
  }
  // S_in split, s_hi + s_lo; zeros for n from N to a multiple of 16
  const int NK = (N + 15) / 16 * 16;
#pragma unroll 4
  for (int e = tid; e < P * NK / 4; e += 256) {
    const int p = e / (NK / 4), n = 4 * (e % (NK / 4));
    const float4 v = n < N ? f4(state + (long long)p * N + n)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    uint2 hi, lo;
    split2(v.x, v.y, hi.x, lo.x);
    split2(v.z, v.w, hi.y, lo.y);
    *reinterpret_cast<uint2*>(&s_hi[p][n]) = hi;
    *reinterpret_cast<uint2*>(&s_lo[p][n]) = lo;
  }
  cp_wait<0>();
  __syncthreads();

  // C's pair (n, n + 1) of chunk row i as one word, zeros past the rows and N
  auto c2 = [&](int i, int n) -> uint32_t {
    return i < jn && n < N ? *reinterpret_cast<const uint32_t*>(cm + (long long)i * GN + n)
                           : 0u;
  };
  // W_ij = CB_ij exp(cum_i - cum_j) dt_j is kept for j <= i < jn only (the
  // exponential above the diagonal overflows; inf * 0 = NaN)
  auto kept = [&](int i, int j) { return i < jn && j <= i; };
  for (int half = 0; half < 2; ++half) {
    const int slab = half ? 15 - warp : warp;
    if (slab >= slabs) continue;
    const int ia = 16 * slab + g, ib = ia + 8;  // the thread's chunk rows
    float inter[NP][4] = {}, intra[NP][4] = {};
    uint32_t an[4] = {c2(ia, 2 * t), c2(ib, 2 * t), c2(ia, 2 * t + 8), c2(ib, 2 * t + 8)};
    for (int n0 = 0; n0 < NK; n0 += 16) {  // inter: C_i . S_in
      const uint32_t a[4] = {an[0], an[1], an[2], an[3]};
      const int n = n0 + 16 + 2 * t;  // the next step's (zeros past N)
      an[0] = c2(ia, n), an[1] = c2(ib, n), an[2] = c2(ia, n + 8), an[3] = c2(ib, n + 8);
#pragma unroll
      for (int pp = 0; pp < NP / 2; ++pp) {
        uint32_t bh[4], bl[4];
        const int pr = 16 * pp + lane % 8 + 8 * (lane / 16), nc8 = n0 + 8 * (lane / 8 % 2);
        ldsm4<false>(bh, &s_hi[pr][nc8]);
        ldsm4<false>(bl, &s_lo[pr][nc8]);
        mma_bf16(inter[2 * pp], a, bh[0], bh[1]);
        mma_bf16(inter[2 * pp], a, bl[0], bl[1]);
        mma_bf16(inter[2 * pp + 1], a, bh[2], bh[3]);
        mma_bf16(inter[2 * pp + 1], a, bl[2], bl[3]);
      }
    }
    // intra: sum over j <= i of W_ij x_j, k-steps of 16 keys up to the slab's
    // own; e's bits pick the fragment's element: key + 1, row + 8, key + 8
    auto load_cb = [&](int k, float (&v)[8]) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = e & 2 ? ib : ia, j = 16 * k + 2 * t + (e & 1) + (e & 4 ? 8 : 0);
        v[e] = kept(i, j) ? cbc[(long long)i * L + j] : 0.f;
      }
    };
    float cbn[8];
    load_cb(0, cbn);
    for (int k = 0; k <= slab; ++k) {
      float w[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) w[e] = cbn[e];
      load_cb(k + 1, cbn);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = e & 2 ? ib : ia, j = 16 * k + 2 * t + (e & 1) + (e & 4 ? 8 : 0);
        w[e] = kept(i, j) ? w[e] * expf(cum_s[i] - cum_s[j]) * dt_s[j] : 0.f;
      }
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) split2(w[2 * q], w[2 * q + 1], hi[q], lo[q]);
#pragma unroll
      for (int pp = 0; pp < NP / 2; ++pp) {
        uint32_t bq[4];
        ldsm4<true>(bq, &xs[16 * k + lane % 8 + 8 * (lane / 8 % 2)]
                           [16 * pp + 8 * (lane / 16)]);
        mma_split(intra[2 * pp], hi, lo, bq[0], bq[1]);
        mma_split(intra[2 * pp + 1], hi, lo, bq[2], bq[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // y = intra + exp(cum_i) inter, rows ia, ib
      const int i = r ? ib : ia;
      if (i >= jn) continue;
      const float ei = expf(cum_s[i]);
      __nv_bfloat16* yo = y + (((long long)b * S + s0 + i) * H + h) * P + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NP; ++nt) {
        const float* e = intra[nt] + 2 * r;
        const float* f = inter[nt] + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(yo + 8 * nt) =
            __floats2bfloat162_rn(e[0] + ei * f[0], e[1] + ei * f[1]);
      }
    }
  }
}

// The output stage's dynamic shared memory beyond 48 KB, allowed once a
// device, at its first call (a prefill graph's warm-ups run before its
// capture).
template <int P, bool GR>
cudaError_t allow_out_smem() {
  static std::atomic<unsigned> done{0};  // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (done.load() >> dev & 1u))) return err;
  err = cudaFuncSetAttribute(ssd_out_kernel_mma<P, GR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             OutMma<P>::SMEM);
  if (err == cudaSuccess && dev < 32) done.fetch_or(1u << dev);
  return err;
}

template <typename T, int P, bool GR>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* init_state,
                   void* y, void* final_state, float* cum, float* cb,
                   float* st, int batch, int S, int H, int N, int L, int G,
                   cudaStream_t stream) {
  const int nc = (S + L - 1) / L, t64 = (L + T64 - 1) / T64;
  const int rows = batch * H * nc;
  ssd_cumsum_kernel<<<(rows + 3) / 4, 128, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(A), cum, rows,
      S, H, nc, L);
  const int ntri = t64 * (t64 + 1) / 2;
  ssd_cb_kernel<T, GR><<<batch * G * nc * ntri, CB_THREADS, 0, stream>>>(
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), cb, S, N, L, nc,
      ntri, G);
  if constexpr (sizeof(T) == 2) {
    ssd_states_kernel_mma<P, GR><<<dim3(batch * nc, H), 128, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt),
        static_cast<const T*>(Bm), cum, st, S, H, N, L, nc, G);
  } else {
    constexpr int NT = 2048 / P;
    const int ntile = (N + NT - 1) / NT;
    ssd_states_kernel<T, P, GR><<<dim3(batch * nc * ntile, H), 128, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt),
        static_cast<const T*>(Bm), cum, st, S, H, N, L, nc, ntile, G);
  }
  const int PN = P * N;
  ssd_carry_kernel<<<dim3((PN / 4 + 127) / 128, batch * H), 128, 0, stream>>>(
      st, cum, static_cast<const float*>(init_state),
      static_cast<float*>(final_state), PN, nc, L);
  if constexpr (sizeof(T) == 2) {
    const cudaError_t err = allow_out_smem<P, GR>();
    if (err != cudaSuccess) return err;
    ssd_out_kernel_mma<P, GR><<<dim3(batch * nc, H), 256, OutMma<P>::SMEM, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt),
        static_cast<const T*>(Cm), cum, cb, st, static_cast<T*>(y), S, H, N, L,
        nc, G);
  } else {
    ssd_out_kernel<T, P, GR><<<dim3(batch * nc * t64, H), 4 * P, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt),
        static_cast<const T*>(Cm), cum, cb, st, static_cast<T*>(y), S, H, N, L,
        nc, t64, G);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_p(int P, const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* init_state,
                       void* y, void* final_state, float* cum, float* cb,
                       float* st, int batch, int S, int H, int N, int L,
                       int G, cudaStream_t stream) {
  if (G > 1) {
    switch (P) {
      case 16: return launch<T, 16, true>(x, dt, A, Bm, Cm, init_state, y, final_state, cum, cb, st, batch, S, H, N, L, G, stream);
      case 32: return launch<T, 32, true>(x, dt, A, Bm, Cm, init_state, y, final_state, cum, cb, st, batch, S, H, N, L, G, stream);
      case 64: return launch<T, 64, true>(x, dt, A, Bm, Cm, init_state, y, final_state, cum, cb, st, batch, S, H, N, L, G, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (P) {
    case 16: return launch<T, 16, false>(x, dt, A, Bm, Cm, init_state, y, final_state, cum, cb, st, batch, S, H, N, L, 1, stream);
    case 32: return launch<T, 32, false>(x, dt, A, Bm, Cm, init_state, y, final_state, cum, cb, st, batch, S, H, N, L, 1, stream);
    case 64: return launch<T, 64, false>(x, dt, A, Bm, Cm, init_state, y, final_state, cum, cb, st, batch, S, H, N, L, 1, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, B, C and y alike; dt, A and the states
// are float32).  B and C [batch, S, G, N], G dividing H.  init_state may be
// null (zeros).  Scratch, float32, from the wrapper: cum [batch, H, nc, L],
// cb [batch, G, nc, L, L] and st [batch, H, nc, P, N], nc = ceil(S / L).
// Returns the first launch error's CUDA code (0 on success); the wrapper
// checks every argument first.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm,
                            const void* init_state, void* y,
                            void* final_state, void* cum, void* cb, void* st,
                            int batch, int S, int H, int P, int N, int L,
                            int dtype, int G, void* stream) {
  if (batch < 1 || S < 1 || H < 1 || L < 1 || L > 256 || N < 4 ||
      N % 4 != 0 || P * N > 8192 || G < 1 || H % G != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *c = static_cast<float*>(cum), *w = static_cast<float*>(cb),
        *t = static_cast<float*>(st);
  if (dtype == 0)
    return dispatch_p<float>(P, x, dt, A, Bm, Cm, init_state, y, final_state, c, w, t, batch, S, H, N, L, G, s);
  if (dtype == 1)
    return dispatch_p<__nv_bfloat16>(P, x, dt, A, Bm, Cm, init_state, y, final_state, c, w, t, batch, S, H, N, L, G, s);
  return cudaErrorInvalidValue;
}
