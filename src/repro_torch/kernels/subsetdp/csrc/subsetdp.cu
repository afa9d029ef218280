// Eq. (10) subset-DP for Hopper (sm_90a): the exhaustive cache-selection
// subroutine evaluated for every subset mask of a batch of rho rows.
//
// Replaces the TPU kernel src/repro/kernels/subsetdp/subsetdp.py
// (_subsetdp_kernel, launched by _subset_prod_jit) together with the jitted
// masked argmin that consumed its [B, 2^n] output (src/repro/kernels/
// subsetdp/ops.py, _masked_argmin).
//
// Two entry points, both with a plain C interface (loaded through ctypes):
//   subsetdp_prod   out[b, m]  = M_b * prod_{j in m, ascending j} rho[b, j]
//                   -- the exact counterpart of the Pallas kernel;
//   subsetdp_argmin out[b]     = argmin_m (cost[m] + out[b, m]) over the
//                   masks m with (m & ~allowed[b]) == 0, lowest m among
//                   equal minima -- fused, so the [B, 2^n] matrix never
//                   reaches device memory.
//
// Exactness.  The simulator's golden results are bit-exact, so every lane
// must reproduce the scalar enumeration's IEEE operation chain: start from
// M, multiply by rho_j for each set bit in ASCENDING j (__dmul_rn), then one
// add cost[m] + prod (__dadd_rn).  The _rn intrinsics are never contracted
// into an FMA, and the build also passes --fmad=false; one FMA would move a
// value by an ulp and fail the tobytes() gate.  Exact ties are common (all
// caches share one view at the first view version; equal costs tie whole
// subset sizes), so the reduction compares (value, mask) lexicographically.
//
// Bound.  The work a row needs is one multiply per mask (a subset's product
// is the product of the subset without its highest bit times one rho, which
// keeps the ascending order: 2^n - 1 multiplies), one add and one compare:
// about 3 * 2^n fp64 operations over n * 8 bytes read (the rho row; 8 more
// for ``allowed``) and 8 bytes written.  At n = 8 without ``allowed`` that
// is 767 operations over 72 bytes, about 10.7 per byte, just above the
// H100's fp64 ridge (34 TFLOP/s over 3.35 TB/s, about 10 per byte), so the
// fp64 rate bounds it barely; with CS_FNO's ``allowed`` only the subsets of
// the row's own pattern count (3^8 / 2^8, about 26 masks per row on
// average over all patterns), and the bytes bound it.  This first design keeps
// everything in registers and shared memory: one warp per row (grid-stride
// over rows), the row's rho values staged once in shared memory, lanes walk
// masks lane, lane + 32, ..., skipping denied masks, and a shuffle reduction
// ends the row.  No HBM traffic beyond inputs and outputs, but each mask's
// product chain is recomputed (n * 2^(n-1) multiplies instead of 2^n - 1)
// and a lane whose masks are all denied idles -- prefix reuse and packing
// several rows per warp are later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxN = 16;
constexpr int kMaxBlocks = 132 * 32;   // grid-stride beyond this

__device__ __forceinline__ double lane_prod(double p, const double* r,
                                            int n, long long m) {
  for (int j = 0; j < n; ++j) {
    if ((m >> j) & 1LL) p = __dmul_rn(p, r[j]);
  }
  return p;
}

__global__ void __launch_bounds__(kThreads)
subset_prod_kernel(const double* __restrict__ rhos,
                   const double* __restrict__ mp, long long mp_stride,
                   double* __restrict__ out, long long rows, int n) {
  __shared__ double s_rho[kWarpsPerBlock][kMaxN];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long k = 1LL << n;
  const long long step = (long long)gridDim.x * kWarpsPerBlock;
  for (long long b = (long long)blockIdx.x * kWarpsPerBlock + warp;
       b < rows; b += step) {
    if (lane < n) s_rho[warp][lane] = rhos[b * n + lane];
    __syncwarp();
    const double m0 = mp[b * mp_stride];
    double* row = out + b * k;
    for (long long m = lane; m < k; m += 32) {
      row[m] = lane_prod(m0, s_rho[warp], n, m);
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
subset_argmin_kernel(const double* __restrict__ cost,
                     const double* __restrict__ rhos,
                     const double* __restrict__ mp, long long mp_stride,
                     const long long* __restrict__ allowed,
                     long long* __restrict__ out, long long rows, int n) {
  __shared__ double s_rho[kWarpsPerBlock][kMaxN];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long k = 1LL << n;
  const long long step = (long long)gridDim.x * kWarpsPerBlock;
  for (long long b = (long long)blockIdx.x * kWarpsPerBlock + warp;
       b < rows; b += step) {
    if (lane < n) s_rho[warp][lane] = rhos[b * n + lane];
    __syncwarp();
    const double m0 = mp[b * mp_stride];
    const long long deny = allowed == nullptr ? 0LL : ~allowed[b];
    double best = CUDART_INF;
    long long best_m = k;              // sentinel above every real mask
    // masks ascend within a lane, so a strict < keeps the lowest mask
    for (long long m = lane; m < k; m += 32) {
      if (m & deny) continue;
      const double phi = __dadd_rn(cost[m], lane_prod(m0, s_rho[warp], n, m));
      if (phi < best) {
        best = phi;
        best_m = m;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const double ov = __shfl_down_sync(0xffffffffu, best, off);
      const long long om = __shfl_down_sync(0xffffffffu, best_m, off);
      if (ov < best || (ov == best && om < best_m)) {
        best = ov;
        best_m = om;
      }
    }
    if (lane == 0) out[b] = best_m;
    __syncwarp();
  }
}

int grid_for(long long rows) {
  long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).  Callers
// guarantee rows >= 1, 1 <= n <= 16, contiguous float64/int64 buffers on
// the current device, and mp_stride in {0, 1}.
int subsetdp_prod(const void* rhos, const void* mp, long long mp_stride,
                  void* out, long long rows, int n, void* stream) {
  subset_prod_kernel<<<grid_for(rows), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(rhos), static_cast<const double*>(mp),
      mp_stride, static_cast<double*>(out), rows, n);
  return static_cast<int>(cudaGetLastError());
}

// ``allowed`` may be null (every mask allowed).
int subsetdp_argmin(const void* cost, const void* rhos, const void* mp,
                    long long mp_stride, const void* allowed, void* out,
                    long long rows, int n, void* stream) {
  subset_argmin_kernel<<<grid_for(rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(cost), static_cast<const double*>(rhos),
      static_cast<const double*>(mp), mp_stride,
      static_cast<const long long*>(allowed), static_cast<long long*>(out),
      rows, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
