// Eq. (10) subset-DP for Hopper (sm_90a): the exhaustive cache-selection
// subroutine evaluated for every subset mask of a batch of rho rows.
//
// Replaces the TPU kernel src/repro/kernels/subsetdp/subsetdp.py:41
// (_subsetdp_kernel, launched by _subset_prod_jit) together with the jitted
// masked argmin that consumed its [B, 2^n] output (src/repro/kernels/
// subsetdp/ops.py:90, _masked_argmin).
//
// Two entry points, both with a plain C interface (loaded through ctypes):
//   subsetdp_prod   out[b, m]  = M_b * prod_{j in m, ascending j} rho[b, j]
//                   -- the exact counterpart of the Pallas kernel;
//   subsetdp_argmin out[b]     = argmin_m (cost[m] + out[b, m]) over the
//                   masks m with (m & ~allowed[b]) == 0, lowest m among
//                   equal minima -- fused, so the [B, 2^n] matrix never
//                   reaches device memory.
//
// Exactness.  The simulator's golden results are bit-exact, so every mask
// must reproduce the scalar enumeration's IEEE operation chain: start from
// M, multiply by rho_j for each set bit in ASCENDING j (__dmul_rn), then one
// add cost[m] + prod (__dadd_rn).  The _rn intrinsics are never contracted
// into an FMA, and the build also passes --fmad=false; one FMA would move a
// value by an ulp and fail the tobytes() gate.  Exact ties are common (all
// caches share one view at the first view version; equal costs tie whole
// subset sizes), and the walk below does not visit masks in ascending
// order, so every comparison is lexicographic on (value, mask).
//
// Bound.  A row needs one multiply per non-empty mask and one add per mask
// (the compare runs beside them, and since every value is >= 0 it could
// run on the integer pipe, so the bound leaves it out).  With the FMA
// forbidden each is one fp64 instruction: 132 SMs x 64 fp64 lanes x 1.98
// GHz = 16.7e12 a second, half the data sheet's 34 TFLOP/s, which counts
// an FMA as two.  Inputs are the n rho values of a row (8 bytes each), M,
// ``allowed`` and the 2^n costs, read once, and one int64 written a row.
// The paper-scale fna table (3,188,480 rows at n = 8, 1.63e9 operations,
// 255 MB) is operations-bound at 0.0974 ms; the fno table (``allowed`` =
// each row's own pattern: 81.7M allowed masks) is bytes-bound at 0.0761
// ms (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's argmin_work).
//
// Design.
//   * One multiply per mask, ascending order kept: prod(m) = prod(m
//     without its highest set bit) * rho[that bit].  The masks are walked
//     depth first over the bits, the lowest bit decided first, each node's
//     product held for its subtree (at most n partial products live).
//   * n <= kThreadMaxN (the main path's n = 8): a row per thread, the walk
//     a template on n, fully unrolled, so every mask is a compile-time
//     constant.  The 2^n costs travel as a kernel parameter (constant
//     bank), so cost[m] is a constant-bank operand of the add: no load,
//     and one broadcast for the whole warp.  Rows are staged through shared
//     memory by the block with coalesced loads (an odd row stride keeps the
//     64-bit reads free of bank conflicts); no shuffles, no __syncwarp.
//     The compare: groups of 2^3 masks that ascend (a strict compare), one
//     lexicographic merge a group.  With ``allowed``, a warp walks only the
//     masks inside the union of its 32 rows' allowed sets (warp-uniform
//     branches): 2^popcount(allowed) masks a row when neighbouring rows
//     share their allowed set, as the table builders lay them out
//     (core/batched.py, _exhaustive_rows).  Rows by pattern would cost
//     the union of 32 patterns, about four times as many.
//   * kThreadMaxN < n <= kMaxN: a warp per row.  Lane l owns the masks
//     whose low five bits are l, takes their prefix product once, and walks
//     the high bits depth first with the same one-multiply reuse; a
//     lexicographic shuffle reduction ends the row.  subsetdp_prod uses the
//     same walk for every n, each lane storing its masks' products: the 32
//     lanes of a store write 32 consecutive doubles.
//
// Measured by chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W): fna 0.2935 ms,
// 3.0x its bound (about nine instructions a mask issue: the multiply, the
// add, the cost's uniform load, the compare and the selects it feeds);
// fno 0.1275 ms, 1.7x its bytes bound, on rows laid out by pattern.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxN = 16;
// largest n walked a row per thread, fully unrolled (ops.py names it
// UNROLL_MAX_N, beside MAX_N)
constexpr int kThreadMaxN = 8;
constexpr int kLowBits = 5;                    // lanes of a warp = 2^5
constexpr int kMaxHighBits = kMaxN - kLowBits;
constexpr int kRowThreads = 128;               // rows a block stages at once
constexpr int kWarpThreads = 256;
constexpr int kWarps = kWarpThreads / 32;
constexpr int kMaxBlocks = 1 << 20;           // grid-stride beyond this

struct CostTable {
  double v[1 << kThreadMaxN];
};

// Lexicographic (value, mask) minimum.
struct Best {
  double v;
  unsigned m;
  __device__ __forceinline__ void offer(double phi, unsigned mask) {
    if (phi < v || (phi == v && mask < m)) {
      v = phi;
      m = mask;
    }
  }
  // the same, only when ``ok``: one predicate, no branch
  __device__ __forceinline__ void offer_if(bool ok, double phi,
                                           unsigned mask) {
    const bool better = ok & ((phi < v) | ((phi == v) & (mask < m)));
    v = better ? phi : v;
    m = better ? mask : m;
  }
};

// ---- a row per thread (n <= kThreadMaxN) ---------------------------------
//
// The n bits split into L = n - H low bits, walked depth first and fully
// unrolled, and the H = min(3, n) top bits.
//
// Without ``allowed``, every node M of the low walk (the root too) owns the
// group of masks M | s << L, s = 0 .. 2^H - 1, whose products follow from
// M's, one multiply each, s's bits ascending after M's.  Within a group the
// masks ascend with s, so a strict compare keeps the lowest; each group's
// winner then merges into the row's best lexicographically.
//
// With ``allowed``, the top patterns s are an outer loop instead (not
// unrolled, so the code stays small) over those that the union of the
// warp's 32 rows' allowed sets holds (``uni``, warp-uniform), and each
// pattern's low walk skips the low bits no row of the warp allows; mask
// M | s << L takes its product from M's, times s's rho values in ascending
// order, and every compare is lexicographic.  A row still drops the masks
// it does not allow: a node outside its low bits, a top pattern outside
// its own.

__host__ __device__ constexpr int top_bit(unsigned s) {
  int b = -1;
  while (s != 0) {
    s >>= 1;
    ++b;
  }
  return b;
}

template <int N>
struct Split {
  static constexpr int H = N < 3 ? N : 3;
  static constexpr int L = N - H;
  static constexpr unsigned kTop = (1u << H) - 1;
};

template <int N>
struct Row {
  double r[N];
  unsigned allowed;
};

// Without ``allowed``: node M's group.
template <int N, unsigned M>
__device__ __forceinline__ void group(const Row<N>& row, double p,
                                      const CostTable& c, Best& best) {
  constexpr int L = Split<N>::L;
  double q[Split<N>::kTop + 1];
  q[0] = p;
  double gv = __dadd_rn(c.v[M], p);
  unsigned gm = M;
#pragma unroll
  for (int s = 1; s <= (int)Split<N>::kTop; ++s) {
    const int hb = top_bit(s);
    q[s] = __dmul_rn(q[s ^ (1 << hb)], row.r[L + hb]);
    const double phi = __dadd_rn(c.v[M | (s << L)], q[s]);
    const bool take = phi < gv;
    gv = take ? phi : gv;
    gm = take ? (M | (s << L)) : gm;
  }
  if constexpr (M == 0) {
    best.v = gv;
    best.m = gm;
  } else {
    best.offer(gv, gm);
  }
}

// Without ``allowed``: every subset of the low bits >= B added to node M
// (product p), first the subtree that includes bit B, then the other.
template <int N, int B, unsigned M>
__device__ __forceinline__ void walk(const Row<N>& row, double p,
                                     const CostTable& c, Best& best) {
  if constexpr (B < Split<N>::L) {
    constexpr unsigned MC = M | (1u << B);
    const double q = __dmul_rn(p, row.r[B]);
    group<N, MC>(row, q, c, best);
    walk<N, B + 1, MC>(row, q, c, best);
    walk<N, B + 1, M>(row, p, c, best);
  }
}

// With ``allowed``: mask M | s << L from node M's product p; ``ok`` when
// the row allows it.
template <int N, unsigned M>
__device__ __forceinline__ void visit(const Row<N>& row, double p, unsigned s,
                                      bool ok, const CostTable& c,
                                      Best& best) {
  constexpr int L = Split<N>::L;
#pragma unroll
  for (int j = 0; j < Split<N>::H; ++j) {
    if ((s >> j) & 1u) p = __dmul_rn(p, row.r[L + j]);
  }
  const unsigned m = M | (s << L);
  best.offer_if(ok, __dadd_rn(c.v[m], p), m);
}

// With ``allowed``: the low walk for one top pattern s, entering only the
// low bits some row of the warp allows (``uni``).
template <int N, int B, unsigned M>
__device__ __forceinline__ void walk_allowed(const Row<N>& row, double p,
                                             unsigned uni, unsigned s,
                                             bool ok, const CostTable& c,
                                             Best& best) {
  if constexpr (B < Split<N>::L) {
    if ((uni >> B) & 1u) {
      constexpr unsigned MC = M | (1u << B);
      const double q = __dmul_rn(p, row.r[B]);
      const bool a = ok & (((row.allowed >> B) & 1u) != 0);
      visit<N, MC>(row, q, s, a, c, best);
      walk_allowed<N, B + 1, MC>(row, q, uni, s, a, c, best);
    }
    walk_allowed<N, B + 1, M>(row, p, uni, s, ok, c, best);
  }
}

template <int N, bool kAllowed>
__global__ void __launch_bounds__(kRowThreads)
argmin_rows_kernel(const CostTable c, const double* __restrict__ rhos,
                   const double* __restrict__ mp, long long mp_stride,
                   const long long* __restrict__ allowed,
                   long long* __restrict__ out, long long rows) {
  constexpr int S = N | 1;                     // odd stride: no conflicts
  constexpr int L = Split<N>::L;
  constexpr unsigned kTop = Split<N>::kTop;
  __shared__ double s_rows[kRowThreads * S];
  for (long long base = (long long)blockIdx.x * kRowThreads; base < rows;
       base += (long long)gridDim.x * kRowThreads) {
    const int tile = (int)min((long long)kRowThreads, rows - base);
    const double* src = rhos + base * N;
    for (int i = threadIdx.x; i < tile * N; i += kRowThreads) {
      const int row = i / N;
      s_rows[row * S + (i - row * N)] = __ldg(src + i);
    }
    __syncthreads();
    Row<N> row;
#pragma unroll
    for (int j = 0; j < N; ++j) row.r[j] = s_rows[threadIdx.x * S + j];
    __syncthreads();                           // the tile may be refilled
    const bool active = threadIdx.x < tile;
    const long long b = base + threadIdx.x;
    Best best;
    if constexpr (kAllowed) {
      row.allowed = active ? (unsigned)__ldg(allowed + b) : 0u;
      const unsigned uni = __reduce_or_sync(0xffffffffu, row.allowed);
      const unsigned own = (row.allowed >> L) & kTop;
      if (active) {
        const double m0 = __ldg(mp + b * mp_stride);
        best = Best{CUDART_INF, 1u << N};
#pragma unroll 1
        for (unsigned s = 0; s <= kTop; ++s) {
          if (s & ~(uni >> L)) continue;       // no row of the warp takes s
          const bool ok = (s & ~own) == 0;
          visit<N, 0u>(row, m0, s, ok, c, best);
          walk_allowed<N, 0, 0u>(row, m0, uni, s, ok, c, best);
        }
      }
    } else if (active) {
      const double m0 = __ldg(mp + b * mp_stride);
      group<N, 0u>(row, m0, c, best);
      walk<N, 0, 0u>(row, m0, c, best);
    }
    if (active) out[b] = best.m;
  }
}

// ---- a warp per row --------------------------------------------------------

// Lane-local product of the lane's low bits, ascending.
__device__ __forceinline__ double low_prod(double p, const double* r,
                                           int low, unsigned lane) {
#pragma unroll
  for (int j = 0; j < kLowBits; ++j) {
    if (j < low && ((lane >> j) & 1u)) p = __dmul_rn(p, r[j]);
  }
  return p;
}

// Depth-first walk over the bits [start, n) added to mask m (product p):
// one loop level a bit depth, so each level's product stays in registers.
template <int D, class Visit>
__device__ __forceinline__ void walk_high(const double* r, int n, int start,
                                          double p, unsigned m,
                                          unsigned allowed, Visit& visit) {
  for (int b = start; b < n; ++b) {
    if (!((allowed >> b) & 1u)) continue;
    const double q = __dmul_rn(p, r[b]);
    const unsigned mc = m | (1u << b);
    visit(mc, q);
    if constexpr (D + 1 < kMaxHighBits) {
      walk_high<D + 1>(r, n, b + 1, q, mc, allowed, visit);
    }
  }
}

struct ArgminVisit {
  const double* cost;
  Best best;
  __device__ __forceinline__ void operator()(unsigned m, double q) {
    best.offer(__dadd_rn(__ldg(cost + m), q), m);
  }
};

struct StoreVisit {
  double* row;
  __device__ __forceinline__ void operator()(unsigned m, double q) {
    row[m] = q;
  }
};

__global__ void __launch_bounds__(kWarpThreads)
argmin_warp_kernel(const double* __restrict__ cost,
                   const double* __restrict__ rhos,
                   const double* __restrict__ mp, long long mp_stride,
                   const long long* __restrict__ allowed,
                   long long* __restrict__ out, long long rows, int n) {
  __shared__ double s_rho[kWarps][kMaxN];
  const int warp = threadIdx.x >> 5;
  const unsigned lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * kWarps;
  for (long long b = (long long)blockIdx.x * kWarps + warp; b < rows;
       b += step) {
    if (lane < (unsigned)n) s_rho[warp][lane] = __ldg(rhos + b * n + lane);
    __syncwarp();
    const unsigned al = allowed == nullptr ? ~0u : (unsigned)__ldg(allowed + b);
    ArgminVisit visit{cost, {CUDART_INF, 1u << n}};
    if ((lane & ~al) == 0) {                  // the lane's low bits allowed
      const double p = low_prod(__ldg(mp + b * mp_stride), s_rho[warp],
                                kLowBits, lane);
      visit(lane, p);
      walk_high<0>(s_rho[warp], n, kLowBits, p, lane, al, visit);
    }
    Best best = visit.best;
    for (int off = 16; off > 0; off >>= 1) {
      const double ov = __shfl_down_sync(0xffffffffu, best.v, off);
      const unsigned om = __shfl_down_sync(0xffffffffu, best.m, off);
      best.offer(ov, om);
    }
    if (lane == 0) out[b] = best.m;
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kWarpThreads)
prod_warp_kernel(const double* __restrict__ rhos,
                 const double* __restrict__ mp, long long mp_stride,
                 double* __restrict__ out, long long rows, int n) {
  __shared__ double s_rho[kWarps][kMaxN];
  const int warp = threadIdx.x >> 5;
  const unsigned lane = threadIdx.x & 31;
  const int low = n < kLowBits ? n : kLowBits;
  const long long step = (long long)gridDim.x * kWarps;
  for (long long b = (long long)blockIdx.x * kWarps + warp; b < rows;
       b += step) {
    if (lane < (unsigned)n) s_rho[warp][lane] = __ldg(rhos + b * n + lane);
    __syncwarp();
    if (lane < (1u << low)) {
      StoreVisit visit{out + (b << n)};
      const double p = low_prod(__ldg(mp + b * mp_stride), s_rho[warp], low,
                                lane);
      visit(lane, p);
      walk_high<0>(s_rho[warp], n, low, p, lane, ~0u, visit);
    }
    __syncwarp();
  }
}

int blocks_for(long long units) {
  return (int)(units < kMaxBlocks ? units : kMaxBlocks);
}

template <int N>
void launch_rows(const CostTable& c, const double* rhos, const double* mp,
                 long long mp_stride, const long long* allowed,
                 long long* out, long long rows, cudaStream_t s) {
  const int grid = blocks_for((rows + kRowThreads - 1) / kRowThreads);
  if (allowed != nullptr) {
    argmin_rows_kernel<N, true><<<grid, kRowThreads, 0, s>>>(
        c, rhos, mp, mp_stride, allowed, out, rows);
  } else {
    argmin_rows_kernel<N, false><<<grid, kRowThreads, 0, s>>>(
        c, rhos, mp, mp_stride, allowed, out, rows);
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).  Callers
// guarantee rows >= 1, 1 <= n <= 16, contiguous float64/int64 buffers on
// the current device, and mp_stride in {0, 1}.
int subsetdp_prod(const void* rhos, const void* mp, long long mp_stride,
                  void* out, long long rows, int n, void* stream) {
  prod_warp_kernel<<<blocks_for((rows + kWarps - 1) / kWarps), kWarpThreads,
                     0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(rhos), static_cast<const double*>(mp),
      mp_stride, static_cast<double*>(out), rows, n);
  return static_cast<int>(cudaGetLastError());
}

// ``cost_host``: the 2^n subset costs in host memory (read during the
// call, for n <= 8); ``cost_dev``: the same on the device (read by the
// kernel, for n > 8; may be null otherwise).  ``allowed`` may be null
// (every mask allowed).
int subsetdp_argmin(const double* cost_host, const void* cost_dev,
                    const void* rhos, const void* mp, long long mp_stride,
                    const void* allowed, void* out, long long rows, int n,
                    void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto r = static_cast<const double*>(rhos);
  const auto m = static_cast<const double*>(mp);
  const auto al = static_cast<const long long*>(allowed);
  const auto o = static_cast<long long*>(out);
  if (n > kThreadMaxN) {
    argmin_warp_kernel<<<blocks_for((rows + kWarps - 1) / kWarps),
                         kWarpThreads, 0, s>>>(
        static_cast<const double*>(cost_dev), r, m, mp_stride, al, o, rows,
        n);
    return static_cast<int>(cudaGetLastError());
  }
  CostTable c{};
  for (int i = 0; i < (1 << n); ++i) c.v[i] = cost_host[i];
  switch (n) {
    case 1: launch_rows<1>(c, r, m, mp_stride, al, o, rows, s); break;
    case 2: launch_rows<2>(c, r, m, mp_stride, al, o, rows, s); break;
    case 3: launch_rows<3>(c, r, m, mp_stride, al, o, rows, s); break;
    case 4: launch_rows<4>(c, r, m, mp_stride, al, o, rows, s); break;
    case 5: launch_rows<5>(c, r, m, mp_stride, al, o, rows, s); break;
    case 6: launch_rows<6>(c, r, m, mp_stride, al, o, rows, s); break;
    case 7: launch_rows<7>(c, r, m, mp_stride, al, o, rows, s); break;
    case 8: launch_rows<8>(c, r, m, mp_stride, al, o, rows, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
