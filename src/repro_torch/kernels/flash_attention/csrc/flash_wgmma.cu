// Flash-attention forward (GQA, causal or not) in bf16 on Hopper's tensor
// cores (sm_90a): wgmma for Q.K^T and for P.V, TMA for the tiles.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash.py:32
// (_flash_kernel, wrapper flash_attention_pallas) for bf16 inputs; float32
// inputs take the CUDA-core kernel in flash.cu.  The TPU kernel walks a
// sequential grid (B, Hq, nQ, nK) and carries (m, l, acc) in VMEM from one
// KV block to the next.  Here a CTA owns 64 query rows of one (batch,
// query head); its WGS warpgroups (3; 2 at D = 112, 128; 1 at D = 224) take
// every WGS-th
// 64-key tile each, with m, l and the output accumulator in registers, and
// warpgroups 1.. hand theirs to warpgroup 0 through shared memory at the
// end, which merges them and writes o.  The grid walks the query tiles
// last, heaviest (most KV tiles under a causal mask) first.
//
// What bounds it on an H100: the operations, 4 * Hq * D flops per kept
// (query, key) pair, which only the tensor cores deliver (989 TFLOP/s in
// bf16 against 67 in float32 on the CUDA cores), and in practice the
// chain of each warpgroup's iteration (the softmax between the two
// products, one exp per score, and the wait for P.V) and a fixed cost a
// CTA: the latency of the first Q and K/V loads, the merge and the store,
// which the light CTAs at the end of a causal grid pay almost alone.  The
// design:
//  - S = Q.K^T: wgmma m64n64k16, Q and K bf16 from shared memory
//    (K-major), float32 accumulate; the next tile's S is issued before
//    this tile's softmax, so it runs on the tensor cores meanwhile.  The
//    scale is applied to S in float32 (1/sqrt(D) is no power of two at D =
//    32, 128: scaling q in bf16 would add a rounding the reference does
//    not have), folded with log2(e) into the exponent: p = 2^(s c - m c).
//  - Masks as the TPU kernel: a causal score is -1e30 (flash.py:29), a key
//    past Sk is -inf, only on tiles that meet the diagonal or Sk; KV tiles
//    wholly above the diagonal are not visited.
//  - Online softmax in registers on the accumulator layout (a thread holds
//    two rows' columns; row max by quad shuffles); l sums p unrounded per
//    thread and is quad-summed at the end; the divide clamps l at 1e-30.
//  - O += P.V with p in float32, as the TPU kernel (flash.py:52 casts v to
//    float32, so p.astype(v.dtype) at :64 keeps p in float32): p is split
//    into p_hi = bf16(p) and p_lo = bf16(p - p_hi), and two register-A
//    wgmmas (m64nDk16, V MN-major from shared memory) add both into the
//    float32 accumulator.  p_hi + p_lo holds 16 of p's 24 bits.
//  - Loads: TMA over the model layout [B, S, H, D] as a 4-D tensor map
//    (box: 64 rows of one head), swizzled to match the wgmma descriptors
//    (128-byte rows; 64- and 32-byte rows at D = 32, 16; D = 128 as two
//    64-column panels).  Rows past S are zero-filled by TMA.  D = 112
//    (zamba2-7b's shared attention) is no whole number of swizzle spans:
//    it keeps D = 128's two panels in shared memory and registers, while
//    the tensor maps span the real 112 columns, so TMA zero-fills columns
//    112-127 of every Q, K and V tile and clips them from the store of o.
//    Q.K^T runs its 7 k16 steps over the real columns only; P.V computes
//    the 16 zero columns as well (128/112 of its work).  D = 224
//    (zamba2-7b-instruct's, 3 x 64 + 32) pads a fourth panel the same way
//    (256 columns; Q.K^T 14 k16 steps, P.V 256/224 of its work).  Its
//    tiles take 32 KB each, so it runs one warpgroup with two stages (Q 32
//    KB + 2 x (K + V) 128 KB); the output accumulator is 128 registers a
//    thread.  Q once, then
//    K and V through a ring of STAGES tiles a warpgroup, each with an
//    mbarrier; a stage is refilled as soon as its warpgroup is done with
//    it.  One thread prefetches the tensor maps, sets up the barriers and
//    issues Q and every warpgroup's first stages before the CTA's first
//    barrier.
//  - Store: o goes through shared memory (the Q tile's place, in its
//    swizzled layout) and leaves by one TMA store a panel, which skips
//    rows past Sq: a few instructions where stores from registers need an
//    address and a predicate each.
// cuTensorMapEncodeTiled is looked up through cudaGetDriverEntryPoint,
// so the library needs no -lcuda.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // query rows per CTA (wgmma M)
constexpr int BN = 64;       // keys per KV tile
constexpr float MASKED = -1e30f;

template <int D>
struct Cfg {
  // width kept in shared memory and registers: D, or D rounded up to whole
  // 64-column panels (128 at D = 112; TMA zero-fills the columns past D)
  static constexpr int DP = D <= 64 ? D : (D + 63) / 64 * 64;
  static constexpr int PANEL = D < 64 ? D : 64;              // columns per panel
  static constexpr int NPANEL = DP / PANEL;                  // 2 at D = 112, 128
  static constexpr int ROW_BYTES = PANEL * 2;                // swizzle span
  static constexpr int Q_PANEL = BM * ROW_BYTES;             // a Q panel
  static constexpr int Q_BYTES = NPANEL * Q_PANEL;           // BM rows x DP
  static constexpr int KV_PANEL = BN * ROW_BYTES;            // a K or V panel
  static constexpr int KV_BYTES = NPANEL * KV_PANEL;         // BN rows x DP
  static constexpr int KPP = PANEL / 16;                     // k16 steps a panel
  // wgmma descriptor layout: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t LAYOUT = ROW_BYTES == 128 ? 1 : ROW_BYTES == 64 ? 2 : 3;
  static constexpr uint32_t SBO = 8 * ROW_BYTES;             // 8-row group stride
  // warpgroups, each taking every WGS-th KV tile, and their stages (two at
  // least: the next tile's S is issued before this tile's P.V)
  static constexpr int WGS = D <= 64 ? 3 : D <= 128 ? 2 : 1;
  static constexpr int THREADS = 128 * WGS;
  static constexpr int STAGES = D <= 128 ? 3 : 2;
  static constexpr int SMEM = Q_BYTES + 2 * KV_BYTES * WGS * STAGES + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor: start address, leading byte offset 16
// (unused by these swizzled layouts), stride between 8-row groups, layout.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// o tile from shared memory to global through the tensor map; rows past
// the tensor's extent are not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from touching accumulator registers across a wgmma
// issue or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[32] (+)= A[64x16] * B[16x64], A and B bf16 K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[8] += A[64x16] * B[16x16], A bf16 in registers (4 words a thread),
// B bf16 MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[16] += A[64x16] * B[16x32], A bf16 in registers (4 words a thread),
// B bf16 MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[32] += A[64x16] * B[16x64], A bf16 in registers (4 words a thread),
// B bf16 MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else wgmma_rs_n64(d, a, db);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Accumulator layout of wgmma m64nNk16 (float32): element i of thread t
// (warp w = t / 32 of its warpgroup, lane l) is row 16w + l/4 + 8 * ((i >> 1)
// & 1), column 8 * (i >> 2) + 2 * (l % 4) + (i & 1).  The rows "a" (i & 2
// == 0) and "b" are the two query rows this thread holds.  Scores stay
// unscaled; p = 2^(s * c - m * c) with c = scale * log2(e), one FFMA and one
// MUFU.EX2 an element.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap omap, int Sq, int Sk,
                   int Hq, int Hkv, int causal, float c) {
  using C = Cfg<D>;
  constexpr int NS = BN / 2;  // score registers a thread
  constexpr int WGS = C::WGS, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // Q, then STAGES for each warpgroup
  __shared__ __align__(8) uint64_t bars[1 + WGS * STAGES];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int warp = wt / 32, lane = tid % 32;
  // this warpgroup's stage s: K then V
  auto k_s = [&](int s) {
    return base + C::Q_BYTES + 2 * C::KV_BYTES * (wg * STAGES + s);
  };
  auto bar = [&](int i) { return smem_u32(&bars[i]); };
  auto stage_bar = [&](int s) { return bar(1 + wg * STAGES + s); };

  const int nq = (Sq + BM - 1) / BM;
  const int q0 = (nq - 1 - (int)blockIdx.z) * BM;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (Hq / Hkv);
  const int kv_end = causal ? min(Sk, q0 + BM) : Sk;
  const int nt = (kv_end + BN - 1) / BN;
  // warpgroup w takes the KV tiles t = w + WGS * i, i < share(w)
  auto share = [&](int w) { return nt > w ? (nt - w + WGS - 1) / WGS : 0; };
  const int mine = share(wg);

  auto load_kv = [&](int w, int i) {  // warpgroup w's i-th tile
    const int s = i % STAGES, t = w + WGS * i;
    const uint32_t kd = base + C::Q_BYTES + 2 * C::KV_BYTES * (w * STAGES + s);
    const uint32_t sb = bar(1 + w * STAGES + s);
    mbar_expect_tx(sb, 2 * C::KV_BYTES);
#pragma unroll
    for (int p = 0; p < C::NPANEL; ++p) {
      tma_load_4d(kd + p * C::KV_PANEL, &kmap, sb, p * C::PANEL, hk, t * BN, b);
      tma_load_4d(kd + C::KV_BYTES + p * C::KV_PANEL, &vmap, sb, p * C::PANEL,
                  hk, t * BN, b);
    }
  };
  // one thread sets up the barriers and issues Q and every warpgroup's
  // first stages at once
  if (tid == 0) {
    prefetch_map(&qmap);
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    prefetch_map(&omap);
    for (int i = 0; i < 1 + WGS * STAGES; ++i) mbar_init(bar(i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar(0), C::Q_BYTES);
#pragma unroll
    for (int p = 0; p < C::NPANEL; ++p)
      tma_load_4d(q_s + p * C::Q_PANEL, &qmap, bar(0), p * C::PANEL, h, q0,
                  b);
    for (int w = 0; w < WGS; ++w)
      for (int i = 0; i < STAGES && i < share(w); ++i) load_kv(w, i);
  }
  __syncthreads();

  // wgmma descriptors, built once: a k-step or a stage moves the start
  // address field (16-byte units) only
  const uint64_t dq = make_desc(q_s, C::SBO, C::LAYOUT);
  const uint64_t dk = make_desc(k_s(0), C::SBO, C::LAYOUT);
  constexpr uint32_t STAGE16 = 2 * C::KV_BYTES / 16;
  // S = Q.K^T of this warpgroup's i-th tile, issued and committed
  auto issue_qk = [&](float (&sc)[NS], int i) {
    mbar_wait(stage_bar(i % STAGES), (i / STAGES) & 1);
#pragma unroll
    for (int j = 0; j < NS; ++j) sc[j] = 0.f;
    wgmma_fence();
    const uint64_t ds = dk + (i % STAGES) * STAGE16;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t q16 = ((ks / C::KPP) * C::Q_PANEL + (ks % C::KPP) * 32) / 16;
      const uint32_t k16 = ((ks / C::KPP) * C::KV_PANEL + (ks % C::KPP) * 32) / 16;
      wgmma_ss_n64(sc, dq + q16, ds + k16, ks > 0);
    }
    wgmma_commit();
  };

  const int qa = q0 + 16 * warp + lane / 4, qb = qa + 8;
  float oacc[C::NPANEL][C::PANEL / 2];
#pragma unroll
  for (int p = 0; p < C::NPANEL; ++p)
#pragma unroll
    for (int i = 0; i < C::PANEL / 2; ++i) oacc[p][i] = 0.f;
  float ma = MASKED, mb = MASKED, la = 0.f, lb = 0.f;
  float sc[NS], sn[NS];
  mbar_wait(bar(0), 0);
  if (mine > 0) {
    issue_qk(sc, 0);
    wgmma_wait_all();
    fence_regs(sc);
  }

  for (int i = 0; i < mine; ++i) {
    const int s = i % STAGES;
    // the next tile's S runs on the tensor cores during this softmax
    if (i + 1 < mine) issue_qk(sn, i + 1);

    // masks, only where this warp's 16 rows meet the diagonal or Sk
    const int k0 = (wg + WGS * i) * BN;
    if (k0 + BN > Sk || (causal && k0 + BN - 1 > q0 + 16 * warp)) {
      const int kl = k0 + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int key = kl + 8 * (j >> 2) + (j & 1);
        if (key >= Sk) sc[j] = -INFINITY;
        else if (causal && key > ((j & 2) ? qb : qa)) sc[j] = MASKED;
      }
    }
    // running max over the quad that shares a row
    float ta = MASKED, tb = MASKED;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (j & 2) tb = fmaxf(tb, sc[j]); else ta = fmaxf(ta, sc[j]);
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      ta = fmaxf(ta, __shfl_xor_sync(0xffffffffu, ta, sh));
      tb = fmaxf(tb, __shfl_xor_sync(0xffffffffu, tb, sh));
    }
    const float na = fmaxf(ma, ta), nb = fmaxf(mb, tb);
    const float alpha_a = ex2((ma - na) * c), alpha_b = ex2((mb - nb) * c);
    const float mca = na * c, mcb = nb * c;
    ma = na;
    mb = nb;

    // p in float32, split into bf16 high and low parts (A fragments)
    uint32_t phi[BN / 16][4], plo[BN / 16][4];
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int j = 0; j < NS; j += 2) {
      const float mc = (j & 2) ? mcb : mca;
      const float p0 = ex2(fmaf(sc[j], c, -mc)), p1 = ex2(fmaf(sc[j + 1], c, -mc));
      if (j & 2) sb += p0 + p1; else sa += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      phi[j / 8][(j % 8) / 2] = *reinterpret_cast<const uint32_t*>(&hi);
      plo[j / 8][(j % 8) / 2] = pack_bf16(p0 - __low2float(hi),
                                          p1 - __high2float(hi));
    }
    la = la * alpha_a + sa;
    lb = lb * alpha_b + sb;
#pragma unroll
    for (int p = 0; p < C::NPANEL; ++p)
#pragma unroll
      for (int j = 0; j < C::PANEL / 2; ++j)
        oacc[p][j] *= (j & 2) ? alpha_b : alpha_a;

    // O += P_hi.V + P_lo.V, 16 keys a step
#pragma unroll
    for (int p = 0; p < C::NPANEL; ++p) fence_regs(oacc[p]);
    wgmma_fence();
    const uint64_t dv = dk + s * STAGE16 + C::KV_BYTES / 16;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int p = 0; p < C::NPANEL; ++p) {
        const uint64_t d = dv + (p * C::KV_PANEL + kk * 16 * C::ROW_BYTES) / 16;
        wgmma_rs<C::PANEL>(oacc[p], phi[kk], d);
        wgmma_rs<C::PANEL>(oacc[p], plo[kk], d);
      }
    wgmma_commit();
    wgmma_wait_all();  // this PV and the next tile's S
#pragma unroll
    for (int p = 0; p < C::NPANEL; ++p) fence_regs(oacc[p]);
    fence_regs(sn);
#pragma unroll
    for (int j = 0; j < NS; ++j) sc[j] = sn[j];

    // the warpgroup is done with stage s: refill it
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    if (wt == 0 && i + STAGES < mine) load_kv(wg, i + STAGES);
  }

  // l summed over the quad that shares a row
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    la += __shfl_xor_sync(0xffffffffu, la, sh);
    lb += __shfl_xor_sync(0xffffffffu, lb, sh);
  }
  // warpgroups 1.. hand (m, l, acc) to warpgroup 0 through shared memory
  // (the K/V stages, all consumed); thread wt of each holds the same rows
  // and columns
  constexpr int DH = C::DP / 2;             // accumulator registers a thread
  constexpr int SLOT = (DH + 4) * 128;      // floats a warpgroup hands over
  float* xfer = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) +
                                         C::Q_BYTES);
  __syncthreads();
  if (wg > 0) {
    float* x = xfer + (wg - 1) * SLOT + wt;
#pragma unroll
    for (int p = 0; p < C::NPANEL; ++p)
#pragma unroll
      for (int j = 0; j < C::PANEL / 2; ++j)
        x[(p * (C::PANEL / 2) + j) * 128] = oacc[p][j];
    x[(DH + 0) * 128] = ma;
    x[(DH + 1) * 128] = mb;
    x[(DH + 2) * 128] = la;
    x[(DH + 3) * 128] = lb;
  }
  __syncthreads();
  if (wg > 0) return;
  float ma2 = ma, mb2 = mb;
#pragma unroll
  for (int w = 1; w < WGS; ++w) {
    ma2 = fmaxf(ma2, xfer[(w - 1) * SLOT + (DH + 0) * 128 + wt]);
    mb2 = fmaxf(mb2, xfer[(w - 1) * SLOT + (DH + 1) * 128 + wt]);
  }
  float fa = ex2((ma - ma2) * c), fb = ex2((mb - mb2) * c);
  la *= fa;
  lb *= fb;
#pragma unroll
  for (int p = 0; p < C::NPANEL; ++p)
#pragma unroll
    for (int j = 0; j < C::PANEL / 2; ++j) oacc[p][j] *= (j & 2) ? fb : fa;
#pragma unroll
  for (int w = 1; w < WGS; ++w) {
    const float* x = xfer + (w - 1) * SLOT + wt;
    fa = ex2((x[(DH + 0) * 128] - ma2) * c);
    fb = ex2((x[(DH + 1) * 128] - mb2) * c);
    la += x[(DH + 2) * 128] * fa;
    lb += x[(DH + 3) * 128] * fb;
#pragma unroll
    for (int p = 0; p < C::NPANEL; ++p)
#pragma unroll
      for (int j = 0; j < C::PANEL / 2; ++j)
        oacc[p][j] += x[(p * (C::PANEL / 2) + j) * 128] * ((j & 2) ? fb : fa);
  }
  const float inv_a = 1.f / fmaxf(la, 1e-30f), inv_b = 1.f / fmaxf(lb, 1e-30f);
  // o through shared memory, in the Q tile's place and swizzled layout,
  // then one TMA store a panel (rows past Sq are not written)
  const int ra = 16 * warp + lane / 4;
#pragma unroll
  for (int p = 0; p < C::NPANEL; ++p)
#pragma unroll
    for (int j = 0; j < C::PANEL / 2; j += 2) {
      const float inv = (j & 2) ? inv_b : inv_a;
      const uint32_t byte = (ra + 4 * (j & 2)) * C::ROW_BYTES +
                            4 * (4 * (j >> 2) + lane % 4);
      const uint32_t swz = byte ^ (((byte >> 7) & (C::ROW_BYTES / 16 - 1)) << 4);
      asm volatile("st.shared.u32 [%0], %1;\n"
                   :: "r"(q_s + p * C::Q_PANEL + swz),
                      "r"(pack_bf16(oacc[p][j] * inv, oacc[p][j + 1] * inv))
                   : "memory");
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  if (tid == 0) {
#pragma unroll
    for (int p = 0; p < C::NPANEL; ++p)
      tma_store_4d(&omap, q_s + p * C::Q_PANEL, p * C::PANEL, h, q0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 4-D map over a contiguous [B, S, H, D] bf16 tensor; box: one panel's
// columns of one head's `rows` rows, swizzled to the panel's row width.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
              int rows) {
  using C = Cfg<D>;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::PANEL, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = C::ROW_BYTES == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : C::ROW_BYTES == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Sk, int Hq, int Hkv, int causal, float scale,
                   cudaStream_t stream) {
  CUtensorMap qm, km, vm, om;
  if (!make_map<D>(&qm, q, B, Sq, Hq, BM) || !make_map<D>(&om, o, B, Sq, Hq, BM) ||
      !make_map<D>(&km, k, B, Sk, Hkv, BN) ||
      !make_map<D>(&vm, v, B, Sk, Hkv, BN))
    return cudaErrorInvalidValue;
  auto kernel = flash_wgmma_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::SMEM);
  if (err != cudaSuccess) return err;
  // query tiles slowest, so the heaviest (causal) tiles of every head go
  // first
  const dim3 grid(Hq, B, (Sq + BM - 1) / BM);
  kernel<<<grid, Cfg<D>::THREADS, Cfg<D>::SMEM, stream>>>(
      qm, km, vm, om, Sq, Sk, Hq, Hkv, causal,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace


// q, k, v and o bf16, contiguous, 16-byte aligned.  Returns the launch's
// CUDA error code (0 on success); the wrapper checks every argument first.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
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
