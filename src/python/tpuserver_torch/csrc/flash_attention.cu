// Exact attention forward (flash attention), causal or not, for sm_90a.
//
// Replaces the TPU kernel tpuserver/ops/flash.py::flash_attention
// (_attn_kernel, with _online_softmax_fold and _fold_finish).
//
//   q [B, T, H, D], k/v [B, Tk, Hkv, D] -> out [B, T, H, D]
//
// Two routes, picked by the wrapper (tpuserver_torch/ops/flash.py::
// flash_route) from the dtype alone: `wgmma` for bf16 at every head dim of
// the domain (a multiple of 8 from 8 to 256), `simt` for float32.
//
// The `wgmma` route (flash_attention_kernel).  Bound on the H100: bytes at
// the main path's prompt length, operations beyond it.  Causal attention at
// Llama-3-8B prefill shapes (T 512, H 32, Hkv 8, D 128, bf16, GQA read
// natively) does about 2.15 GFLOP per layer against 10.5 MB of q/k/v/out:
// about 205 operations per byte, below the ~295 where the tensor cores
// would limit.  So the least time is the bytes', about 3.1 us at 3.35 TB/s
// (2.2 us for the operations at 989 TFLOP/s).  At T 2048 the same layer does
// 34.4 GFLOP on 42 MB and is operation-bound (about 35 us).
//
// What the design does about it:
// - one block per (head, batch, 128-query tile): two consumer warpgroups of
//   64 query rows each and one producer warp.  The producer issues TMA loads
//   (cp.async.bulk.tensor, 128-byte swizzle) of Q once and of each 64-key
//   K/V tile into a 2-stage ring guarded by mbarriers (full: bytes landed;
//   empty: both warpgroups done), so the next tile is in flight while the
//   current one is computed;
// - S = Q K^T runs on wgmma.mma_async m64n64k16 with Q and K read from
//   shared memory through K-major descriptors; O += P V runs on
//   wgmma.mma_async m64nNk16 (N 64 or 128 a column block pair) with P
//   (rounded to bf16, as the TPU kernel does) from registers and V read from
//   shared memory through a transposed (MN-major) descriptor.  Scores,
//   probabilities and the output accumulator stay in registers, with the
//   softmax state in fp32.  Each warpgroup runs S, softmax and P V in turn;
//   the other warpgroup's work fills the gaps;
// - every head dim D runs at a padded D_p of 64, 128, 192 or 256: the tensor
//   maps keep D as their innermost extent, so TMA's out-of-bounds fill
//   writes zeros into columns D .. D_p - 1 of Q, K and V in shared memory.
//   S = Q K^T sums over D_p (the zero columns add nothing; at most 8x idle
//   MMA at D 8, 1.33x at D 96, both at shapes bound by bytes), O = P V runs
//   at N = D_p and only D columns are stored.  D 64 and 128 are their own
//   D_p and keep the code paths they had.  At D_p 256 the block holds Q (64
//   KB) and two 64-key K/V stages (64 KB each), 193 KB of shared memory,
//   and a consumer thread 128 output accumulators;
// - the softmax, not the MMA, is the longest phase on the H100
//   (tools/torch_flash_clocks.py), bound by the 16 exp2 a clock of an SM,
//   so it is kept short: exp2 is one ex2.approx, only tiles that cross Tk
//   or a warp's diagonal are masked, and the output is rescaled only when
//   a row's max moved.  Issuing the next tile's S before the current
//   softmax, and ping-pong of the two warpgroups, measured no faster
//   (PERF.md);
// - causal tiles run longest first (the last query tile is block 0 of the
//   slowest grid dimension), and each warpgroup skips the key tiles that lie
//   wholly above its own diagonal;
// - GQA is native: the block reads kv head h / (H / Hkv), so the caller
//   never expands K/V in memory (the TPU path expanded them first);
// - rows past T and keys past Tk arrive as zeros from TMA and are masked.
// Left for later work: fewer exp2 on the special-function unit (part of
// them as polynomials on the FMA units), a persistent schedule, loading
// each K/V tile once for the n_rep heads that share it, a TMA store of
// the output, and QK^T over D rounded up to 16 instead of D_p at the small
// head dims.
//
// The `simt` route (flash_attention_simt_kernel, below) takes float32 at
// every head dim of the domain: the same online softmax on the CUDA cores,
// every product and sum a float32 FMA (no TF32, no tensor core), so float32
// sums stay float32 as the port's float32 runs (TF32 off) rely on.  Its
// bound is operations: at Llama-3-8B prefill shapes in float32 (T 512) the
// 2.15 GFLOP of a layer take about 32 us at the card's 67 TFLOP/s of
// float32 FMA, against about 6 us for the 21 MB.  An FMA needs its operands
// in registers, and shared memory feeds an SM's 128 FMA lanes far less than
// one float each a clock, so the design is register tiling: a thread owns a
// micro-tile of S (4 rows by 4 keys) and of O (8 rows by 4 or 8 columns),
// fed by 16-byte loads, 64 FMAs for 8 loads in S and 128 or 256 for 12 or
// 16 in P V.  Eight warps a block keep two on each of the SM's schedulers
// at any head dim (4 warps of 16 rows measured 1.06-1.44x slower at D 64 to
// 128, PERF.md).  P passes through shared memory once a tile; K and V have
// buffers of their own, filled by cp.async, each loaded while the other is
// read.  Left for later work: a load-balanced causal schedule (the longest
// query tiles set the time at T 512), K/V shared by the query heads of one
// kv head, and larger micro-tiles of S (shared memory caps the key tile).
//
// The wrapper raises only for what neither route takes: a dtype other than
// float32 or bf16, D not a multiple of 8 or above 256, rows that are not
// 16-byte aligned.  The fold keeps a finite shift for rows that are still
// fully masked and maps l == 0 to 1.  The tensor maps are encoded on the
// host with cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint,
// so the library needs no link against the driver library.

#include <cuda.h>  // CUtensorMap and its enums (types only)

#include "common.cuh"

namespace {

constexpr int kBk = 64;   // keys per tile
constexpr int kStages = 2;
constexpr int kBox = 64 * 64 * 2;  // bytes of one 64 x 64 bf16 TMA box

// D: the padded head dim (64, 128, 192 or 256).  Two consumer warpgroups
// of 64 query rows each, one at D 256: with the producer warp, nine warps
// put three on one of the SM's four register files, whose 16384 registers
// then cap a thread at 168, below the 128 output accumulators and the
// scores; five warps leave it 255.
template <int D>
struct Layout {
  static constexpr int kWarpgroups = D == 256 ? 1 : 2;
  static constexpr int kBq = 64 * kWarpgroups;  // query rows per block
  static constexpr int kConsumers = 128 * kWarpgroups;
  static constexpr int kThreads = kConsumers + 32;  // and one producer warp
  static constexpr int kQ = kBq * D * 2;   // [warpgroups][D / 64][64][64]
  static constexpr int kKV = kBk * D * 2;  // one K or V tile: [D / 64][64][64]
  static constexpr int kBars = 2 * kStages + 1;
  static constexpr int kBytes = 1024 + kQ + kStages * 2 * kKV + 8 * kBars;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
// A phase that never completes is a bug; the kernel traps (the launch then
// fails) rather than holding the card forever.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 22)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One 64 x 64 box of a [B, L, H, D] tensor, at (d0, l0, h, b), into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int d0, int l0, int h, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d0),
      "r"(l0), "r"(h), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled tile whose 8-row
// groups are 1024 bytes apart.  K-major operands (Q, K: rows of 64
// contiguous bf16 along the reduced dimension) ignore the leading offset;
// the MN-major operand (V read as [keys][D]) steps to its next 64-wide
// column block by it.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr,
                                              uint32_t lead_bytes) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lead_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;  // 128-byte swizzle
  return d;
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

// Registers that an asynchronous wgmma writes: redefined here, after the
// wait, so that the compiler moves no use of them above it.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x on the special-function unit (one instruction; denormal results
// flush to 0, and 2^-inf is 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, A and B in shared memory
// (K-major, 128-byte swizzle), fp32 accumulators in registers.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (bf16 pairs),
// B in shared memory as [16][64] rows (MN-major, 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers (bf16 pairs),
// B in shared memory as [16][128] rows (MN-major, 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Issue S[64 x 64] = Q[64 x D] . K[64 x D]^T for one warpgroup (committed,
// not waited for): q_addr and k_addr hold D / 64 swizzled 64 x 64 boxes
// each; a 16-wide k step moves 32 bytes within a box's 128-byte rows.
template <int D>
__device__ __forceinline__ void qk_issue(float* sc, uint32_t q_addr,
                                         uint32_t k_addr) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kBox + (kk & 3) * 32;
    wgmma_ss_n64(sc, smem_desc(q_addr + off, 16), smem_desc(k_addr + off, 16),
                 kk > 0);
  }
  wgmma_commit();
}

// Issue O[64 x D] += P[64 x 64] . V[64 x D] for one warpgroup (committed,
// not waited for), P as bf16 A fragments (four 16-key steps), V as D / 64
// swizzled 64 x 64 boxes read transposed: a 16-key step moves 16 rows (2048
// bytes), the next 64-wide column block is one box (kBox bytes) on.  Each
// pair of column blocks is one N 128 product (accumulators 64 cb .. on), a
// last odd block an N 64 one.
template <int D>
__device__ __forceinline__ void pv_issue(float* o, const uint32_t (*pa)[4],
                                         uint32_t v_addr) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBk / 16; ++kk) {
#pragma unroll
    for (int cb = 0; cb < D / 64; cb += 2) {
      const uint64_t desc =
          smem_desc(v_addr + cb * kBox + kk * 16 * 128, kBox);
      if (cb + 1 < D / 64) {
        wgmma_rs_n128(o + 32 * cb, pa[kk], desc);
      } else {
        wgmma_rs_n64(o + 32 * cb, pa[kk], desc);
      }
    }
  }
  wgmma_commit();
}

// Accumulator fragment of m64nNk16 (as mma.sync m16n8): register i of a
// thread holds row (i >> 1) & 1 (0: lane / 4, 1: lane / 4 + 8) of its warp's
// 16 rows, column 8 * (i >> 2) + 2 * (lane & 3) + (i & 1).  The P fragments
// of 16-key step kk are the registers of columns 16 kk .. 16 kk + 15.
__device__ __forceinline__ void pack_p(const float* sc, uint32_t (*pa)[4]) {
#pragma unroll
  for (int kk = 0; kk < kBk / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// D is the padded head dim D_p; d_out (<= D) the columns stored.
template <int D>
__global__ void __launch_bounds__(Layout<D>::kThreads, 1)
    flash_attention_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
    int T, int Tk, int d_out, int n_rep, int causal, long long o_sb,
    long long o_st, long long o_sh, float scale_log2) {
  using L = Layout<D>;
  constexpr int kBq = L::kBq;
  constexpr int kConsumers = L::kConsumers;
  constexpr int kCb = D / 64;  // 64-wide column blocks
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = base;
  unsigned char* kvs = base + L::kQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(kvs + kStages * 2 * L::kKV);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBq;  // longest tiles first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / n_rep;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  int n_kt = (Tk + kBk - 1) / kBk;
  if (causal) n_kt = min(n_kt, (q0 + kBq - 1) / kBk + 1);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // producer: Q once, then K/V tiles into the ring
    if (lane == 0) {
      mbar_expect_tx(qbar, L::kQ);
      for (int half = 0; half < L::kWarpgroups; ++half)
        for (int cb = 0; cb < kCb; ++cb)
          tma_load(qs + (half * kCb + cb) * kBox, &tm_q, cb * 64,
                   q0 + half * 64, h, b, qbar);
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % kStages;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * L::kKV);
        unsigned char* ks = kvs + s * 2 * L::kKV;
        for (int cb = 0; cb < kCb; ++cb) {
          tma_load(ks + cb * kBox, &tm_k, cb * 64, t * kBk, kvh, b, &full[s]);
          tma_load(ks + L::kKV + cb * kBox, &tm_v, cb * 64, t * kBk, kvh, b,
                   &full[s]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63, warp wq of
  // it 16 of them; this thread holds rows qpos[0] and qpos[1]
  const int wg = warp >> 2;
  const int wq = warp & 3;
  const int qpos[2] = {q0 + wg * 64 + wq * 16 + (lane >> 2),
                       q0 + wg * 64 + wq * 16 + (lane >> 2) + 8};
  int my_kt = n_kt;
  if (causal) my_kt = min(n_kt, (q0 + wg * 64 + 63) / kBk + 1);
  const uint32_t q_addr = smem_u32(qs + wg * kCb * kBox);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {0.f, 0.f};  // this thread's share of the row sums

  mbar_wait(qbar, 0);
  for (int t = 0; t < n_kt; ++t) {
    const int s = t % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
    if (t < my_kt) {
      const uint32_t k_addr = smem_u32(kvs + s * 2 * L::kKV);
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      qk_issue<D>(sc, q_addr, k_addr);
      wgmma_wait_all();
      fence_regs<32>(sc);

      // scale into log2 units; mask only a tile that crosses Tk or, causal,
      // the diagonal of this warp's 16 rows
      const int k0 = t * kBk;
      const int warp_row0 = q0 + wg * 64 + wq * 16;
      const bool edge =
          k0 + kBk > Tk || (causal && k0 + kBk - 1 > warp_row0);
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] *= scale_log2;
      if (edge) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = k0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
          if (col >= Tk || (causal && col > qpos[(i >> 1) & 1]))
            sc[i] = -INFINITY;
        }
      }
      // the row maxima over the quad, and the fold
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2], shift[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_row[r], mx[r]);
        shift[r] = tt_shift(m_new);
        alpha[r] = isfinite(m_row[r]) ? ex2(m_row[r] - shift[r]) : 0.f;
        m_row[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = ex2(sc[i] - shift[(i >> 1) & 1]);
        sc[i] = p;
        rs[(i >> 1) & 1] += p;
      }
      l_row[0] = l_row[0] * alpha[0] + rs[0];
      l_row[1] = l_row[1] * alpha[1] + rs[1];
      // rescale the output unless no row of the warp moved its max
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      }

      uint32_t pa[kBk / 16][4];
      pack_p(sc, pa);
      pv_issue<D>(o, pa, k_addr + L::kKV);
      wgmma_wait_all();
      fence_regs<D / 2>(o);
    }
    // this warp is done with stage s
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // finish: full row sums over the quad, normalise, store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
    l_row[r] = l_row[r] == 0.f ? 1.f : l_row[r];
  }
  __nv_bfloat16* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= T) continue;
    __nv_bfloat16* orow = ob + qpos[r] * o_st + (lane & 3) * 2;
    const float inv = 1.f / l_row[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (j * 8 < d_out)
        *reinterpret_cast<uint32_t*>(orow + j * 8) =
            pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

// The two tile products the flash kernel is built on, alone: one warpgroup
// loads Q, K and V [64, 128] by TMA and writes S = Q K^T [64, 64] and
// O = bf16(S) V [64, 128] in fp32 (row-major).  A check of the swizzle and
// descriptor conventions against a plain product.
__global__ void __launch_bounds__(128) wgmma_tile_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, float* __restrict__ s_out,
    float* __restrict__ o_out) {
  constexpr int D = 128;
  constexpr int kTile = 64 * D * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + 3 * kTile);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 3 * kTile);
    for (int cb = 0; cb < D / 64; ++cb) {
      tma_load(base + cb * kBox, &tm_q, cb * 64, 0, 0, 0, bar);
      tma_load(base + kTile + cb * kBox, &tm_k, cb * 64, 0, 0, 0, bar);
      tma_load(base + 2 * kTile + cb * kBox, &tm_v, cb * 64, 0, 0, 0, bar);
    }
  }
  mbar_wait(bar, 0);
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  qk_issue<D>(sc, smem_u32(base), smem_u32(base + kTile));
  wgmma_wait_all();
  fence_regs<32>(sc);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  uint32_t pa[kBk / 16][4];
  pack_p(sc, pa);
  pv_issue<D>(o, pa, smem_u32(base + 2 * kTile));
  wgmma_wait_all();
  fence_regs<D / 2>(o);
  const int row = warp * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    s_out[(row + 8 * ((i >> 1) & 1)) * 64 + (i >> 2) * 8 + (lane & 3) * 2 +
          (i & 1)] = sc[i];
#pragma unroll
  for (int i = 0; i < D / 2; ++i)
    o_out[(row + 8 * ((i >> 1) & 1)) * D + (i >> 2) * 8 + (lane & 3) * 2 +
          (i & 1)] = o[i];
}

// -- the simt route: float32 --------------------------------------------------
//
// One block of 8 warps per (head, batch, 64-query tile); warp w owns 8
// query rows.  A tile is 64 keys.  S = Q K^T: lane (rg, kg) = (lane / 16,
// lane % 16) scores rows rg, rg + 2, rg + 4, rg + 6 of its warp against keys
// kg, kg + 16, kg + 32, kg + 48 (a 4 x 4 micro-tile), stepping through D
// four floats at a time: 4 16-byte loads of Q and 4 of K feed 64 FMAs.  The
// fold per row: the max over the 16 lanes of a row group (shuffles), a
// finite shift while the row is fully masked, each lane's own share of the
// row sum, added over the group at the end.  P goes to shared memory once a
// tile, with each row's rescale; O += P V: every lane owns all 8 rows of its
// warp and columns 4 lane + 128 i .. + 3 (i < C4, 1 up to D 128, else 2),
// so 8 16-byte loads of P (broadcast) and 4 C4 of V feed 128 C4 FMAs.  Q
// (float32, scaled into log2 units when staged), K and V rows are D + 4
// floats apart, an odd number of 16-byte chunks, so the rows a warp load
// touches fall on distinct banks.  K and V have a buffer each, filled by
// cp.async: V of tile t lands while S of tile t is computed, K of tile t +
// 1 while P V of tile t is (keys past Tk are zeros).  Every product and sum
// is a float32 FMA in a fixed order, so a repeated call gives the same
// bits.

constexpr int kSimtWarps = 8;
constexpr int kSimtThreads = 32 * kSimtWarps;
constexpr int kSimtWR = 8;                       // query rows a warp
constexpr int kSimtBq = kSimtWarps * kSimtWR;    // query rows a block: 64
constexpr int kSimtBk = 64;                      // keys a tile
constexpr int kSimtSR = 4;                       // rows a lane scores
constexpr int kSimtSK = 4;                       // keys a lane scores
constexpr int kSimtPld = kSimtBk + 16;  // P row stride: 2 rows on distinct
                                        // banks

// Dynamic shared memory of the simt kernel: Q [Bq][D + 4], K and V
// [Bk][D + 4], P [Bq][kSimtPld], each row's rescale and sum [2][Bq], all
// float32.
__host__ __device__ constexpr size_t simt_smem(int D) {
  return ((size_t)(kSimtBq + 2 * kSimtBk) * (D + 4) +
          (size_t)kSimtBq * (kSimtPld + 2)) *
         sizeof(float);
}

__device__ __forceinline__ float f4_at(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// C4: the 4-column groups of P V a lane owns; the instance takes D up to
// 128 C4.
template <int C4>
__global__ void __launch_bounds__(kSimtThreads, 1)
    flash_attention_simt_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, float* __restrict__ out, int T_len,
        int Tk, int D, int n_rep, int causal, long long q_sb, long long q_st,
        long long q_sh, long long k_sb, long long k_st, long long k_sh,
        long long v_sb, long long v_st, long long v_sh, long long o_sb,
        long long o_st, long long o_sh, float scale_log2) {
  constexpr int Bq = kSimtBq;
  constexpr int Bk = kSimtBk;
  const int ld = D + 4;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * Bq;  // longest tiles first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / n_rep;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rg = lane >> 4;  // S: row lane (rows rg + 2 r)
  const int kg = lane & 15;  // S: key lane (keys kg + 16 j)

  extern __shared__ __align__(16) float smem_f[];
  float* qs = smem_f;                  // [Bq][ld]
  float* ks = qs + Bq * ld;            // [Bk][ld]
  float* vs = ks + Bk * ld;            // [Bk][ld]
  float* ps = vs + Bk * ld;            // [Bq][kSimtPld]
  float* alpha_s = ps + Bq * kSimtPld;  // [Bq]
  float* l_s = alpha_s + Bq;            // [Bq]

  int n_kt = (Tk + Bk - 1) / Bk;
  if (causal) n_kt = min(n_kt, (q0 + Bq - 1) / Bk + 1);

  const float* kb = k + b * k_sb + kvh * k_sh;
  const float* vb = v + b * v_sb + kvh * v_sh;
  const int chunks = D / 4;  // 16-byte chunks of a row
  // tile t's rows of src (K or V) into dst; rows past Tk as zeros
  auto issue = [&](float* dst, const float* src, long long st, int t) {
    for (int i = tid; i < Bk * chunks; i += kSimtThreads) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * 4;
      const int key = t * Bk + r;
      if (key < Tk) {
        tt_cp_async16(dst + r * ld + c, src + key * st + c);
      } else {
        *reinterpret_cast<float4*>(dst + r * ld + c) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  if (n_kt > 0) issue(ks, kb, k_st, 0);
  tt_cp_async_commit();

  // the block's query rows in log2 units; rows past T are zeros
  const float* qb = q + b * q_sb + h * q_sh;
  for (int i = tid; i < Bq * chunks; i += kSimtThreads) {
    const int r = i / chunks;
    const int c = (i - r * chunks) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < T_len)
      x = *reinterpret_cast<const float4*>(qb + (q0 + r) * q_st + c);
    x.x *= scale_log2;
    x.y *= scale_log2;
    x.z *= scale_log2;
    x.w *= scale_log2;
    *reinterpret_cast<float4*>(qs + r * ld + c) = x;
  }

  const int wr0 = warp * kSimtWR;  // this warp's first row in the block
  const int wrow0 = q0 + wr0;      // ... and in the sequence
  const float* qw = qs + (wr0 + rg) * ld;     // S row r: + 2 r ld
  float* pw = ps + (wr0 + rg) * kSimtPld;     // S row r: + 2 r kSimtPld
  const float* pv_w = ps + wr0 * kSimtPld;    // P V row r: + r kSimtPld
  float o[kSimtWR][C4][4];
  float m[kSimtSR], l[kSimtSR];  // l: this lane's share of the row sum
#pragma unroll
  for (int r = 0; r < kSimtSR; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < kSimtWR; ++r)
#pragma unroll
    for (int i = 0; i < C4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[r][i][e] = 0.f;

  for (int t = 0; t < n_kt; ++t) {
    // K of tile t has landed and is visible; every warp is done with V of
    // tile t - 1, whose buffer V of tile t now fills
    tt_cp_async_wait<0>();
    __syncthreads();
    issue(vs, vb, v_st, t);
    tt_cp_async_commit();
    const int k0 = t * Bk;
    // causal: a warp whose rows all lie before this tile's first key
    // skips it (warp-uniform)
    const bool live = !causal || k0 <= wrow0 + kSimtWR - 1;
    if (live) {
      float s[kSimtSR][kSimtSK];
#pragma unroll
      for (int r = 0; r < kSimtSR; ++r)
#pragma unroll
        for (int j = 0; j < kSimtSK; ++j) s[r][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        float4 qv[kSimtSR];
#pragma unroll
        for (int r = 0; r < kSimtSR; ++r)
          qv[r] = *reinterpret_cast<const float4*>(qw + 2 * r * ld + d);
#pragma unroll
        for (int j = 0; j < kSimtSK; ++j) {
          const float4 kv =
              *reinterpret_cast<const float4*>(ks + (kg + 16 * j) * ld + d);
#pragma unroll
          for (int r = 0; r < kSimtSR; ++r) {
            float acc = s[r][j];
            acc = fmaf(qv[r].x, kv.x, acc);
            acc = fmaf(qv[r].y, kv.y, acc);
            acc = fmaf(qv[r].z, kv.z, acc);
            acc = fmaf(qv[r].w, kv.w, acc);
            s[r][j] = acc;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kSimtSR; ++r) {
        const int row = wrow0 + rg + 2 * r;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kSimtSK; ++j) {
          const int key = k0 + kg + 16 * j;
          if (key >= Tk || (causal && key > row)) s[r][j] = -INFINITY;
          mx = fmaxf(mx, s[r][j]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[r], mx);
        const float shift = tt_shift(m_new);
        const float alpha = isfinite(m[r]) ? exp2f(m[r] - shift) : 0.f;
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kSimtSK; ++j) {
          const float p = exp2f(s[r][j] - shift);
          pw[2 * r * kSimtPld + kg + 16 * j] = p;
          sum += p;
        }
        l[r] = l[r] * alpha + sum;
        if (kg == 0) alpha_s[wr0 + rg + 2 * r] = alpha;
      }
      __syncwarp();
    }
    // V of tile t has landed and is visible; every warp is done with K of
    // tile t, whose buffer K of tile t + 1 now fills
    tt_cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_kt) issue(ks, kb, k_st, t + 1);
    tt_cp_async_commit();
    if (live) {
#pragma unroll
      for (int r = 0; r < kSimtWR; ++r) {
        const float a = alpha_s[wr0 + r];
#pragma unroll
        for (int i = 0; i < C4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[r][i][e] *= a;
      }
#pragma unroll 2
      for (int j = 0; j < Bk; j += 4) {
        float4 pv[kSimtWR];
#pragma unroll
        for (int r = 0; r < kSimtWR; ++r)
          pv[r] = *reinterpret_cast<const float4*>(pv_w + r * kSimtPld + j);
#pragma unroll
        for (int i = 0; i < C4; ++i) {
          const int col = 4 * lane + 128 * i;
          if (col < D) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const float4 vv =
                  *reinterpret_cast<const float4*>(vs + (j + jj) * ld + col);
#pragma unroll
              for (int r = 0; r < kSimtWR; ++r) {
                const float p = f4_at(pv[r], jj);
                o[r][i][0] = fmaf(p, vv.x, o[r][i][0]);
                o[r][i][1] = fmaf(p, vv.y, o[r][i][1]);
                o[r][i][2] = fmaf(p, vv.z, o[r][i][2]);
                o[r][i][3] = fmaf(p, vv.w, o[r][i][3]);
              }
            }
          }
        }
      }
    }
  }
  tt_cp_async_wait<0>();

  // the row sums over the row group, normalise, store
#pragma unroll
  for (int r = 0; r < kSimtSR; ++r) {
    float lt = l[r];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    if (kg == 0) l_s[wr0 + rg + 2 * r] = lt == 0.f ? 1.f : lt;
  }
  __syncwarp();
  float* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < kSimtWR; ++r) {
    const float den = l_s[wr0 + r];
    const int row = wrow0 + r;
    if (row < T_len) {
      float* orow = ob + row * o_st;
#pragma unroll
      for (int i = 0; i < C4; ++i) {
        const int col = 4 * lane + 128 * i;
        if (col < D)
          *reinterpret_cast<float4*>(orow + col) =
              make_float4(o[r][i][0] / den, o[r][i][1] / den,
                          o[r][i][2] / den, o[r][i][3] / den);
      }
    }
  }
}

// -- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map of a bf16 [B, L, H, D] tensor with element strides (sb, sl,
// sh) and unit stride along D, read in 64 x 64 (d, l) boxes with the
// 128-byte swizzle; reads past L or D give zeros.
int make_map(CUtensorMap* map, const void* ptr, int B, int L, int H, int D,
             long long sb, long long sl, long long sh) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sl * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// D: the padded head dim (64, 128, 192, 256) of the instance; d the
// operands' own (a multiple of 8, d <= D).
template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int T, int Tk, int H, int Hkv, int d, int causal,
           const long long* st, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int rc = make_map(&mq, q, B, T, H, d, st[0], st[1], st[2]);
  if (rc == 0) rc = make_map(&mk, k, B, Tk, Hkv, d, st[3], st[4], st[5]);
  if (rc == 0) rc = make_map(&mv, v, B, Tk, Hkv, d, st[6], st[7], st[8]);
  if (rc != 0) return rc;
  constexpr int smem = Layout<D>::kBytes;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(H, B, (T + Layout<D>::kBq - 1) / Layout<D>::kBq);
  flash_attention_kernel<D><<<grid, Layout<D>::kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), T, Tk, d, H / Hkv,
      causal, st[9], st[10], st[11], scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int C4>
int launch_simt(const void* q, const void* k, const void* v, void* out,
                int B, int Tq, int Tk, int H, int Hkv, int D, int causal,
                const long long* st, float scale, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    // the most this instance takes: D = 128 C4
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_simt_kernel<C4>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)simt_smem(128 * C4));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(H, B, (Tq + kSimtBq - 1) / kSimtBq);
  flash_attention_simt_kernel<C4>
      <<<grid, kSimtThreads, simt_smem(D), stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(out), Tq, Tk, D,
          H / Hkv, causal, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
          st[7], st[8], st[9], st[10], st[11], scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// Routes, as tpuserver_torch/ops/flash.py::flash_route numbers them.
enum { TT_FLASH_WGMMA = 0, TT_FLASH_SIMT = 1 };

// Shapes and strides (in elements) are checked by the Python wrapper, which
// picks the route: `wgmma` takes bf16, `simt` float32, each with D a
// multiple of 8 from 8 to 256; a route given anything else returns
// cudaErrorInvalidValue before any launch.  H % Hkv == 0, 16-byte aligned
// rows.  `strides` holds q, k, v, out as (batch, time, head) triples.
extern "C" int tt_flash_attention(int dtype, int route, const void* q,
                                  const void* k, const void* v, void* out,
                                  int B, int T, int Tk, int H, int Hkv, int D,
                                  int causal, const long long* strides,
                                  float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D < 8 || D % 8 || D > 256) return (int)cudaErrorInvalidValue;
  if (route == TT_FLASH_WGMMA && dtype == TT_BF16) {
    if (D <= 64)
      return launch<64>(q, k, v, out, B, T, Tk, H, Hkv, D, causal, strides,
                        scale, st);
    if (D <= 128)
      return launch<128>(q, k, v, out, B, T, Tk, H, Hkv, D, causal, strides,
                         scale, st);
    if (D <= 192)
      return launch<192>(q, k, v, out, B, T, Tk, H, Hkv, D, causal, strides,
                         scale, st);
    return launch<256>(q, k, v, out, B, T, Tk, H, Hkv, D, causal, strides,
                       scale, st);
  }
  if (route == TT_FLASH_SIMT && dtype == TT_F32) {
    if (D <= 128)
      return launch_simt<1>(q, k, v, out, B, T, Tk, H, Hkv, D, causal,
                            strides, scale, st);
    return launch_simt<2>(q, k, v, out, B, T, Tk, H, Hkv, D, causal, strides,
                          scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The single-tile check: q, k, v contiguous bf16 [64, 128]; s fp32
// [64, 64]; o fp32 [64, 128].
extern "C" int tt_flash_tile_product(const void* q, const void* k,
                                     const void* v, float* s, float* o,
                                     void* stream) {
  CUtensorMap mq, mk, mv;
  int rc = make_map(&mq, q, 1, 64, 1, 128, 64 * 128, 128, 128);
  if (rc == 0) rc = make_map(&mk, k, 1, 64, 1, 128, 64 * 128, 128, 128);
  if (rc == 0) rc = make_map(&mv, v, 1, 64, 1, 128, 64 * 128, 128, 128);
  if (rc != 0) return rc;
  constexpr int smem = 1024 + 3 * 64 * 128 * 2 + 8;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        wgmma_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  wgmma_tile_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, s, o);
  return (int)cudaGetLastError();
}
