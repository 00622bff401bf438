// Exact attention forward (flash attention), causal or not, for sm_90a.
//
// Replaces the TPU kernel tpuserver/ops/flash.py::flash_attention
// (_attn_kernel, with _online_softmax_fold and _fold_finish).
//
//   q [B, T, H, D], k/v [B, Tk, Hkv, D] -> out [B, T, H, D]
//
// Bound on the H100: bytes at the main path's prompt length, operations
// beyond it.  Causal attention at Llama-3-8B prefill shapes (T 512, H 32,
// Hkv 8, D 128, bf16, GQA read natively) does about 2.15 GFLOP per layer
// against 10.5 MB of q/k/v/out: about 205 operations per byte, below the
// ~295 where the tensor cores would limit.  So the least time is the
// bytes', about 3.1 us at 3.35 TB/s (2.2 us for the operations at 989
// TFLOP/s).  At T 2048 the same layer does 34.4 GFLOP on 42 MB and is
// operation-bound (about 35 us).
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
//   wgmma.mma_async m64nDk16 with P (rounded to bf16, as the TPU kernel
//   does) from registers and V read from shared memory through a transposed
//   (MN-major) descriptor.  Scores, probabilities and the output accumulator
//   stay in registers, with the softmax state in fp32.  Each warpgroup
//   runs S, softmax and P V in turn; the other warpgroup's work fills the
//   gaps;
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
// - rows past T and keys past Tk arrive as zeros from TMA and are masked;
// - this route (`wgmma`) takes bf16 with D 64 or 128, the head dims of
//   every Llama-3 preset.
//
// Everything else the TPU kernel takes (float32 at any head dim, bf16 at
// any other multiple of 8 up to 256) runs on a second kernel, the `simt`
// route (flash_attention_simt_kernel, below): the same online softmax on
// the CUDA cores, every product and sum a float32 FMA (no TF32, no tensor
// core), so float32 sums stay float32 as the port's float32 runs (TF32
// off) rely on.  Its bound is operations: at Llama-3-8B prefill shapes in
// float32 (T 512) the 2.15 GFLOP of a layer take about 32 us at the card's
// 67 TFLOP/s of float32 FMA, against about 6 us for the 21 MB.  The
// wrapper (tpuserver_torch/ops/flash.py::flash_route) picks the route from
// (dtype, D) before the launch and raises only for what neither takes: a
// dtype other than float32 or bf16, D not a multiple of 8 or above 256,
// rows that are not 16-byte aligned.
// Left for later work: fewer exp2 on the special-function unit (part of
// them as polynomials on the FMA units), a persistent schedule, loading
// each K/V tile once for the n_rep heads that share it, and a TMA store of
// the output.
//
// The fold keeps a finite shift for rows that are still fully masked and
// maps l == 0 to 1.  The tensor maps are encoded on the host with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
// library needs no link against the driver library.

#include <cuda.h>  // CUtensorMap and its enums (types only)

#include "common.cuh"

namespace {

constexpr int kBq = 128;  // query rows per block
constexpr int kBk = 64;   // keys per tile
constexpr int kStages = 2;
constexpr int kConsumers = 256;  // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kBox = 64 * 64 * 2;  // bytes of one 64 x 64 bf16 TMA box

template <int D>
struct Layout {
  static constexpr int kQ = kBq * D * 2;   // [2 halves][D / 64][64][64]
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
// bytes), the next 64-wide column block is one box (kBox bytes) on.
template <int D>
__device__ __forceinline__ void pv_issue(float* o, const uint32_t (*pa)[4],
                                         uint32_t v_addr) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBk / 16; ++kk) {
    const uint64_t desc = smem_desc(v_addr + kk * 16 * 128, kBox);
    if constexpr (D == 128) {
      wgmma_rs_n128(o, pa[kk], desc);
    } else {
      wgmma_rs_n64(o, pa[kk], desc);
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

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
    int T, int Tk, int n_rep, int causal, long long o_sb, long long o_st,
    long long o_sh, float scale_log2) {
  using L = Layout<D>;
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
      for (int half = 0; half < 2; ++half)
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

// -- the simt route: float32, and bf16 at head dims other than 64 and 128 ----
//
// One block of 4 warps per (query tile, head, batch); warp w owns R query
// rows.  A K/V tile is 32 keys, one a lane, in a 2-stage shared-memory ring
// filled by cp.async (keys past Tk are zeroed), so the next tile is in
// flight while this one is computed.  S = Q K^T: lane j scores key j
// against the warp's R rows, reading its key row 16 bytes at a time once
// for all of them, the rows' Q (float32, scaled into log2 units when
// staged) as broadcasts.  The fold: each row's max over the warp
// (shuffles), a finite shift while the row is fully masked, and each lane's
// own share of the row sum, added over the warp at the end.  P passes
// through shared memory ([R][32] a warp), rounded to bf16 first for bf16
// operands as the TPU kernel rounds it (the row sum keeps the float32 P, as
// there); O += P V: lane l owns output columns l, l + 32, ... (NC =
// ceil(D / 32) of them), and each V element it reads serves all R rows.
// Every product and sum is a float32 FMA in a fixed order, so a repeated
// call gives the same bits.

constexpr int kSimtWarps = 4;
constexpr int kSimtThreads = 32 * kSimtWarps;
constexpr int kSimtBk = 32;  // keys a tile, one a lane

// query rows a warp: 16, or 8 where a lane's NC output columns are more
// than 4 (D above 128), to keep R x NC accumulators in registers
template <int NC>
struct SimtRows {
  static constexpr int R = NC <= 4 ? 16 : 8;
  static constexpr int Bq = kSimtWarps * R;
};

// Row stride (elements) of a K/V tile row in shared memory: an odd number
// of 16-byte chunks, so that each phase of 8 lanes reading 16 bytes of 8
// different key rows falls on distinct banks.
template <typename T>
__host__ __device__ constexpr int simt_ld(int D) {
  return (((D * (int)sizeof(T) / 16) | 1) * 16) / (int)sizeof(T);
}

// Dynamic shared memory of the simt kernel: Q [Bq][D] float32, the K/V
// ring [2 stages][K, V][32][ld], P [warps][R][32] float32.
template <typename T>
__host__ __device__ constexpr size_t simt_smem(int D, int R) {
  return (size_t)kSimtWarps * R * D * 4 +
         (size_t)2 * 2 * kSimtBk * simt_ld<T>(D) * sizeof(T) +
         (size_t)kSimtWarps * R * kSimtBk * 4;
}

__device__ __forceinline__ float tt_to_float(float x) { return x; }
__device__ __forceinline__ float tt_to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// P as the P.V product takes it: float32 as it is, bf16-rounded for bf16
// operands.
__device__ __forceinline__ float p_operand(float p, const float*) {
  return p;
}
__device__ __forceinline__ float p_operand(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}

template <typename T, int NC>
__global__ void __launch_bounds__(kSimtThreads) flash_attention_simt_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int T_len, int Tk, int D, int n_rep, int causal,
    long long q_sb, long long q_st, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, long long o_sb, long long o_st, long long o_sh,
    float scale_log2) {
  constexpr int R = SimtRows<NC>::R;
  constexpr int Bq = SimtRows<NC>::Bq;
  constexpr int E = 16 / (int)sizeof(T);  // elements of a 16-byte chunk
  const int ld = simt_ld<T>(D);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * Bq;  // longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / n_rep;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [Bq][D]
  T* kvs = reinterpret_cast<T*>(qs + Bq * D);      // [2][2][kSimtBk][ld]
  float* ps = reinterpret_cast<float*>(kvs + 2 * 2 * kSimtBk * ld);

  int n_kt = (Tk + kSimtBk - 1) / kSimtBk;
  if (causal) n_kt = min(n_kt, (q0 + Bq - 1) / kSimtBk + 1);

  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  const int chunks = D / E;  // 16-byte chunks of a row
  // tile t's K and V rows into ring stage t % 2; rows past Tk as zeros
  auto issue = [&](int t) {
    T* ks = kvs + (t & 1) * 2 * kSimtBk * ld;
    T* vs = ks + kSimtBk * ld;
    for (int i = tid; i < kSimtBk * chunks; i += kSimtThreads) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * E;
      const int key = t * kSimtBk + r;
      if (key < Tk) {
        tt_cp_async16(ks + r * ld + c, kb + key * k_st + c);
        tt_cp_async16(vs + r * ld + c, vb + key * v_st + c);
      } else {
        *reinterpret_cast<uint4*>(ks + r * ld + c) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vs + r * ld + c) = make_uint4(0, 0, 0, 0);
      }
    }
  };
  if (n_kt > 0) issue(0);
  tt_cp_async_commit();

  // the block's query rows as float32 in log2 units; rows past T are zeros
  const T* qb = q + b * q_sb + h * q_sh;
  for (int i = tid; i < Bq * (D / 8); i += kSimtThreads) {
    const int r = i / (D / 8);
    const int c = (i - r * (D / 8)) * 8;
    float x[8];
    if (q0 + r < T_len) {
      tt_load8(qb + (q0 + r) * q_st + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) qs[r * D + c + e] = x[e] * scale_log2;
  }

  const int row0 = q0 + warp * R;  // this warp's first query row
  const float* qw = qs + warp * R * D;
  float* pw = ps + warp * R * kSimtBk;
  float o[R][NC];
  float m[R], l[R];  // l: this lane's share of the row sum
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) o[r][i] = 0.f;
  }

  for (int t = 0; t < n_kt; ++t) {
    // tile t + 1 goes out; tile t has landed once at most that group is
    // pending, and the barrier makes every thread's copies visible
    if (t + 1 < n_kt) issue(t + 1);
    tt_cp_async_commit();
    tt_cp_async_wait<1>();
    __syncthreads();
    const T* ks = kvs + (t & 1) * 2 * kSimtBk * ld;
    const T* vs = ks + kSimtBk * ld;
    const int k0 = t * kSimtBk;
    // causal: a warp whose rows all lie before this tile's first key
    // skips it (warp-uniform)
    if (!causal || k0 <= row0 + R - 1) {
      float s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = 0.f;
      const T* krow = ks + lane * ld;
      for (int c = 0; c < D; c += 8) {
        float kv[8];
        tt_load8(krow + c, kv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(qw + r * D + c);
          const float4 z = *reinterpret_cast<const float4*>(qw + r * D + c +
                                                            4);
          float acc = s[r];
          acc = fmaf(a.x, kv[0], acc);
          acc = fmaf(a.y, kv[1], acc);
          acc = fmaf(a.z, kv[2], acc);
          acc = fmaf(a.w, kv[3], acc);
          acc = fmaf(z.x, kv[4], acc);
          acc = fmaf(z.y, kv[5], acc);
          acc = fmaf(z.z, kv[6], acc);
          acc = fmaf(z.w, kv[7], acc);
          s[r] = acc;
        }
      }
      const int key = k0 + lane;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x =
            (key >= Tk || (causal && key > row0 + r)) ? -INFINITY : s[r];
        float mx = x;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[r], mx);
        const float shift = tt_shift(m_new);
        const float alpha = isfinite(m[r]) ? exp2f(m[r] - shift) : 0.f;
        const float p = exp2f(x - shift);
        m[r] = m_new;
        l[r] = l[r] * alpha + p;
#pragma unroll
        for (int i = 0; i < NC; ++i) o[r][i] *= alpha;
        pw[r * kSimtBk + lane] = p_operand(p, q);
      }
      __syncwarp();
      for (int j = 0; j < kSimtBk; j += 4) {
        float vv[4][NC];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            const int col = lane + 32 * i;
            vv[jj][i] = col < D ? tt_to_float(vs[(j + jj) * ld + col]) : 0.f;
          }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(pw + r * kSimtBk + j);
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            float acc = o[r][i];
            acc = fmaf(p4.x, vv[0][i], acc);
            acc = fmaf(p4.y, vv[1][i], acc);
            acc = fmaf(p4.z, vv[2][i], acc);
            acc = fmaf(p4.w, vv[3][i], acc);
            o[r][i] = acc;
          }
        }
      }
    }
    // every warp is done with stage t % 2 (and its P) before the next
    // iteration issues tile t + 2 into it
    __syncthreads();
  }
  tt_cp_async_wait<0>();

  // the row sums over the warp, normalise, store
  T* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float lt = l[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    lt = lt == 0.f ? 1.f : lt;
    const int row = row0 + r;
    if (row < T_len) {
      T* orow = ob + row * o_st;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int col = lane + 32 * i;
        if (col < D) tt_store(orow + col, o[r][i] / lt);
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

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int T, int Tk, int H, int Hkv, int causal, const long long* st,
           float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int rc = make_map(&mq, q, B, T, H, D, st[0], st[1], st[2]);
  if (rc == 0) rc = make_map(&mk, k, B, Tk, Hkv, D, st[3], st[4], st[5]);
  if (rc == 0) rc = make_map(&mv, v, B, Tk, Hkv, D, st[6], st[7], st[8]);
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
  dim3 grid(H, B, (T + kBq - 1) / kBq);
  flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), T, Tk, H / Hkv, causal,
      st[9], st[10], st[11], scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <typename T, int NC>
int launch_simt(const void* q, const void* k, const void* v, void* out,
                int B, int Tq, int Tk, int H, int Hkv, int D, int causal,
                const long long* st, float scale, cudaStream_t stream) {
  constexpr int R = SimtRows<NC>::R;
  constexpr int Bq = SimtRows<NC>::Bq;
  static bool attr_set = false;
  if (!attr_set) {
    // the most this instance takes: D = 32 NC
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_simt_kernel<T, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)simt_smem<T>(32 * NC, R));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((Tq + Bq - 1) / Bq, H, B);
  flash_attention_simt_kernel<T, NC>
      <<<grid, kSimtThreads, simt_smem<T>(D, R), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out), Tq, Tk, D, H / Hkv,
          causal, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
          st[8], st[9], st[10], st[11], scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_simt(const void* q, const void* k, const void* v, void* out,
                  int B, int Tq, int Tk, int H, int Hkv, int D, int causal,
                  const long long* st, float scale, cudaStream_t stream) {
  switch ((D + 31) / 32) {
    case 1:
      return launch_simt<T, 1>(q, k, v, out, B, Tq, Tk, H, Hkv, D, causal, st,
                               scale, stream);
    case 2:
      return launch_simt<T, 2>(q, k, v, out, B, Tq, Tk, H, Hkv, D, causal, st,
                               scale, stream);
    case 3:
      return launch_simt<T, 3>(q, k, v, out, B, Tq, Tk, H, Hkv, D, causal, st,
                               scale, stream);
    case 4:
      return launch_simt<T, 4>(q, k, v, out, B, Tq, Tk, H, Hkv, D, causal, st,
                               scale, stream);
    case 5:
      return launch_simt<T, 5>(q, k, v, out, B, Tq, Tk, H, Hkv, D, causal, st,
                               scale, stream);
    case 6:
      return launch_simt<T, 6>(q, k, v, out, B, Tq, Tk, H, Hkv, D, causal, st,
                               scale, stream);
    case 7:
      return launch_simt<T, 7>(q, k, v, out, B, Tq, Tk, H, Hkv, D, causal, st,
                               scale, stream);
    case 8:
      return launch_simt<T, 8>(q, k, v, out, B, Tq, Tk, H, Hkv, D, causal, st,
                               scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Routes, as tpuserver_torch/ops/flash.py::flash_route numbers them.
enum { TT_FLASH_WGMMA = 0, TT_FLASH_SIMT = 1 };

// Shapes and strides (in elements) are checked by the Python wrapper, which
// picks the route: `wgmma` takes bf16 with D 64 or 128, `simt` float32 or
// bf16 with D a multiple of 8 from 8 to 256; a route given anything else
// returns cudaErrorInvalidValue before any launch.  H % Hkv == 0, 16-byte
// aligned rows.  `strides` holds q, k, v, out as (batch, time, head)
// triples.
extern "C" int tt_flash_attention(int dtype, int route, const void* q,
                                  const void* k, const void* v, void* out,
                                  int B, int T, int Tk, int H, int Hkv, int D,
                                  int causal, const long long* strides,
                                  float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == TT_FLASH_WGMMA && dtype == TT_BF16) {
    if (D == 64)
      return launch<64>(q, k, v, out, B, T, Tk, H, Hkv, causal, strides,
                        scale, st);
    if (D == 128)
      return launch<128>(q, k, v, out, B, T, Tk, H, Hkv, causal, strides,
                         scale, st);
    return (int)cudaErrorInvalidValue;
  }
  if (route != TT_FLASH_SIMT || D < 8 || D % 8 || D > 256)
    return (int)cudaErrorInvalidValue;
  if (dtype == TT_F32)
    return dispatch_simt<float>(q, k, v, out, B, T, Tk, H, Hkv, D, causal,
                                strides, scale, st);
  if (dtype == TT_BF16)
    return dispatch_simt<__nv_bfloat16>(q, k, v, out, B, T, Tk, H, Hkv, D,
                                        causal, strides, scale, st);
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
