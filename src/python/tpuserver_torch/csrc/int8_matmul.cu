// W8A16 product for sm_90a, in two routes chosen by the activation dtype
// (tpuserver_torch/ops/quant.py::int8_route), q int8 [K, N] row-major (N
// contiguous, the reference's [in, out] layout) and s float32 [N] in both:
// - `mma` (tt_int8_matmul, the tensor cores): x bf16 [M, K] (row stride
//   ldx), y[M, N] = bf16( bf16(sum_k x[m,k] q[k,n]) * bf16(s[n]) ), the sum
//   accumulated in float32;
// - `simt` (tt_int8_matmul_f32, below the first): x float32, y[M, N] =
//   (sum_k x[m,k] q[k,n]) * s[n] in float32, every product and sum an FMA
//   on the CUDA cores.
// Anything else (another activation dtype, a weight that is not contiguous
// and 16-byte aligned) the wrapper refuses before any launch.  The notes
// below are the `mma` route's; the `simt` route's stand beside its kernel.
//
// Replaces: no Pallas kernel.  The JAX package's weight-only int8 product
// (tpuserver/ops/quant.py::matmul, decode-scale regime) is
// `x @ q.astype(x.dtype) * s`, which XLA fuses so that the weight's int8
// bytes are read once and converted in registers.  PyTorch has no such
// fusion (a bf16 copy of the weight is written and read back: 5 bytes a
// parameter against 1), so this kernel is its counterpart.
//
// Bound: bytes at decode (M 1 to 8: K*N weight bytes for 2*M*K*N
// operations, far below the H100's ~295 operations a byte).  The first
// form multiplied on the CUDA cores, whose FMA rate bound it from 8 rows
// on.  This one multiplies on the tensor cores, so what is left a weight
// byte is its conversion, the same at every M; what holds it back now is
// each launch's fixed latency (the ring's first fill, the warps' sum and
// the split tail) at the shapes whose bound is a few microseconds.
//
// MMA route: mma.sync.m16n8k16 (bf16 in, float32 sums) with the weight as
// the wide operand ("swap AB"): the MMA's 16 rows are 16 output columns,
// its 8 columns are 8 tokens, so at M <= 8 one n8 tile holds every row,
// and M up to 40 takes up to 5 tiles that share each converted weight
// fragment.  A (the weight) is built in registers: lane (g, t) reads its
// four k rows (2t, 2t+1, 2t+8, 2t+9 of each 16) as 16 bytes each, the
// columns 16g .. 16g+15, and pairs two rows' bytes of one column into a
// bf16x2.  int8 -> bf16 is exact: a byte permute onto 2^23 and a float
// subtraction give the integer as a float (8 significant bits at most, so
// its low 16 bits are 0), and a permute packs two such high halves.  B (x)
// is two 4-byte shared loads a lane.  wgmma (m64n8k16, A from registers)
// was not built: it would have four warps agree on every k step and issue
// the same conversion, which, not the MMA, is the work of each byte (the
// MMAs are about 5% of the instructions at 8 tokens).
//
// Weight stream: a block of 4 consumer warps and 1 producer warp owns 128
// columns and one split of K.  The producer walks the split in stages of
// 64 rows (8 KB, one 2-D TMA box of the [K, N] tensor, 128-byte swizzle,
// zeros past K and N) through a ring of kStages stages guarded by
// mbarriers (full: bytes landed; empty: the 4 warps have read it), so the
// consumers issue no load instruction for the weight.  One decode step's
// products at M 1 took 5.08 ms so against 5.28 with 16-byte cp.async per
// consumer thread (the ring's first form), and 5.07 against 5.86 with no
// ring, each warp loading its A fragments 4 k steps ahead into registers
// (tools/torch_kernel_ab.py, each pair in one call, NVIDIA H100 80GB HBM3
// at 700 W); 3 or 6 stages, 1024 blocks a launch, L2 promotion of 128 or
// no bytes and a prefetch of the tensor map measured no faster.  No L2
// evict-first hint: cp.async's L2::cache_hint (createpolicy, or the
// constant policy) stopped the kernel with an illegal instruction on the
// card, so the weight passes L2 as any load does.  Shapes whose N is no
// multiple of 16 (no TMA map) are staged by the producer's byte loads.
// The block's rows of x for its split (at most 1024 columns) wait in
// shared memory, padded by 8 columns a row so that the B loads hit
// distinct banks.
//
// Order contract: every element's sum over K runs in one order fixed by
// (K, N) alone.  Warp w sums its 16-row slice of each stage (MMAs along k
// in stage order), the 4 warps are added in warp order through shared
// memory, and with more than one split (``n_split`` and ``split_rows``
// come from the wrapper and depend on K and N only) the tile's last block
// to finish (a ticket counter, which is no part of the sum) adds the
// splits in split order.  M chooses only which token columns a block
// computes (1 to 5 n8 tiles), and an MMA's output column depends on its
// own B column alone, so a row's bits do not depend on the rows beside it
// and no sum goes through an atomic.  Rows past K (and past M) are staged
// as zeros, exact zero products.

#include <cuda.h>  // CUtensorMap and its enums (types only)

#include <string.h>

#include <mutex>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;                          // consumer warps
constexpr int kThreads = 32 * (kWarps + 1);        // and one producer warp
constexpr int kBlockN = 128;                       // columns a block
constexpr int kStageRows = 16 * kWarps;            // 64 k-rows a stage
constexpr int kStageBytes = kStageRows * kBlockN;  // 8 KB, one TMA box
constexpr int kStages = 4;                         // ring depth
constexpr int kMaxSplitRows = 1024;                // x's staged columns
constexpr int kXPad = 8;                           // bf16 pad of an x row
constexpr int kMaxTiles = 5;                       // n8 token tiles a block
constexpr int kRedBytes = kWarps * 32 * 32 * 4;    // the warps' sums
static_assert(kRedBytes <= kStages * kStageBytes, "sums reuse the ring");

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

// Wait until the phase of parity `parity` of the barrier has completed; a
// phase that never completes is a bug, and the kernel traps (the launch
// then fails) rather than holding the card forever.
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

// The box of 64 weight rows by 128 columns at (n0, k0) into shared memory,
// completing on `bar`; rows past K and columns past N arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int n0, int k0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(n0),
      "r"(k0)
      : "memory");
}

// 16 bytes global -> shared, or 16 zeros when !in (the source is then
// not read).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(in ? 16 : 0)
               : "memory");
}

// The consumer warps' own barrier (the producer warp takes no part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kWarps) : "memory");
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte b (0..3) of a word of int8 biased by 128 (w ^ 0x80808080), as the
// exact float of the int8: the byte becomes the low mantissa byte of 2^23
// (0x4B0000bb is 2^23 + bb), and 2^23 + 128 is subtracted.
__device__ __forceinline__ float i8_to_f32(uint32_t biased, int b) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 | b)) -
         8388736.f;
}

// Two exact floats (integers of at most 8 significant bits, so their low
// 16 bits are 0) as one bf16x2: lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The two roundings of the reference: the float32 sum to bf16, then its
// product with the bf16 scale.
__device__ __forceinline__ __nv_bfloat16 finish(float sum, float scale) {
  const float r = __bfloat162float(__float2bfloat16(sum));
  return __float2bfloat16(r * __bfloat162float(__float2bfloat16(scale)));
}

// Byte offset of 16-byte chunk c of stage row r: TMA's 128-byte swizzle
// (the chunk index XOR the row's low 3 bits), which puts the 8 lanes of
// each phase of the consumers' 16-byte reads on distinct banks.
__device__ __forceinline__ int stage_offset(int r, int c) {
  return r * kBlockN + 16 * (c ^ (r & 7));
}

// Column position of column c of token row tok in the warps' sums: the
// column's bits 5-6 move to bits 2-3 and the token's pair index to bits
// 0-1, so that a fragment store (8 g by 4 tg lanes) and a read of 32
// consecutive columns each fall on 32 distinct banks.
__device__ __forceinline__ int red_col(int c, int tok) {
  return c ^ (((c >> 5) & 3) << 2) ^ ((tok >> 1) & 3);
}

// NT: n8 token tiles of a block (MT = 8 NT rows).  TMA: N % 16 == 0 and
// the weight is read by the tensor map; else the producer warp loads
// bytes.  part: [n_split, M, N] float32 partial sums (unused with one
// split); tickets: one zeroed counter a tile, left zeroed again.  xvec:
// x's rows are 16-byte aligned.  Dynamic shared memory (1024-aligned for
// the swizzle): the ring, then x's tile [MT][split_rows + kXPad] bf16;
// after the K loop the ring takes the warps' sums, then the split tail's
// partial sums.
template <int NT, bool TMA>
__global__ void __launch_bounds__(kThreads, NT == 1 ? 4 : NT == 2 ? 3 : 1)
    w8a16_mma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __nv_bfloat16* __restrict__ x, long long ldx,
                     const int8_t* __restrict__ q, const float* __restrict__ s,
                     __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                     unsigned int* __restrict__ tickets, int M, int N, int K,
                     int split_rows, int xvec) {
  constexpr int MT = 8 * NT;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ bool last;
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(ring + kStages * kStageBytes);
  const int xs_ld = split_rows + kXPad;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n0 = blockIdx.x * kBlockN;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int m0 = blockIdx.z * MT;
  const int kbeg = split * split_rows;
  const int n_stages = split_rows / kStageRows;

  if (t == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], TMA ? 1 : 32);
      mbar_init(&empty[i], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {  // the producer: fills the ring, stage by stage
    for (int st = 0; st < n_stages; ++st) {
      const int slot = st % kStages;
      unsigned char* buf = ring + slot * kStageBytes;
      const int k0 = kbeg + st * kStageRows;
      if (TMA) {
        if (lane == 0) {
          mbar_wait(&empty[slot], ((st / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[slot], kStageBytes);
          tma_load_2d(buf, &tm_q, n0, k0, &full[slot]);
        }
      } else {
        mbar_wait(&empty[slot], ((st / kStages) & 1) ^ 1);
        for (int i = lane; i < kStageRows * 8; i += 32) {
          const int r = i >> 3, c = i & 7, k = k0 + r, n = n0 + 16 * c;
          uint32_t w[4] = {0u, 0u, 0u, 0u};
          if (k < K) {
            const int8_t* row = q + (long long)k * N;
#pragma unroll
            for (int b = 0; b < 16; ++b)
              if (n + b < N)
                w[b >> 2] |= (uint32_t)(uint8_t)__ldcs(row + n + b)
                             << (8 * (b & 3));
          }
          *reinterpret_cast<uint4*>(buf + stage_offset(r, c)) =
              make_uint4(w[0], w[1], w[2], w[3]);
        }
        mbar_arrive(&full[slot]);  // each lane: its stores are released
      }
    }
    return;
  }

  // x's tile: rows past M and columns past K are 0 (one 16-byte copy or
  // store a chunk of 8, else element by element); split_rows / 8 <= 128
  // chunks a row, one a thread
  const int k = 8 * t;
  for (int m = 0; m < MT && k < split_rows; ++m) {
    __nv_bfloat16* dst = xs + m * xs_ld + k;
    const __nv_bfloat16* src = x + (long long)(m0 + m) * ldx + kbeg + k;
    if (m0 + m >= M || kbeg + k >= K) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    } else if (xvec && kbeg + k + 8 <= K) {
      tt_cp_async16(dst, src);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = kbeg + k + e < K ? src[e] : __float2bfloat16(0.f);
    }
  }
  tt_cp_async_commit();
  tt_cp_async_wait<0>();
  consumers_sync();

  float acc[NT][8][4];
#pragma unroll
  for (int tt = 0; tt < NT; ++tt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[tt][j][e] = 0.f;

  // lane (g, tg) holds the weight rows 2tg, 2tg+1, 2tg+8, 2tg+9 of the
  // warp's 16 (MMA k as they are) and the 16 columns 16g .. 16g+15
  const int g = lane >> 2, tg = lane & 3;
  const int rows[4] = {16 * warp + 2 * tg, 16 * warp + 2 * tg + 1,
                       16 * warp + 2 * tg + 8, 16 * warp + 2 * tg + 9};
  for (int st = 0; st < n_stages; ++st) {
    const int slot = st % kStages;
    mbar_wait(&full[slot], (st / kStages) & 1);
    const unsigned char* buf = ring + slot * kStageBytes;
    uint32_t u[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          buf + stage_offset(rows[r], g));
      u[r][0] = v.x ^ 0x80808080u;
      u[r][1] = v.y ^ 0x80808080u;
      u[r][2] = v.z ^ 0x80808080u;
      u[r][3] = v.w ^ 0x80808080u;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);  // the warp's reads are done
    // B: token 8 tt + g at k 2tg, 2tg+1 and 2tg+8, 2tg+9
    uint32_t b[NT][2];
    const int kx = st * kStageRows + 16 * warp + 2 * tg;
#pragma unroll
    for (int tt = 0; tt < NT; ++tt) {
      const __nv_bfloat16* xr = xs + (8 * tt + g) * xs_ld + kx;
      b[tt][0] = *reinterpret_cast<const uint32_t*>(xr);
      b[tt][1] = *reinterpret_cast<const uint32_t*>(xr + 8);
    }
    // A of tile j: MMA row g is column 16g + 2j, row g + 8 column 16g +
    // 2j + 1
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int wd = j >> 1, by = 2 * (j & 1);
      float f[4][2];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        f[r][0] = i8_to_f32(u[r][wd], by);
        f[r][1] = i8_to_f32(u[r][wd], by + 1);
      }
      const uint32_t a[4] = {
          pack_bf16x2(f[0][0], f[1][0]), pack_bf16x2(f[0][1], f[1][1]),
          pack_bf16x2(f[2][0], f[3][0]), pack_bf16x2(f[2][1], f[3][1])};
#pragma unroll
      for (int tt = 0; tt < NT; ++tt)
        mma_bf16_16816(acc[tt][j], a, b[tt][0], b[tt][1]);
    }
  }
  consumers_sync();  // every stage is read: the ring takes the warps' sums

  // per token tile: the warps' sums as red[warp][token][column] (columns
  // XOR-swizzled so that both the fragment stores and the column reads
  // hit distinct banks), then thread ct adds column ct's over the warps in
  // warp order, for each token.  Fragment element e of tile j is token
  // 2tg + (e & 1), column 16g + 2j + (e >> 1).
  float* red = reinterpret_cast<float*>(ring);
  const int ct = t;  // the column, 0 .. 127
#pragma unroll
  for (int tt = 0; tt < NT; ++tt) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = 2 * tg + (e & 1), col = 16 * g + 2 * j + (e >> 1);
        red[(warp * 8 + tok) * kBlockN + red_col(col, tok)] = acc[tt][j][e];
      }
    consumers_sync();
    const int n = n0 + ct;
#pragma unroll
    for (int tok = 0; tok < 8; ++tok) {
      const int m = m0 + 8 * tt + tok;
      float sum = red[tok * kBlockN + red_col(ct, tok)];
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
        sum += red[(w * 8 + tok) * kBlockN + red_col(ct, tok)];
      if (m < M && n < N) {
        if (n_split == 1)
          y[(long long)m * N + n] = finish(sum, s[n]);
        else
          part[((long long)split * M + m) * N + n] = sum;
      }
    }
    consumers_sync();  // red is read before the next tile writes it
  }
  if (n_split == 1) return;

  // the tile's last block to finish adds the splits in split order.  The
  // partial sums come into the ring (free now) by 16-byte cp.async, as
  // many rows at a time as it holds for all splits, so that every load of
  // a batch is in flight at once; thread ct then adds column ct's.  Rows
  // of part that are not 16-byte aligned (N % 4 != 0) are read one value
  // at a time.  Either way a sum runs split 0, 1, 2, ... in order.
  __threadfence();
  consumers_sync();
  unsigned int* ticket = tickets + blockIdx.z * gridDim.x + blockIdx.x;
  if (ct == 0) last = atomicAdd(ticket, 1u) == (unsigned int)n_split - 1;
  consumers_sync();
  if (!last) return;
  __threadfence();
  const long long stride = (long long)M * N;
  const int n_rows = min(MT, M - m0);
  const int n = n0 + ct;
  const int per = kStages * kStageBytes / (n_split * kBlockN * 4);
  if (N % 4 == 0 && per > 0) {
    float* sums = reinterpret_cast<float*>(ring);  // [split][row][column]
    for (int mb = 0; mb < n_rows; mb += per) {
      const int nr = min(per, n_rows - mb);
      for (int c = ct; c < n_split * nr * (kBlockN / 4); c += 32 * kWarps) {
        const int q4 = c % (kBlockN / 4), jr = c / (kBlockN / 4);
        const int j = jr / nr, r = jr - j * nr, nc = n0 + 4 * q4;
        cp_async16_zfill(sums + jr * kBlockN + 4 * q4,
                         part + j * stride + (long long)(m0 + mb + r) * N +
                             min(nc, N - 4),
                         nc < N);
      }
      tt_cp_async_commit();
      tt_cp_async_wait<0>();
      consumers_sync();
      if (n < N)
        for (int r = 0; r < nr; ++r) {
          float sum = sums[r * kBlockN + ct];
          for (int j = 1; j < n_split; ++j)
            sum += sums[(j * nr + r) * kBlockN + ct];
          y[(long long)(m0 + mb + r) * N + n] = finish(sum, s[n]);
        }
      consumers_sync();  // read before the next batch lands
    }
  } else if (n < N) {
    for (int r = 0; r < n_rows; ++r) {
      const float* p = part + (long long)(m0 + r) * N + n;
      float sum = __ldcg(p);
      for (int j = 1; j < n_split; ++j) sum += __ldcg(p + j * stride);
      y[(long long)(m0 + r) * N + n] = finish(sum, s[n]);
    }
  }
  if (ct == 0) *ticket = 0u;  // zeroed for the next launch on the stream
}

// -- the simt route: float32 activations -------------------------------------
//
// y[M, N] = (sum_k x[m, k] q[k, n]) * s[n] with x float32 [M, K] (row stride
// ldx): every product and sum a float32 FMA on the CUDA cores (no TF32, no
// bf16 rounding of x), then the scale, in the JAX package's order (`x @
// q.astype(x.dtype) * s`: the product, then the scale).  A block of 4 warps
// owns 128 columns, up to 8 token rows and one split of K (int8_splits'
// cut, as the bf16 form); each lane owns 4 adjacent columns and reads their
// 4 weight bytes of a k row as one word (a warp reads 128 contiguous bytes
// of a row), 8 rows' words loaded ahead, and warp w sums the w-th quarter
// of the split's rows in order.  The warps' sums are added in warp order
// through shared memory; with more than one split the partial sums go to
// `part` and a second kernel adds the splits in split order and scales.
// Every element's order of summation is fixed by (K, N) alone, so a row's
// bits do not depend on the rows beside it.  Bound: bytes, as the bf16
// form's (K * N weight bytes for 2 * M * K * N operations at M <= 8).

constexpr int kF32Rows = 8;      // token rows a block
constexpr int kF32Ahead = 8;     // weight rows a lane loads ahead

// the 4 weight bytes of row k at columns n .. n + 3 (zeros past N); kWord:
// N % 4 == 0, so the 4 bytes are one aligned word
template <bool kWord>
__device__ __forceinline__ uint32_t weight_word(const int8_t* q, int k, int N,
                                                int n) {
  const int8_t* row = q + (long long)k * N;
  if (kWord)
    return n < N ? __ldcs(reinterpret_cast<const unsigned int*>(row + n))
                 : 0u;
  uint32_t w = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (n + b < N) w |= (uint32_t)(uint8_t)__ldcs(row + n + b) << (8 * b);
  return w;
}

template <bool kWord>
__global__ void __launch_bounds__(32 * kWarps) w8a32_kernel(
    const float* __restrict__ x, long long ldx, const int8_t* __restrict__ q,
    const float* __restrict__ s, float* __restrict__ y,
    float* __restrict__ part, int M, int N, int K, int split_rows) {
  __shared__ __align__(16) float red[kWarps][kF32Rows][kBlockN];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n0 = blockIdx.x * kBlockN;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int m0 = blockIdx.z * kF32Rows;
  const int rows = min(kF32Rows, M - m0);
  const int quarter = split_rows / kWarps;
  const int kbeg = split * split_rows + warp * quarter;
  const int kend = min(kbeg + quarter, K);
  const int nl = n0 + 4 * lane;  // this lane's first column
  const float* xb = x + (long long)m0 * ldx;

  float acc[kF32Rows][4];
#pragma unroll
  for (int m = 0; m < kF32Rows; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kF32Ahead) {
    uint32_t w[kF32Ahead];
#pragma unroll
    for (int u = 0; u < kF32Ahead; ++u)
      w[u] = k0 + u < kend ? weight_word<kWord>(q, k0 + u, N, nl) : 0u;
#pragma unroll
    for (int u = 0; u < kF32Ahead; ++u) {
      const int k = k0 + u;
      if (k >= kend) break;
      const uint32_t biased = w[u] ^ 0x80808080u;
      float f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) f[j] = i8_to_f32(biased, j);
#pragma unroll
      for (int m = 0; m < kF32Rows; ++m) {
        if (m < rows) {
          const float xv = __ldg(xb + m * ldx + k);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xv, f[j], acc[m][j]);
        }
      }
    }
  }

  // the warps' sums in warp order: thread t takes column n0 + t
#pragma unroll
  for (int m = 0; m < kF32Rows; ++m)
    *reinterpret_cast<float4*>(&red[warp][m][4 * lane]) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  const int n = n0 + t;
  if (n >= N) return;
  for (int m = 0; m < rows; ++m) {
    float sum = red[0][m][t];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += red[w][m][t];
    if (n_split == 1)
      y[(long long)(m0 + m) * N + n] = sum * s[n];
    else
      part[((long long)split * M + m0 + m) * N + n] = sum;
  }
}

// y = (the splits' partial sums, added in split order) * s
__global__ void __launch_bounds__(256) w8a32_combine_kernel(
    const float* __restrict__ part, const float* __restrict__ s,
    float* __restrict__ y, int M, int N, int n_split) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long mn = (long long)M * N;
  if (i >= mn) return;
  float sum = part[i];
  for (int j = 1; j < n_split; ++j) sum += part[j * mn + i];
  y[i] = sum * s[i % N];
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

// Tensor maps of int8 [K, N] weights (N % 16 == 0), read in boxes of 64
// rows by 128 columns with the 128-byte swizzle.  A map is a function of
// (pointer, K, N) alone, so it is kept by that key: a decode step reuses
// its 225 weights' maps instead of encoding each launch's anew.
struct MapEntry {
  const void* q;
  int K, N;
  CUtensorMap map;
};
constexpr int kMapSlots = 1024;
MapEntry g_maps[kMapSlots];
std::mutex g_maps_lock;

int weight_map(CUtensorMap* out, const void* q, int K, int N) {
  const uintptr_t key = reinterpret_cast<uintptr_t>(q);
  MapEntry& e = g_maps[((key >> 4) ^ (key >> 16) ^ (unsigned)K * 31u ^
                        (unsigned)N) % kMapSlots];
  std::lock_guard<std::mutex> hold(g_maps_lock);
  if (e.q != q || e.K != K || e.N != N) {
    EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
    const cuuint64_t strides[1] = {(cuuint64_t)N};
    const cuuint32_t box[2] = {kBlockN, kStageRows};
    const cuuint32_t unit[2] = {1, 1};
    const CUresult r = fn(&e.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                          const_cast<void*>(q), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) {
      e.q = nullptr;
      return (int)cudaErrorInvalidValue;
    }
    e.q = q;
    e.K = K;
    e.N = N;
  }
  *out = e.map;
  return 0;
}

template <int NT, bool TMA>
int launch_kind(const void* x, long long ldx, const void* q, const void* s,
                void* y, void* part, void* tickets, int M, int N, int K,
                int n_split, int split_rows, int xvec, cudaStream_t stream) {
  constexpr int kMaxSmem = 1024 + kStages * kStageBytes +
                           8 * NT * (kMaxSplitRows + kXPad) * 2;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        w8a16_mma_kernel<NT, TMA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  CUtensorMap map;
  if (TMA) {
    const int rc = weight_map(&map, q, K, N);
    if (rc != 0) return rc;
  } else {
    memset(&map, 0, sizeof(map));
  }
  const size_t smem = 1024 + kStages * kStageBytes +
                      (size_t)8 * NT * (split_rows + kXPad) * 2;
  const dim3 grid((N + kBlockN - 1) / kBlockN, n_split,
                  (M + 8 * NT - 1) / (8 * NT));
  w8a16_mma_kernel<NT, TMA><<<grid, kThreads, smem, stream>>>(
      map, static_cast<const __nv_bfloat16*>(x), ldx,
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(part),
      static_cast<unsigned int*>(tickets), M, N, K, split_rows, xvec);
  return (int)cudaGetLastError();
}

template <int NT>
int launch(const void* x, long long ldx, const void* q, const void* s,
           void* y, void* part, void* tickets, int M, int N, int K,
           int n_split, int split_rows, int xvec, cudaStream_t stream) {
  if (N % 16 == 0)
    return launch_kind<NT, true>(x, ldx, q, s, y, part, tickets, M, N, K,
                                 n_split, split_rows, xvec, stream);
  return launch_kind<NT, false>(x, ldx, q, s, y, part, tickets, M, N, K,
                                n_split, split_rows, xvec, stream);
}

}  // namespace

// y [M, N] bf16 (contiguous) = W8A16(x [M, K] bf16 with row stride ldx,
// q [K, N] int8 contiguous and 16-byte aligned, s [N] float32), K cut into
// n_split splits of split_rows rows (a multiple of 256, at most 1024); with
// more than one split, part is a float32 [n_split, M, N] scratch and
// tickets holds ceil(N / 128) * ceil(M / MT) zeroed counters (MT = the row
// tile below).  Returns the launch's cudaError_t.  The row tile follows M
// (8 NT rows, NT = ceil(M / 8) up to 5), which changes no element's order
// of summation.
extern "C" int tt_int8_matmul(const void* x, long long ldx, const void* q,
                              const void* s, void* y, void* part,
                              void* tickets, int M, int N, int K,
                              int n_split, int split_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1 || n_split < 1 || split_rows % 256 ||
      split_rows > kMaxSplitRows || (long long)n_split * split_rows < K ||
      (n_split > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int xvec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && ldx % 8 == 0;
  const int nt = (M + 7) / 8;
  if (nt <= 1)
    return launch<1>(x, ldx, q, s, y, part, tickets, M, N, K, n_split,
                     split_rows, xvec, st);
  if (nt == 2)
    return launch<2>(x, ldx, q, s, y, part, tickets, M, N, K, n_split,
                     split_rows, xvec, st);
  if (nt == 3)
    return launch<3>(x, ldx, q, s, y, part, tickets, M, N, K, n_split,
                     split_rows, xvec, st);
  if (nt == 4)
    return launch<4>(x, ldx, q, s, y, part, tickets, M, N, K, n_split,
                     split_rows, xvec, st);
  return launch<kMaxTiles>(x, ldx, q, s, y, part, tickets, M, N, K, n_split,
                           split_rows, xvec, st);
}

// y [M, N] float32 (contiguous) = (x [M, K] float32 with row stride ldx, as
// int8 q [K, N] contiguous and 16-byte aligned) * s [N] float32, every sum a
// float32 FMA; K cut into n_split splits of split_rows rows (a multiple of
// 256, at most 1024), as tt_int8_matmul cuts it; with more than one split,
// part is a float32 [n_split, M, N] scratch.  Returns the launches'
// cudaError_t.
extern "C" int tt_int8_matmul_f32(const void* x, long long ldx, const void* q,
                                  const void* s, void* y, void* part, int M,
                                  int N, int K, int n_split, int split_rows,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1 || n_split < 1 || split_rows % 256 ||
      split_rows > kMaxSplitRows || (long long)n_split * split_rows < K ||
      (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBlockN - 1) / kBlockN, n_split,
                  (M + kF32Rows - 1) / kF32Rows);
  const float* xf = static_cast<const float*>(x);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* sf = static_cast<const float*>(s);
  float* yf = static_cast<float*>(y);
  float* pf = static_cast<float*>(part);
  if (N % 4 == 0)
    w8a32_kernel<true><<<grid, 32 * kWarps, 0, st>>>(
        xf, ldx, qi, sf, yf, pf, M, N, K, split_rows);
  else
    w8a32_kernel<false><<<grid, 32 * kWarps, 0, st>>>(
        xf, ldx, qi, sf, yf, pf, M, N, K, split_rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  const long long mn = (long long)M * N;
  w8a32_combine_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(
      pf, sf, yf, M, N, n_split);
  return (int)cudaGetLastError();
}
