// Exact attention forward (flash attention), causal or not, for sm_90a.
//
// Replaces the TPU kernel tpuserver/ops/flash.py::flash_attention
// (_attn_kernel, with _online_softmax_fold and _fold_finish).
//
//   q [B, T, H, D], k/v [B, Tk, Hkv, D] -> out [B, T, H, D]
//
// Bound on the H100: bytes, at the main path's shapes.  Causal attention at
// Llama-3-8B prefill shapes (T 512, H 32, Hkv 8, D 128, bf16, GQA read
// natively) does about 2.15 GFLOP per layer against 10.5 MB of q/k/v/out:
// about 205 operations per byte, below the ~295 where the tensor cores would
// limit.  So the least time is the bytes', about 3.1 us at 3.35 TB/s
// (2.2 us for the operations at 989 TFLOP/s).  Longer prompts cross the
// ridge: at T 2048 the same layer is operation-bound.
//
// What the design does about it:
// - tensor cores through mma.sync m16n8k16 with fp32 accumulation.  One
//   block of 4 warps per (batch, head, 64-query tile); each warp owns 16
//   query rows and keeps its Q fragments, its score tile and its output
//   accumulator in registers, so the scores and probabilities never reach
//   device memory.  K/V tiles of 64 keys are staged in (padded) shared
//   memory.  Causal blocks stop at the diagonal.
// - GQA is native: the block reads kv head h / (H / Hkv), so the caller
//   never expands K/V in memory (the TPU path expanded them first).
// - operands are bf16 with D 64 or 128, the head dims of every Llama-3
//   preset; the wrapper raises for anything else on the card.
// Left for later work: wgmma with TMA-fed shared-memory rings, ldmatrix,
// double-buffered K/V loads, and a persistent schedule.
//
// The softmax state is fp32, the probabilities are rounded to the operand
// type before the P.V product (as the TPU kernel does), and the fold keeps a
// finite shift for rows that are still fully masked.

#include "common.cuh"

namespace {

constexpr int kBq = 64;  // query rows per block (16 per warp)
constexpr int kBk = 64;  // keys per tile
constexpr int kWarps = 4;

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(kBq + 2 * kBk) * (D + 8);
}

// Copy rows [r0, r0 + rows) of one head into a padded shared tile; rows past
// `limit` are zero.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int r0,
                                          int rows, int limit, int tid) {
  constexpr int kLd = D + 8;
  constexpr int kVecs = D / 8;
  for (int i = tid; i < rows * kVecs; i += kWarps * 32) {
    const int r = i / kVecs, c = (i - r * kVecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32) flash_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int T, int Tk, int n_rep, int causal, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long o_sb,
    long long o_st, long long o_sh, float scale) {
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBq * kLd;
  __nv_bfloat16* vs = ks + kBk * kLd;

  const int q0 = blockIdx.x * kBq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / n_rep;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // row within the warp's 8-row half
  const int tig = lane & 3;   // thread within the row's quad

  load_tile<D>(qs, q + b * q_sb + h * q_sh, q_st, q0, kBq, T, tid);
  __syncthreads();

  // this warp's Q rows as mma A fragments, for every 16-wide slice of D
  const int wr = warp * 16 + gid;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tig * 2;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(qs + wr * kLd + c);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(qs + (wr + 8) * kLd + c);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(qs + wr * kLd + c + 8);
    qf[kk][3] =
        *reinterpret_cast<const uint32_t*>(qs + (wr + 8) * kLd + c + 8);
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {0.f, 0.f};  // this thread's share of the row sums
  const int qpos[2] = {q0 + wr, q0 + wr + 8};

  int n_tiles = (Tk + kBk - 1) / kBk;
  if (causal) n_tiles = min(n_tiles, (q0 + kBq - 1) / kBk + 1);
  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBk;
    __syncthreads();  // the previous tile is consumed
    load_tile<D>(ks, kb, k_st, k0, kBk, Tk, tid);
    load_tile<D>(vs, vb, v_st, k0, kBk, Tk, tid);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[kBk / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = ks + (nt * 8 + gid) * kLd + tig * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_bf16_16816(s[nt], qf[kk], b0, b1);
      }
    }

    // scale, mask, and the row maxima over the quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + nt * 8 + tig * 2 + (i & 1);
        const int r = i >> 1;
        float x = s[nt][i] * scale;
        if (col >= Tk || (causal && col > qpos[r])) x = -INFINITY;
        s[nt][i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float alpha[2], shift[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_row[r], mx[r]);
      shift[r] = tt_shift(m_new);
      alpha[r] = tt_alpha(m_row[r], shift[r]);
      m_row[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[nt][i] - shift[i >> 1]);
        s[nt][i] = p;
        rs[i >> 1] += p;
      }
    }
    l_row[0] = l_row[0] * alpha[0] + rs[0];
    l_row[1] = l_row[1] * alpha[1] + rs[1];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V: the score accumulators re-packed as A fragments
#pragma unroll
    for (int j = 0; j < kBk / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      const __nv_bfloat16* vrow = vs + (j * 16 + tig * 2) * kLd + gid;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vp = vrow + dt * 8;
        const uint32_t b0 = pack_bf16(vp[0], vp[kLd]);
        const uint32_t b1 = pack_bf16(vp[8 * kLd], vp[9 * kLd]);
        mma_bf16_16816(o[dt], a, b0, b1);
      }
    }
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
    __nv_bfloat16* orow = ob + qpos[r] * o_st + tig * 2;
    const float inv = 1.f / l_row[r];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const uint32_t packed =
          pack_bf16(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
      *reinterpret_cast<uint32_t*>(orow + dt * 8) = packed;
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int T, int Tk, int H, int n_rep, int causal, const long long* st,
               float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_mma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((T + kBq - 1) / kBq, H, B);
  flash_attention_mma_kernel<D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      T, Tk, n_rep, causal, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes and strides (in elements) are checked by the Python wrapper:
// bf16 operands, D in {64, 128}, H % Hkv == 0, 16-byte aligned rows.
// `strides` holds q, k, v, out as (batch, time, head) triples.
extern "C" int tt_flash_attention(int dtype, const void* q, const void* k,
                                  const void* v, void* out, int B, int T,
                                  int Tk, int H, int Hkv, int D, int causal,
                                  const long long* strides, float scale,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_rep = H / Hkv;
  if (dtype != TT_BF16) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return launch_mma<64>(q, k, v, out, B, T, Tk, H, n_rep, causal, strides,
                          scale, st);
  if (D == 128)
    return launch_mma<128>(q, k, v, out, B, T, Tk, H, n_rep, causal, strides,
                           scale, st);
  return (int)cudaErrorInvalidValue;
}
