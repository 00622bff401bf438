// Single-query decode attention over a padded KV cache, for sm_90a:
// split-K ("flash-decoding").
//
// Replaces the TPU kernel tpuserver/ops/flash.py::decode_attention
// (_decode_kernel, with _online_softmax_fold and _fold_finish).
//
//   q [B, H, D], k/v cache [B, S, Hkv, D], lengths [B] int32 -> out [B, H, D]
//
// Bound on the H100: memory.  The work is 2 * len * Hkv * D multiply-adds per
// query head group against 2 * len * Hkv * D * sizeof(T) bytes of cache, far
// below the ~295 operations per byte where the tensor cores would limit.  At
// Llama-3-8B shapes (Hkv 8, D 128, bf16) and len 4096 that is 16.8 MB per
// layer, about 5 us at 3.35 TB/s.  Reaching that rate takes many SMs with
// many bytes in flight on each: one block per (row, kv head) is 8 blocks for
// one 8B stream, 8 of 132 SMs.
//
// What the design does about it:
// - grid (n_split, Hkv, B): the wrapper picks n_split from B, Hkv, S and the
//   SM count only (about two blocks per SM, at least 64 cache keys a split),
//   never from `lengths`, which stay on the device.  Each block cuts
//   [0, lengths[b]) itself into n_split near-equal ranges aligned to 16 keys,
//   so every split has work at any length up to its share; a block whose
//   range is empty writes m = -inf, l = 0 and a zero accumulator;
// - inside a block, K/V tiles stream through a 3-stage shared-memory ring
//   filled with cp.async: two tiles are in flight while one is scored, and
//   each tile costs one block-wide barrier;
// - the n_rep = H / Hkv query heads that share a kv head read each K/V row
//   once from shared memory, so GQA is never expanded; no key at or past
//   lengths[b] is read;
// - bf16 with D 64 or 128 (every Llama-3 preset) runs on the tensor cores:
//   each of 4 warps takes 16 keys of a 64-key tile, S = Q K^T and P V are
//   mma.sync m16n8k16 with the kv head's query heads as the MMA rows and
//   ldmatrix(.trans) fragments, and each warp keeps its own online-softmax
//   state.  Q and K enter as they are (their products are exact in fp32),
//   P as two bf16 terms (hi + lo), so P.V keeps about 16 bits of P.
//   Without this the per-key arithmetic (a dot product reduced
//   across lanes by shuffles) took longer than the loads it waited on;
// - float32 and other head dims take a SIMT kernel: a team of D / 8 lanes
//   per key row, each team with its own online-softmax state, folding 8
//   keys at a time;
// - the warps' (or teams') states merge in a fixed order at the end of the
//   block;
// - the splits' fp32 partials (acc [B, Hkv, n_split, n_rep, D], m and l
//   [B, Hkv, n_split, n_rep]) are combined by a second small kernel in split
//   order, launched by the same C call.  With n_split == 1 the main kernel
//   writes the output itself and the combine is not launched.
// Left for later work: reading a page table in-kernel, and a persistent
// schedule that would not need the partials.
//
// The softmax state is fp32, as in the TPU kernel; every fold keeps a finite
// shift for rows whose max is still -inf and maps l == 0 to 1, so a row with
// length 0 returns zeros, and no (-inf) - (-inf) reaches an exp.  Every sum
// runs in a fixed order, so a repeated call gives the same bits.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 3;  // K/V tiles in the ring
constexpr int kGroup = 8;   // keys a team scores before folding them
constexpr int kMaxSplit = 64;

// keys per tile: 16 KB of K and 16 KB of V per stage, 16 to 64 keys
template <typename T>
__host__ __device__ constexpr int tile_keys(int D) {
  return 16384 / (D * (int)sizeof(T)) < 16
             ? 16
             : (16384 / (D * (int)sizeof(T)) > 64
                    ? 64
                    : 16384 / (D * (int)sizeof(T)));
}

// Copy keys [k0, k0 + rows) of one kv head's K and V into a ring stage of
// `tk` rows, `ld` elements apart.  With kZeroTail the V rows past `rows`
// are zeroed, for a reader that multiplies them by a zero probability
// (stale shared memory may hold any bits, NaN among them).
template <bool kZeroTail, typename T>
__device__ __forceinline__ void issue_tile(T* ks, T* vs, const T* kb,
                                           const T* vb, long long k_ss,
                                           long long v_ss, int k0, int rows,
                                           int tk, int D, int ld, int tid) {
  constexpr int kE = 16 / sizeof(T);  // elements per 16-byte chunk
  const int vecs = D / kE;
  for (int i = tid; i < rows * vecs; i += kThreads) {
    const int r = i / vecs;
    const int c = (i - r * vecs) * kE;
    tt_cp_async16(ks + r * ld + c, kb + (k0 + r) * k_ss + c);
    tt_cp_async16(vs + r * ld + c, vb + (k0 + r) * v_ss + c);
  }
  if (kZeroTail) {
    for (int i = tid; i < (tk - rows) * vecs; i += kThreads) {
      const int r = rows + i / vecs;
      const int c = (i % vecs) * kE;
      *reinterpret_cast<uint4*>(vs + r * ld + c) = make_uint4(0, 0, 0, 0);
    }
  }
}

// This split's key range [lo, hi) of row b: [0, lengths[b]) cut into
// n_split near-equal ranges aligned to 16 keys.
__device__ __forceinline__ void split_range(const int* lengths, int b, int S,
                                            int n_split, int split, int* lo,
                                            int* hi) {
  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int per = (((len + n_split - 1) / n_split) + 15) & ~15;
  *lo = min(len, split * per);
  *hi = min(len, *lo + per);
}

// Merge the block's n_parts online-softmax states, in part order: m_t and
// l_t [n_parts][R], a_t [n_parts][R][D] (unnormalised outputs).  With one
// split the result is normalised into out; otherwise it is this split's
// partial (acc, m, l).
template <typename T, int R>
__device__ __forceinline__ void merge_store(
    const float* m_t, const float* l_t, const float* a_t, int n_parts, int D,
    int n_rep, int b, int kvh, int Hkv, int split, int n_split, T* out,
    long long o_sb, long long o_sh, float* part) {
  const size_t row = ((size_t)b * Hkv + kvh) * n_split + split;
  for (int idx = threadIdx.x; idx < n_rep * D; idx += kThreads) {
    const int h = idx / D;
    const int dd = idx - h * D;
    float mx = -INFINITY;
    for (int w = 0; w < n_parts; ++w) mx = fmaxf(mx, m_t[w * R + h]);
    const float shift = tt_shift(mx);
    float sum_l = 0.f, sum_a = 0.f;
    for (int w = 0; w < n_parts; ++w) {
      const float a = tt_alpha(m_t[w * R + h], shift);
      sum_l += l_t[w * R + h] * a;
      sum_a += a_t[(w * R + h) * D + dd] * a;
    }
    if (n_split == 1) {
      const float ll = sum_l == 0.f ? 1.f : sum_l;
      tt_store(out + b * o_sb + (long long)(kvh * n_rep + h) * o_sh + dd,
               sum_a / ll);
    } else {
      const size_t n_rows = (size_t)gridDim.z * Hkv * n_split * n_rep;
      part[(row * n_rep + h) * D + dd] = sum_a;
      if (dd == 0) {
        float* ml = part + n_rows * D;
        ml[row * n_rep + h] = mx;
        ml[n_rows + row * n_rep + h] = sum_l;
      }
    }
  }
}

// Thread layout: a key row of D elements is read by a team of D / 8
// consecutive lanes, 8 elements each (D is a power of two, 8..256, so teams
// never straddle a warp); the block's kThreads / (D / 8) teams take a tile's
// keys in turn.  Each lane keeps its 8-dim slice of every head's query and
// output accumulator in registers.  R >= n_rep is the compiled head count.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ part, int S, int D, int Hkv, int n_rep, int n_split,
    long long q_sb, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_sh, float scale) {
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int team = D >> 3;         // lanes per key row
  const int c = tid & (team - 1);  // this lane's 8-dim slice
  const int r = tid / team;        // this lane's team
  const int teams = kThreads / team;
  const int tk = tile_keys<T>(D);
  // the combine kernel may be scheduled now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [kStages][2][tk][D]

  int lo, hi;
  split_range(lengths, b, S, n_split, split, &lo, &hi);
  const int n_tiles = (hi - lo + tk - 1) / tk;

  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  // the first two tiles go out before anything else
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) {
      T* ks = ring + (size_t)t * 2 * tk * D;
      issue_tile<false>(ks, ks + tk * D, kb, vb, k_ss, v_ss, lo + t * tk,
                        min(tk, hi - lo - t * tk), tk, D, D, tid);
    }
    tt_cp_async_commit();
  }

  float qr[R][8];
  float acc[R][8];
  float m[R], l[R];
  const T* qb = q + b * q_sb + (long long)kvh * n_rep * q_sh + c * 8;
#pragma unroll
  for (int h = 0; h < R; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) qr[h][e] = acc[h][e] = 0.f;
    if (h < n_rep) {
      tt_load8(qb + h * q_sh, qr[h]);
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[h][e] *= scale;
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    // tile t has landed (at most the one group after it is pending), and
    // every team is done with tile t - 1, whose stage the next issue reuses
    tt_cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < n_tiles) {
      const int tn = t + kStages - 1;
      T* ks = ring + (size_t)(tn % kStages) * 2 * tk * D;
      issue_tile<false>(ks, ks + tk * D, kb, vb, k_ss, v_ss, lo + tn * tk,
                        min(tk, hi - lo - tn * tk), tk, D, D, tid);
    }
    tt_cp_async_commit();

    const T* ks = ring + (size_t)(t % kStages) * 2 * tk * D;
    const T* vs = ks + tk * D;
    const int live = min(tk, hi - lo - t * tk);
    for (int i0 = 0; i0 * teams < live; i0 += kGroup) {
      float s[kGroup][R];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int j = r + (i0 + u) * teams;
        float kv[8];
        if (j < live) {
          tt_load8(ks + j * D + c * 8, kv);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) kv[e] = 0.f;
        }
#pragma unroll
        for (int h = 0; h < R; ++h) {
          float part_s = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) part_s += qr[h][e] * kv[e];
          s[u][h] = part_s;
        }
        // every lane of the team ends with the team's full dot product
        for (int o = team >> 1; o > 0; o >>= 1) {
#pragma unroll
          for (int h = 0; h < R; ++h)
            s[u][h] += __shfl_xor_sync(0xffffffffu, s[u][h], o);
        }
#pragma unroll
        for (int h = 0; h < R; ++h) s[u][h] = j < live ? s[u][h] : -INFINITY;
      }
      // fold the group into this team's running state
#pragma unroll
      for (int h = 0; h < R; ++h) {
        float mx = s[0][h];
#pragma unroll
        for (int u = 1; u < kGroup; ++u) mx = fmaxf(mx, s[u][h]);
        const float m_new = fmaxf(m[h], mx);
        const float shift = tt_shift(m_new);
        const float alpha = tt_alpha(m[h], shift);
        m[h] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          s[u][h] = expf(s[u][h] - shift);
          sum += s[u][h];
        }
        l[h] = l[h] * alpha + sum;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[h][e] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int j = r + (i0 + u) * teams;
        if (j < live) {
          float vv[8];
          tt_load8(vs + j * D + c * 8, vv);
#pragma unroll
          for (int h = 0; h < R; ++h) {
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[h][e] += s[u][h] * vv[e];
          }
        }
      }
    }
  }

  // merge the teams' states in team order; the ring is free once every
  // copy has landed and every team has left the loop
  tt_cp_async_wait<0>();
  __syncthreads();
  float* m_t = reinterpret_cast<float*>(smem_raw);  // [teams][R]
  float* l_t = m_t + teams * R;                       // [teams][R]
  float* a_t = l_t + teams * R;                       // [teams][R][D]
#pragma unroll
  for (int h = 0; h < R; ++h) {
    if (c == 0) {
      m_t[r * R + h] = m[h];
      l_t[r * R + h] = l[h];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) a_t[(r * R + h) * D + c * 8 + e] = acc[h][e];
  }
  __syncthreads();
  merge_store<T, R>(m_t, l_t, a_t, teams, D, n_rep, b, kvh, Hkv, split,
                    n_split, out, o_sb, o_sh, part);
}

// -- tensor-core path: bf16, D 64 or 128 -----------------------------------

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 b16 matrices from shared memory (lane l gives the address of
// row l % 8 of matrix l / 8); .trans delivers each transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int kMmaKeys = 64;  // keys per tile: 16 for each of the 4 warps

// The same function on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate).  Each warp takes 16 keys of every 64-key tile and keeps its
// own softmax state; the 16 rows of the MMA are the kv head's n_rep <= 8
// query heads (rows past n_rep, and rows 8..15, are zero).  S = Q K^T reads
// K fragments with ldmatrix; P V reads V fragments with ldmatrix.trans, P
// entering as two bf16 terms (hi + lo).  Shared rows are padded by 16
// bytes, so the 8 rows of an ldmatrix fall in distinct banks.
template <int D>
__global__ void __launch_bounds__(kThreads) decode_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part, int S,
    int Hkv, int n_rep, int n_split, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_sh,
    float scale_log2) {
  constexpr int kLd = D + 8;
  constexpr int tk = kMmaKeys;
  constexpr int kR = 8;  // MMA rows that can hold a query head
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // the combine kernel may be scheduled now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  int lo, hi;
  split_range(lengths, b, S, n_split, split, &lo, &hi);
  const int n_tiles = (hi - lo + tk - 1) / tk;
  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) {
      __nv_bfloat16* ks = ring + (size_t)t * 2 * tk * kLd;
      issue_tile<true>(ks, ks + tk * kLd, kb, vb, k_ss, v_ss, lo + t * tk,
                       min(tk, hi - lo - t * tk), tk, D, kLd, tid);
    }
    tt_cp_async_commit();
  }

  // this lane's query head (MMA row lane / 4) as A fragments, one pair of
  // registers per 16-wide slice of D (rows 8..15 are zero)
  const int hq = lane >> 2;
  uint32_t qa[D / 16][2];
  const __nv_bfloat16* qrow =
      q + b * q_sb + (long long)(kvh * n_rep + hq) * q_sh + (lane & 3) * 2;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = hq < n_rep
                    ? *reinterpret_cast<const uint32_t*>(qrow + kk * 16)
                    : 0u;
    qa[kk][1] = hq < n_rep
                    ? *reinterpret_cast<const uint32_t*>(qrow + kk * 16 + 8)
                    : 0u;
  }
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m = -INFINITY;  // row hq's running max (log2 units)
  float l = 0.f;        // this lane's share of row hq's sum

  for (int t = 0; t < n_tiles; ++t) {
    tt_cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < n_tiles) {
      const int tn = t + kStages - 1;
      __nv_bfloat16* ks = ring + (size_t)(tn % kStages) * 2 * tk * kLd;
      issue_tile<true>(ks, ks + tk * kLd, kb, vb, k_ss, v_ss, lo + tn * tk,
                       min(tk, hi - lo - tn * tk), tk, D, kLd, tid);
    }
    tt_cp_async_commit();

    const __nv_bfloat16* ks = ring + (size_t)(t % kStages) * 2 * tk * kLd;
    const __nv_bfloat16* vs = ks + tk * kLd;
    const int live = min(tk, hi - lo - t * tk);
    const int w0 = warp * 16;  // this warp's first key of the tile
    if (w0 >= live) continue;

    // S = Q K^T for the warp's 16 keys (two 8-key column tiles)
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const __nv_bfloat16* krow =
        ks + (w0 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
        ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kf[4];
      ldsm_x4(kf, krow + kk * 16);
      const uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
      mma_bf16_16816(sc[0], a, kf[0], kf[1]);
      mma_bf16_16816(sc[1], a, kf[2], kf[3]);
    }

    // fold: scale into log2 units, mask keys past the range, the row max
    // over the quad, then this warp's running state
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = w0 + (i >> 1) * 8 + (lane & 3) * 2 + (i & 1);
      x[i] = key < live ? sc[i >> 1][i & 1] * scale_log2 : -INFINITY;
    }
    float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float shift = tt_shift(m_new);
    const float alpha = isfinite(m) ? exp2f(m - shift) : 0.f;
    m = m_new;
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = exp2f(x[i] - shift);
    l = l * alpha + (x[0] + x[1]) + (x[2] + x[3]);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= alpha;
      o[i][1] *= alpha;
    }

    // O += P V, P as the A fragments of the warp's 16 keys, in two bf16
    // terms (hi + lo), so the product keeps about 16 bits of P
    uint32_t pa[4] = {0u, 0u, 0u, 0u}, pb[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      const float2 hf = __bfloat1622float2(hi);
      pa[2 * i] = *reinterpret_cast<const uint32_t*>(&hi);
      pb[2 * i] = pack_bf16(x[2 * i] - hf.x, x[2 * i + 1] - hf.y);
    }
    const __nv_bfloat16* vrow =
        vs + (w0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + (lane >> 4) * 8;
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      uint32_t vf[4];
      ldsm_x4_t(vf, vrow + dd * 16);
      mma_bf16_16816(o[2 * dd], pa, vf[0], vf[1]);
      mma_bf16_16816(o[2 * dd + 1], pa, vf[2], vf[3]);
      mma_bf16_16816(o[2 * dd], pb, vf[0], vf[1]);
      mma_bf16_16816(o[2 * dd + 1], pb, vf[2], vf[3]);
    }
  }

  // merge the warps' states in warp order
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  tt_cp_async_wait<0>();
  __syncthreads();
  float* m_t = reinterpret_cast<float*>(smem_raw);  // [warps][kR]
  float* l_t = m_t + (kThreads / 32) * kR;          // [warps][kR]
  float* a_t = l_t + (kThreads / 32) * kR;          // [warps][kR][D]
  if ((lane & 3) == 0) {
    m_t[warp * kR + hq] = m;
    l_t[warp * kR + hq] = l;
  }
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    float* dst = a_t + (warp * kR + hq) * D + i * 8 + (lane & 3) * 2;
    dst[0] = o[i][0];
    dst[1] = o[i][1];
  }
  __syncthreads();
  // m is in log2 units here; the partials carry natural-log maxima
  if (tid < (kThreads / 32) * kR) m_t[tid] *= 0.6931471805599453f;
  __syncthreads();
  merge_store<__nv_bfloat16, kR>(m_t, l_t, a_t, kThreads / 32, D, n_rep, b,
                                 kvh, Hkv, split, n_split, out, o_sb, o_sh,
                                 part);
}

// out[b, h] from the n_split partials of (b, h // n_rep), in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attention_combine_kernel(
    const float* __restrict__ part, T* __restrict__ out, int B, int D,
    int Hkv, int n_rep, int n_split, long long o_sb, long long o_sh) {
  // launched early (programmatic dependent launch): wait here until the
  // main grid has finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / n_rep;
  const int hr = h - kvh * n_rep;
  const size_t n_rows = (size_t)B * Hkv * n_split * n_rep;
  const size_t first = ((size_t)b * Hkv + kvh) * n_split * n_rep + hr;
  const float* m_p = part + n_rows * D;
  const float* l_p = m_p + n_rows;
  __shared__ float m_s[kMaxSplit], l_s[kMaxSplit], a_s[kMaxSplit];
  __shared__ float l_all;
  for (int j = threadIdx.x; j < n_split; j += blockDim.x) {
    m_s[j] = m_p[first + j * n_rep];
    l_s[j] = l_p[first + j * n_rep];
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int j = 0; j < n_split; ++j) mx = fmaxf(mx, m_s[j]);
  const float shift = tt_shift(mx);
  for (int j = threadIdx.x; j < n_split; j += blockDim.x)
    a_s[j] = tt_alpha(m_s[j], shift);
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum_l = 0.f;
    for (int j = 0; j < n_split; ++j) sum_l += l_s[j] * a_s[j];
    l_all = sum_l == 0.f ? 1.f : sum_l;
  }
  __syncthreads();
  for (int dd = threadIdx.x; dd < D; dd += blockDim.x) {
    float sum = 0.f;
#pragma unroll 16
    for (int j = 0; j < n_split; ++j)
      sum += part[(first + j * n_rep) * D + dd] * a_s[j];
    tt_store(out + b * o_sb + h * o_sh + dd, sum / l_all);
  }
}

// The combine is launched as a programmatic dependent of the main kernel:
// its blocks may be scheduled while the main grid runs (each main block lets
// them in as it starts) and wait in griddepcontrol.wait, so the launch
// latency of the second kernel is hidden.
template <typename T>
int combine(const float* part, void* out, int B, int H, int Hkv, int D,
            int n_split, const long long* st, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, decode_attention_combine_kernel<T>,
                                 part, static_cast<T*>(out), B, D, Hkv,
                                 H / Hkv, n_split, st[8], st[9]);
}

template <typename T, int R>
int launch_simt(const void* q, const void* k, const void* v,
                const int* lengths, void* out, float* part, int B, int H,
                int Hkv, int S, int D, int n_split, const long long* st,
                float scale, cudaStream_t stream) {
  const int teams = kThreads / (D / 8);
  const size_t ring =
      (size_t)kStages * 2 * tile_keys<T>(D) * D * sizeof(T);
  const size_t merge = sizeof(float) * (size_t)teams * R * (D + 2);
  const size_t smem = ring > merge ? ring : merge;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<T, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 100 * 1024);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(n_split, Hkv, B);
  decode_attention_kernel<T, R><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), part, S, D,
      Hkv, H / Hkv, n_split, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  return combine<T>(part, out, B, H, Hkv, D, n_split, st, stream);
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v,
               const int* lengths, void* out, float* part, int B, int H,
               int Hkv, int S, int n_split, const long long* st, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = (size_t)kStages * 2 * kMmaKeys * (D + 8) * 2;
  static_assert(smem >= sizeof(float) * (kThreads / 32) * 8 * (D + 2),
                "the merge reuses the ring");
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_mma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(n_split, Hkv, B);
  decode_attention_mma_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lengths,
      static_cast<__nv_bfloat16*>(out), part, S, Hkv, H / Hkv, n_split,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      scale * 1.4426950408889634f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  return combine<__nv_bfloat16>(part, out, B, H, Hkv, D, n_split, st,
                                stream);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* lengths,
             void* out, float* part, int B, int H, int Hkv, int S, int D,
             int n_split, const long long* st, float scale,
             cudaStream_t stream) {
  const int n_rep = H / Hkv;
  if (n_rep <= 1)
    return launch_simt<T, 1>(q, k, v, lengths, out, part, B, H, Hkv, S, D,
                             n_split, st, scale, stream);
  if (n_rep <= 2)
    return launch_simt<T, 2>(q, k, v, lengths, out, part, B, H, Hkv, S, D,
                             n_split, st, scale, stream);
  if (n_rep <= 4)
    return launch_simt<T, 4>(q, k, v, lengths, out, part, B, H, Hkv, S, D,
                             n_split, st, scale, stream);
  return launch_simt<T, 8>(q, k, v, lengths, out, part, B, H, Hkv, S, D,
                           n_split, st, scale, stream);
}

}  // namespace

// Shapes and strides (in elements) are checked by the Python wrapper:
// H % Hkv == 0, H / Hkv <= 8, D a power of two in [8, 256], 16-byte
// aligned rows, 1 <= n_split <= 64.  `strides` holds q (batch, head), k and
// v (batch, seq, head) and out (batch, head).  `part` holds
// B * Hkv * n_split * n_rep * (D + 2) floats (acc, then m, then l) and is
// unused when n_split == 1.
extern "C" int tt_decode_attention(int dtype, const void* q, const void* k,
                                   const void* v, const int* lengths,
                                   void* out, void* part, int B, int H,
                                   int Hkv, int S, int D, int n_split,
                                   const long long* strides, float scale,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || n_split > kMaxSplit) return (int)cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
  if (dtype == TT_BF16 && D == 128)
    return launch_mma<128>(q, k, v, lengths, out, p, B, H, Hkv, S, n_split,
                           strides, scale, st);
  if (dtype == TT_BF16 && D == 64)
    return launch_mma<64>(q, k, v, lengths, out, p, B, H, Hkv, S, n_split,
                          strides, scale, st);
  if (dtype == TT_BF16)
    return dispatch<__nv_bfloat16>(q, k, v, lengths, out, p, B, H, Hkv, S, D,
                                   n_split, strides, scale, st);
  if (dtype == TT_F32)
    return dispatch<float>(q, k, v, lengths, out, p, B, H, Hkv, S, D,
                           n_split, strides, scale, st);
  return (int)cudaErrorInvalidValue;
}
