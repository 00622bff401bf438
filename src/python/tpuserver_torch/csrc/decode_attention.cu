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
// - grid (n_split, Hkv x G, B): the wrapper picks n_split from B, Hkv, S and
//   the SM count only (about two blocks per SM, at least 64 cache keys a
//   split), never from `lengths`, which stay on the device.  A block takes
//   a group of up to kMmaRep = 16 (`mma` route) or kSimtRep = 8 (`simt`)
//   of the n_rep = H / Hkv query heads of its kv head: G = ceil(n_rep /
//   group) groups, each re-reading its kv head's cache.  On the `mma` route
//   G is 1 for every Llama-3 preset, for Llama-3.1-405B's H 128 over Hkv 8
//   and for multi-query attention up to 16 heads; H 32 over Hkv 1 has G 2.
//   Each block cuts [0, lengths[b]) itself into n_split near-equal ranges
//   aligned to 16 keys, so every split has work at any length up to its
//   share; a block whose range is empty writes m = -inf, l = 0 and a zero
//   accumulator;
// - inside a block, K/V tiles stream through a 3-stage shared-memory ring
//   filled with cp.async: two tiles are in flight while one is scored, and
//   each tile costs one block-wide barrier;
// - the query heads of a block read each K/V row once from shared memory,
//   so GQA is never expanded; no key at or past lengths[b] is read;
// - the `mma` route takes bf16 at every head dim of the domain (a multiple
//   of 8 from 8 to 256) on the tensor cores: each of 4 warps takes 16 keys
//   of a 64-key tile, S = Q K^T and P V are mma.sync m16n8k16 with the
//   group's query heads as the 16 MMA rows (an instance for groups of at
//   most 8 heads folds only rows 0 .. 7) and ldmatrix(.trans) fragments,
//   and each warp keeps its own online-softmax state.  The head dim runs at
//   a padded D_p of 64, 128, 192 or 256: cp.async copies the D columns of
//   each cache row, and columns D .. D_p - 1 of every ring stage are zeroed
//   once, so QK^T and P V run over D_p (the zero columns add nothing; P V
//   writes zeros there, which are not stored).  Q and K enter
//   as they are (their products are exact in fp32), P as two bf16 terms (hi
//   + lo), so P.V keeps about 16 bits of P.  Without the tensor cores the
//   per-key arithmetic (a dot product reduced across lanes by shuffles)
//   took longer than the loads it waited on, and more so for bf16 at head
//   dims that are no power of two (idle lanes in a team);
// - the `simt` route takes float32 (no tensor core, so float32 sums stay
//   float32): a team of lanes per key row, 8 elements a lane (D / 8 lanes
//   rounded up to a power of two, the lanes past D idle, so that teams
//   never straddle a warp), each team with its own online-softmax state,
//   folding 8 keys at a time.  At float32 shapes it beats live SDPA
//   (PERF.md), so it stays as it is;
// - the warps' (or teams') states merge in a fixed order at the end of the
//   block;
// - the splits' fp32 partials (acc [B, Hkv, n_split, n_rep, D], m and l
//   [B, Hkv, n_split, n_rep], each group writing its heads' rows) are
//   combined by a second small kernel in split order, launched by the same C
//   call.  With n_split == 1 the main kernel
//   writes the output itself and the combine is not launched.
// Left for later work: reading a page table in-kernel, a persistent
// schedule that would not need the partials, and a group that spans two kv
// heads when n_rep is small (rows past n_rep are idle MMA rows).
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
// rows `ld` elements apart (the `simt` route's).
template <typename T>
__device__ __forceinline__ void issue_tile(T* ks, T* vs, const T* kb,
                                           const T* vb, long long k_ss,
                                           long long v_ss, int k0, int rows,
                                           int D, int ld, int tid) {
  constexpr int kE = 16 / sizeof(T);  // elements per 16-byte chunk
  const int vecs = D / kE;
  for (int i = tid; i < rows * vecs; i += kThreads) {
    const int r = i / vecs;
    const int c = (i - r * vecs) * kE;
    tt_cp_async16(ks + r * ld + c, kb + (k0 + r) * k_ss + c);
    tt_cp_async16(vs + r * ld + c, vb + (k0 + r) * v_ss + c);
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
// l_t [n_parts][R], a_t [n_parts][R][D] (unnormalised outputs) of the nh
// query heads h0 .. h0 + nh - 1 of kv head kvh.  With one split the result
// is normalised into out; otherwise it is this split's partial (acc, m, l).
template <typename T, int R>
__device__ __forceinline__ void merge_store(
    const float* m_t, const float* l_t, const float* a_t, int n_parts, int D,
    int n_rep, int h0, int nh, int b, int kvh, int Hkv, int split,
    int n_split, T* out, long long o_sb, long long o_sh, float* part) {
  const size_t row = ((size_t)b * Hkv + kvh) * n_split + split;
  for (int idx = threadIdx.x; idx < nh * D; idx += kThreads) {
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
      tt_store(out + b * o_sb + (long long)(kvh * n_rep + h0 + h) * o_sh + dd,
               sum_a / ll);
    } else {
      const size_t n_rows = (size_t)gridDim.z * Hkv * n_split * n_rep;
      part[(row * n_rep + h0 + h) * D + dd] = sum_a;
      if (dd == 0) {
        float* ml = part + n_rows * D;
        ml[row * n_rep + h0 + h] = mx;
        ml[n_rows + row * n_rep + h0 + h] = sum_l;
      }
    }
  }
}

// The query heads a block takes: up to kMmaRep (the MMA's 16 rows) on the
// `mma` route, kSimtRep on the `simt` route, as ops/flash.py's
// DECODE_GROUP_HEADS says.
constexpr int kMmaRep = 16;
constexpr int kSimtRep = 8;

// A block's query heads: blockIdx.y is kvh * G + g, and the block takes the
// nh = min(kRep, n_rep - h0) heads from h0 = g * kRep of kv head kvh.
struct HeadGroup {
  int kvh, h0, nh;
};

template <int kRep>
__device__ __forceinline__ HeadGroup head_group(int n_rep) {
  const int groups = (n_rep + kRep - 1) / kRep;
  const int g = blockIdx.y % groups;
  HeadGroup hg;
  hg.kvh = blockIdx.y / groups;
  hg.h0 = g * kRep;
  hg.nh = min(kRep, n_rep - hg.h0);
  return hg;
}

// Lanes of a SIMT team: D / 8 rounded up to a power of two (at most 32,
// since D <= 256), so that a team never straddles a warp.
__host__ __device__ __forceinline__ int team_lanes(int D) {
  int team = 1;
  while (team * 8 < D) team <<= 1;
  return team;
}

// Thread layout: a key row of D elements is read by a team of team_lanes(D)
// consecutive lanes, 8 elements each (lanes whose 8 elements start at or
// past D are idle: they load zeros and store nothing); the block's kThreads
// / team teams take a tile's keys in turn.  Each lane keeps its 8-dim slice
// of every head's query and output accumulator in registers.  R >= nh is
// the compiled head count.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ part, int S, int D, int Hkv, int n_rep, int n_split,
    long long q_sb, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_sh, float scale) {
  const int split = blockIdx.x;
  const HeadGroup hg = head_group<kSimtRep>(n_rep);
  const int kvh = hg.kvh;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int team = team_lanes(D);  // lanes per key row
  const int c = tid & (team - 1);  // this lane's 8-dim slice
  const bool active = c * 8 < D;   // the slice lies inside the row
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
      issue_tile(ks, ks + tk * D, kb, vb, k_ss, v_ss, lo + t * tk,
                 min(tk, hi - lo - t * tk), D, D, tid);
    }
    tt_cp_async_commit();
  }

  float qr[R][8];
  float acc[R][8];
  float m[R], l[R];
  const T* qb =
      q + b * q_sb + (long long)(kvh * n_rep + hg.h0) * q_sh + c * 8;
#pragma unroll
  for (int h = 0; h < R; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) qr[h][e] = acc[h][e] = 0.f;
    if (h < hg.nh && active) {
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
      issue_tile(ks, ks + tk * D, kb, vb, k_ss, v_ss, lo + tn * tk,
                 min(tk, hi - lo - tn * tk), D, D, tid);
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
        if (j < live && active) {
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
        if (j < live && active) {
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
    if (active) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        a_t[(r * R + h) * D + c * 8 + e] = acc[h][e];
    }
  }
  __syncthreads();
  merge_store<T, R>(m_t, l_t, a_t, teams, D, n_rep, hg.h0, hg.nh, b, kvh,
                    Hkv, split, n_split, out, o_sb, o_sh, part);
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

// Copy keys [k0, k0 + rows) of one kv head's K and V (d columns) into a
// ring stage of rows D + 8 elements apart; the V rows past `rows` are
// zeroed (a zero probability times stale bits may be NaN).  The chunk
// count of a row is the compile-time D / 8, so the loop divides by a
// constant; chunks at or past d are skipped.
template <int D>
__device__ __forceinline__ void issue_mma_tile(
    __nv_bfloat16* ks, __nv_bfloat16* vs, const __nv_bfloat16* kb,
    const __nv_bfloat16* vb, long long k_ss, long long v_ss, int k0,
    int rows, int d, int tid) {
  constexpr int kLd = D + 8;
  constexpr int kC = D / 8;  // 16-byte chunks of a padded row
  for (int i = tid; i < rows * kC; i += kThreads) {
    const int r = i / kC;
    const int c = (i - r * kC) * 8;
    if (c < d) {
      tt_cp_async16(ks + r * kLd + c, kb + (k0 + r) * k_ss + c);
      tt_cp_async16(vs + r * kLd + c, vb + (k0 + r) * v_ss + c);
    }
  }
  for (int i = tid; i < (kMmaKeys - rows) * kC; i += kThreads) {
    const int r = rows + i / kC;
    *reinterpret_cast<uint4*>(vs + r * kLd + (i % kC) * 8) =
        make_uint4(0, 0, 0, 0);
  }
}

// The same function on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate) for bf16 at any head dim d <= D, D the padded head dim (64,
// 128, 192 or 256).  Each warp takes 16 keys of every 64-key tile and keeps
// its own softmax state; the 16 rows of the MMA are the block's nh <= 16
// query heads (rows past nh are zero).  A lane holds rows lane / 4 and
// lane / 4 + 8; the kRows = 8 instance, for groups of at most 8 heads,
// compiles rows 8 .. 15 as zeros and folds one row a lane.  S = Q K^T
// reads K fragments with ldmatrix; P V reads V fragments with
// ldmatrix.trans, P entering as two bf16 terms (hi + lo).
// Shared rows are D + 8 elements apart (padded by 16 bytes), so the 8 rows
// of an ldmatrix fall in distinct banks; columns d .. D - 1 are zeros.  The
// kExact instances (d == D: 64 and 128, every Llama-3 preset) fold d into
// the code.
template <int D, int kRows, bool kExact>
__global__ void __launch_bounds__(kThreads) decode_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part, int S,
    int d_arg, int Hkv, int n_rep, int n_split, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_sh,
    float scale_log2) {
  constexpr int kLd = D + 8;
  constexpr int tk = kMmaKeys;
  constexpr int kR = kRows;         // MMA rows that may hold a query head
  constexpr bool kTwo = kRows > 8;  // rows 8 .. 15 may hold heads
  const int d = kExact ? D : d_arg;
  const int split = blockIdx.x;
  const HeadGroup hg = head_group<kMmaRep>(n_rep);
  const int kvh = hg.kvh;
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
      issue_mma_tile<D>(ks, ks + tk * kLd, kb, vb, k_ss, v_ss, lo + t * tk,
                        min(tk, hi - lo - t * tk), d, tid);
    }
    tt_cp_async_commit();
  }
  // columns d .. D - 1 of every stage's K and V rows: zeros, once (no copy
  // writes them; the loop's first barrier orders these stores)
  if (d < D) {
    for (int i = tid; i < kStages * 2 * tk * (D / 8); i += kThreads) {
      const int c = (i % (D / 8)) * 8;
      if (c >= d)
        *reinterpret_cast<uint4*>(ring + (size_t)(i / (D / 8)) * kLd + c) =
            make_uint4(0, 0, 0, 0);
    }
  }

  // this lane's query heads (MMA rows lane / 4 and lane / 4 + 8) as A
  // fragments, four registers per 16-wide slice of D: (row, cols 2c ..),
  // (row + 8, 2c ..), (row, 2c + 8 ..), (row + 8, 2c + 8 ..); heads past nh
  // and columns past d are zero
  const int hq = lane >> 2;
  const int c2 = (lane & 3) * 2;
  uint32_t qa[D / 16][4];
  const __nv_bfloat16* qrow =
      q + b * q_sb + (long long)(kvh * n_rep + hg.h0 + hq) * q_sh + c2;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = hq + (i & 1) * 8;
      const int col = kk * 16 + (i >> 1) * 8 + c2;
      qa[kk][i] = (kTwo || !(i & 1)) && row < hg.nh && col < d
                      ? *reinterpret_cast<const uint32_t*>(
                            qrow + (i & 1) * 8 * q_sh + col - c2)
                      : 0u;
    }
  }
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // rows hq, hq + 8 (log2 units)
  float l[2] = {0.f, 0.f};              // this lane's share of their sums

  for (int t = 0; t < n_tiles; ++t) {
    tt_cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < n_tiles) {
      const int tn = t + kStages - 1;
      __nv_bfloat16* ks = ring + (size_t)(tn % kStages) * 2 * tk * kLd;
      issue_mma_tile<D>(ks, ks + tk * kLd, kb, vb, k_ss, v_ss, lo + tn * tk,
                        min(tk, hi - lo - tn * tk), d, tid);
    }
    tt_cp_async_commit();

    const __nv_bfloat16* ks = ring + (size_t)(t % kStages) * 2 * tk * kLd;
    const __nv_bfloat16* vs = ks + tk * kLd;
    const int live = min(tk, hi - lo - t * tk);
    const int w0 = warp * 16;  // this warp's first key of the tile
    if (w0 >= live) continue;

    // S = Q K^T for the warp's 16 keys (two 8-key column tiles); columns
    // d .. D - 1 are zeros in Q and K and add nothing
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const __nv_bfloat16* krow =
        ks + (w0 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
        ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kf[4];
      ldsm_x4(kf, krow + kk * 16);
      mma_bf16_16816(sc[0], qa[kk], kf[0], kf[1]);
      mma_bf16_16816(sc[1], qa[kk], kf[2], kf[3]);
    }

    // fold: scale into log2 units, mask keys past the range, each row's
    // max over the quad, then this warp's running state.  x[r][i]: row hq
    // + 8 r, key 8 (i >> 1) + c2 + (i & 1).  Rows 8 .. 15 hold heads only
    // in a group of more than 8 (warp-uniform); otherwise their P is 0.
    float x[2][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = w0 + (i >> 1) * 8 + c2 + (i & 1);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        x[r][i] = key < live ? sc[i >> 1][2 * r + (i & 1)] * scale_log2
                             : -INFINITY;
    }
    const int rows = kTwo && hg.nh > 8 ? 2 : 1;
    float alpha[2] = {1.f, 1.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r < rows) {
        float mx = fmaxf(fmaxf(x[r][0], x[r][1]), fmaxf(x[r][2], x[r][3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float shift = tt_shift(m_new);
        alpha[r] = isfinite(m[r]) ? exp2f(m[r] - shift) : 0.f;
        m[r] = m_new;
#pragma unroll
        for (int i = 0; i < 4; ++i) x[r][i] = exp2f(x[r][i] - shift);
        l[r] = l[r] * alpha[r] + (x[r][0] + x[r][1]) + (x[r][2] + x[r][3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) x[r][i] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
    }
    if (rows == 2) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[i][2] *= alpha[1];
        o[i][3] *= alpha[1];
      }
    }

    // O += P V, P as the A fragments of the warp's 16 keys, in two bf16
    // terms (hi + lo), so the product keeps about 16 bits of P
    uint32_t pa[4], pb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // register i: row hq + 8 (i & 1), keys 8 (i >> 1) + c2 ..
      const float* xr = x[i & 1] + 2 * (i >> 1);
      const __nv_bfloat162 hi2 = __floats2bfloat162_rn(xr[0], xr[1]);
      const float2 hf = __bfloat1622float2(hi2);
      pa[i] = *reinterpret_cast<const uint32_t*>(&hi2);
      pb[i] = pack_bf16(xr[0] - hf.x, xr[1] - hf.y);
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
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  tt_cp_async_wait<0>();
  __syncthreads();
  float* m_t = reinterpret_cast<float*>(smem_raw);  // [warps][kR]
  float* l_t = m_t + (kThreads / 32) * kR;          // [warps][kR]
  float* a_t = l_t + (kThreads / 32) * kR;          // [warps][kR][d]
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < (kTwo ? 2 : 1); ++r) {
      m_t[warp * kR + hq + 8 * r] = m[r];
      l_t[warp * kR + hq + 8 * r] = l[r];
    }
  }
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    if (i * 8 < d) {
#pragma unroll
      for (int r = 0; r < (kTwo ? 2 : 1); ++r) {
        float* dst = a_t + (warp * kR + hq + 8 * r) * d + i * 8 + c2;
        dst[0] = o[i][2 * r];
        dst[1] = o[i][2 * r + 1];
      }
    }
  }
  __syncthreads();
  // m is in log2 units here; the partials carry natural-log maxima
  if (tid < (kThreads / 32) * kR) m_t[tid] *= 0.6931471805599453f;
  __syncthreads();
  merge_store<__nv_bfloat16, kR>(m_t, l_t, a_t, kThreads / 32, d, n_rep,
                                 hg.h0, hg.nh, b, kvh, Hkv, split, n_split,
                                 out, o_sb, o_sh, part);
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

template <int R>
int launch_simt(const void* q, const void* k, const void* v,
                const int* lengths, void* out, float* part, int B, int H,
                int Hkv, int S, int D, int n_split, const long long* st,
                float scale, cudaStream_t stream) {
  const int teams = kThreads / team_lanes(D);
  const size_t ring =
      (size_t)kStages * 2 * tile_keys<float>(D) * D * sizeof(float);
  const size_t merge = sizeof(float) * (size_t)teams * R * (D + 2);
  const size_t smem = ring > merge ? ring : merge;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<float, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 100 * 1024);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(n_split, Hkv * ((H / Hkv + kSimtRep - 1) / kSimtRep), B);
  decode_attention_kernel<float, R><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), lengths, static_cast<float*>(out), part,
      S, D, Hkv, H / Hkv, n_split, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  return combine<float>(part, out, B, H, Hkv, D, n_split, st, stream);
}

// D: the padded head dim (64, 128, 192, 256) of the instance; d the
// operands' own (a multiple of 8, d <= D; kExact: d == D); kRows 8 where a
// group holds at most 8 heads, else 16.
template <int D, int kRows, bool kExact>
int launch_mma(const void* q, const void* k, const void* v,
               const int* lengths, void* out, float* part, int B, int H,
               int Hkv, int S, int d, int n_split, const long long* st,
               float scale, cudaStream_t stream) {
  constexpr size_t smem = (size_t)kStages * 2 * kMmaKeys * (D + 8) * 2;
  static_assert(smem >= sizeof(float) * (kThreads / 32) * kRows * (D + 2),
                "the merge reuses the ring");
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_mma_kernel<D, kRows, kExact>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(n_split, Hkv * ((H / Hkv + kMmaRep - 1) / kMmaRep), B);
  decode_attention_mma_kernel<D, kRows, kExact>
      <<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lengths,
      static_cast<__nv_bfloat16*>(out), part, S, d, Hkv, H / Hkv, n_split,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      scale * 1.4426950408889634f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  return combine<__nv_bfloat16>(part, out, B, H, Hkv, d, n_split, st,
                                stream);
}

// the instance of the padded head dim that covers D (at D_p 256 the
// 16-row one: the 8-row instance spilled there)
template <int kRows>
int dispatch_mma(const void* q, const void* k, const void* v,
                 const int* lengths, void* out, float* p, int B, int H,
                 int Hkv, int S, int D, int n_split, const long long* st,
                 float scale, cudaStream_t stream) {
  if (D == 64)
    return launch_mma<64, kRows, true>(q, k, v, lengths, out, p, B, H, Hkv,
                                       S, D, n_split, st, scale, stream);
  if (D == 128)
    return launch_mma<128, kRows, true>(q, k, v, lengths, out, p, B, H, Hkv,
                                        S, D, n_split, st, scale, stream);
  if (D < 64)
    return launch_mma<64, kRows, false>(q, k, v, lengths, out, p, B, H, Hkv,
                                        S, D, n_split, st, scale, stream);
  if (D < 128)
    return launch_mma<128, kRows, false>(q, k, v, lengths, out, p, B, H,
                                         Hkv, S, D, n_split, st, scale,
                                         stream);
  if (D <= 192)
    return launch_mma<192, kRows, false>(q, k, v, lengths, out, p, B, H,
                                         Hkv, S, D, n_split, st, scale,
                                         stream);
  return launch_mma<256, 16, false>(q, k, v, lengths, out, p, B, H, Hkv, S,
                                    D, n_split, st, scale, stream);
}

int dispatch_simt(const void* q, const void* k, const void* v,
                  const int* lengths, void* out, float* part, int B, int H,
                  int Hkv, int S, int D, int n_split, const long long* st,
                  float scale, cudaStream_t stream) {
  // a block takes up to kSimtRep heads: the compiled count covers its group
  const int n_rep = min(H / Hkv, kSimtRep);
  if (n_rep <= 1)
    return launch_simt<1>(q, k, v, lengths, out, part, B, H, Hkv, S, D,
                          n_split, st, scale, stream);
  if (n_rep <= 2)
    return launch_simt<2>(q, k, v, lengths, out, part, B, H, Hkv, S, D,
                          n_split, st, scale, stream);
  if (n_rep <= 4)
    return launch_simt<4>(q, k, v, lengths, out, part, B, H, Hkv, S, D,
                          n_split, st, scale, stream);
  return launch_simt<8>(q, k, v, lengths, out, part, B, H, Hkv, S, D,
                        n_split, st, scale, stream);
}

}  // namespace

// Routes, as tpuserver_torch/ops/flash.py::decode_route numbers them.
enum { TT_DECODE_MMA = 0, TT_DECODE_SIMT = 1 };

// Shapes and strides (in elements) are checked by the Python wrapper, which
// picks the route: `mma` takes bf16, `simt` float32, each with D a multiple
// of 8 from 8 to 256; a route given anything else returns
// cudaErrorInvalidValue before any launch.  H % Hkv == 0 (any ratio),
// 16-byte aligned rows, 1 <= n_split <= 64.  `strides` holds q (batch,
// head), k and v (batch, seq, head) and out (batch, head).  `part` holds
// B * Hkv * n_split * n_rep * (D + 2) floats (acc, then m, then l) and is
// unused when n_split == 1.
extern "C" int tt_decode_attention(int dtype, int route, const void* q,
                                   const void* k, const void* v,
                                   const int* lengths, void* out, void* part,
                                   int B, int H, int Hkv, int S, int D,
                                   int n_split, const long long* strides,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || n_split > kMaxSplit || Hkv < 1 || H % Hkv || D < 8 ||
      D % 8 || D > 256)
    return (int)cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
  if (route == TT_DECODE_MMA && dtype == TT_BF16)
    return H / Hkv <= 8 ? dispatch_mma<8>(q, k, v, lengths, out, p, B, H, Hkv,
                                          S, D, n_split, strides, scale, st)
                        : dispatch_mma<16>(q, k, v, lengths, out, p, B, H,
                                           Hkv, S, D, n_split, strides,
                                           scale, st);
  if (route == TT_DECODE_SIMT && dtype == TT_F32)
    return dispatch_simt(q, k, v, lengths, out, p, B, H, Hkv, S, D, n_split,
                         strides, scale, st);
  return (int)cudaErrorInvalidValue;
}
