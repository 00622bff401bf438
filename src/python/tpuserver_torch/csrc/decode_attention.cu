// Single-query decode attention over a padded KV cache, for sm_90a.
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
// layer, about 5 us at 3.35 TB/s.
//
// What the design does about it:
// - one block per (batch row, kv head): the n_rep = H / Hkv query heads that
//   share a kv head read each K/V row once, so GQA is never expanded in
//   device memory (the TPU kernel replicated it inside VMEM);
// - the block walks key tiles of 256 over [0, lengths[b]) only, so the padded
//   cache tail is never read (the TPU kernel clamped its index map for this);
// - each K/V row is read by a team of D / 8 lanes with 16-byte loads, and
//   every thread issues kBatch rows' loads before it uses any of them, so a
//   block keeps many loads in flight (one row in flight per thread left it
//   latency-bound: 1.12 ms at len 4096 on the H100);
// - scores are reduced across the team with shuffles and go through shared
//   memory for the fold; the P.V accumulators stay in registers.
// Left for later work: a split of the key range across blocks with a combine
// pass (B * Hkv blocks is 8 blocks for one 8B stream, far from filling 132
// SMs) and reading a page table in-kernel.
//
// Math is fp32 throughout, as in the TPU kernel; the fold keeps a finite
// shift for rows whose max is still -inf and maps l == 0 to 1, so a row with
// length 0 returns zeros.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // = keys per tile
constexpr int kMaxRep = 8;     // query heads per kv head
constexpr int kBatch = 8;      // rows each thread loads before using them

// 8 elements of a row, as loaded (16 bytes of bf16, 32 of float32)
template <typename T> struct Raw8;
template <> struct Raw8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void get(float* out) const {
    tt_load8(reinterpret_cast<const __nv_bfloat16*>(&u), out);
  }
};
template <> struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void get(float* out) const {
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
};

// Thread layout: a key row of D elements is read by a team of D / 8
// consecutive lanes, 16 bytes each (D is a power of two, 8..256, so teams
// never straddle a warp); the block's kThreads / (D / 8) teams take the
// tile's keys in turn.  Each thread keeps its 8-dim slice of every head's
// query and output accumulator in registers.
template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, T* __restrict__ out, int S, int D,
    int n_rep, long long q_sb, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_sh, float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int team = D >> 3;          // lanes per key row
  const int c = tid & (team - 1);   // this lane's 8-dim slice
  const int r = tid / team;         // this lane's team
  const int teams = kThreads / team;

  extern __shared__ float smem[];
  float* p_s = smem;                     // [n_rep][kThreads] scores / probs
  float* red = p_s + n_rep * kThreads;   // [warps][D] output sums
  float* m_s = red + (kThreads / 32) * D;  // [n_rep] running max
  float* l_s = m_s + n_rep;              // [n_rep] running sum
  float* a_s = l_s + n_rep;              // [n_rep] this tile's rescale

  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);

  float qr[kMaxRep][8];
  float acc[kMaxRep][8];
  const T* qb = q + b * q_sb + (long long)kvh * n_rep * q_sh + c * 8;
#pragma unroll
  for (int h = 0; h < kMaxRep; ++h) {
#pragma unroll
    for (int e = 0; e < 8; ++e) qr[h][e] = acc[h][e] = 0.f;
    if (h < n_rep) {
      tt_load8(qb + h * q_sh, qr[h]);
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[h][e] *= scale;
    }
  }
  if (tid < n_rep) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  const T* kb = k + b * k_sb + kvh * k_sh + c * 8;
  const T* vb = v + b * v_sb + kvh * v_sh + c * 8;
  __syncthreads();

  for (int k0 = 0; k0 < len; k0 += kThreads) {
    const int live = min(kThreads, len - k0);

    // scores: each team dots its keys' rows with every head's query
    for (int i0 = 0; i0 < team; i0 += kBatch) {
      Raw8<T> raw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int jj = r + (i0 + u) * teams;
        if (i0 + u < team && jj < live) raw[u].load(kb + (k0 + jj) * k_ss);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int jj = r + (i0 + u) * teams;
        if (i0 + u >= team) break;
        float kv[8];
        raw[u].get(kv);
        float part[kMaxRep];
#pragma unroll
        for (int h = 0; h < kMaxRep; ++h) {
          part[h] = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) part[h] += qr[h][e] * kv[e];
        }
        for (int o = team >> 1; o > 0; o >>= 1) {
#pragma unroll
          for (int h = 0; h < kMaxRep; ++h)
            part[h] += __shfl_xor_sync(0xffffffffu, part[h], o);
        }
        if (c == 0) {
          for (int h = 0; h < n_rep; ++h)
            p_s[h * kThreads + jj] = jj < live ? part[h] : -INFINITY;
        }
      }
    }
    __syncthreads();

    // the fold, one warp per head
    for (int h = warp; h < n_rep; h += kThreads / 32) {
      float* ph = p_s + h * kThreads;
      float mx = -INFINITY;
      for (int i = lane; i < kThreads; i += 32) mx = fmaxf(mx, ph[i]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mx);
      const float shift = tt_shift(m_new);
      float sum = 0.f;
      for (int i = lane; i < kThreads; i += 32) {
        const float p = expf(ph[i] - shift);
        ph[i] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = tt_alpha(m_old, shift);
        l_s[h] = l_s[h] * alpha + sum;
        m_s[h] = m_new;
        a_s[h] = alpha;
      }
    }
    __syncthreads();

    // P.V: each team accumulates its keys' value rows
#pragma unroll
    for (int h = 0; h < kMaxRep; ++h) {
      const float alpha = h < n_rep ? a_s[h] : 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[h][e] *= alpha;
    }
    for (int i0 = 0; i0 < team; i0 += kBatch) {
      Raw8<T> raw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int jj = r + (i0 + u) * teams;
        if (i0 + u < team && jj < live) raw[u].load(vb + (k0 + jj) * v_ss);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int jj = r + (i0 + u) * teams;
        if (i0 + u >= team || jj >= live) break;
        float vv[8];
        raw[u].get(vv);
#pragma unroll
        for (int h = 0; h < kMaxRep; ++h) {
          if (h < n_rep) {
            const float p = p_s[h * kThreads + jj];
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[h][e] += p * vv[e];
          }
        }
      }
    }
    __syncthreads();
  }

  // sum the teams' partial outputs in a fixed order (a butterfly within the
  // warp, then the warps in turn), so that a repeated call gives the same
  // bits: greedy decoding must not flip on a near tie from run to run
  for (int o = 16; o >= team; o >>= 1) {
#pragma unroll
    for (int h = 0; h < kMaxRep; ++h) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[h][e] += __shfl_xor_sync(0xffffffffu, acc[h][e], o);
    }
  }
  T* ob = out + b * o_sb + (long long)kvh * n_rep * o_sh;
#pragma unroll
  for (int h = 0; h < kMaxRep; ++h) {
    if (h >= n_rep) break;
    if (lane < team) {
#pragma unroll
      for (int e = 0; e < 8; ++e) red[warp * D + c * 8 + e] = acc[h][e];
    }
    __syncthreads();
    float l = l_s[h];
    l = l == 0.f ? 1.f : l;
    for (int dd = tid; dd < D; dd += kThreads) {
      float sum = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) sum += red[w * D + dd];
      tt_store(ob + h * o_sh + dd, sum / l);
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int B, int H, int Hkv, int S, int D, long long q_sb,
           long long q_sh, long long k_sb, long long k_ss, long long k_sh,
           long long v_sb, long long v_ss, long long v_sh, long long o_sb,
           long long o_sh, float scale, cudaStream_t stream) {
  const int n_rep = H / Hkv;
  const size_t smem =
      sizeof(float) * ((size_t)n_rep * kThreads + (kThreads / 32) * D +
                       3 * n_rep);
  dim3 grid(Hkv, B);
  decode_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), S, D, n_rep,
      q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes and strides (in elements) are checked by the Python wrapper:
// H % Hkv == 0, H / Hkv <= 8, D a power of two in [8, 256], 16-byte
// aligned rows.
extern "C" int tt_decode_attention(
    int dtype, const void* q, const void* k, const void* v,
    const int* lengths, void* out, int B, int H, int Hkv, int S, int D,
    long long q_sb, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_sh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == TT_BF16)
    return launch<__nv_bfloat16>(q, k, v, lengths, out, B, H, Hkv, S, D, q_sb,
                                 q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                                 o_sb, o_sh, scale, st);
  if (dtype == TT_F32)
    return launch<float>(q, k, v, lengths, out, B, H, Hkv, S, D, q_sb, q_sh,
                         k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh,
                         scale, st);
  return (int)cudaErrorInvalidValue;
}
