// W8A16 product for sm_90a: y[M, N] = bf16( bf16(sum_k x[m,k] q[k,n]) *
// bf16(s[n]) ), x bf16 [M, K] (row stride ldx), q int8 [K, N] row-major
// (N contiguous, the reference's [in, out] layout), s float32 [N], the sum
// accumulated in float32.
//
// Replaces: no Pallas kernel.  The JAX package's weight-only int8 product
// (tpuserver/ops/quant.py::matmul, decode-scale regime) is
// `x @ q.astype(x.dtype) * s`, which XLA fuses so that the weight's int8
// bytes are read once and converted in registers.  PyTorch has no such
// fusion (a bf16 copy of the weight is written and read back: 5 bytes a
// parameter against 1), so this kernel is its counterpart.
//
// Bound: bytes at decode (M 1 to 8: K*N weight bytes for 2*M*K*N
// operations, far below the H100's ~295 operations a byte); the CUDA
// cores' FMA rate comes close at M 8 and binds above it (no tensor cores
// yet).  The design streams each weight byte once: a warp reads two
// weight rows' 128 contiguous bytes at a time (8-byte loads, evict-first),
// a thread issues all of an iteration's loads before it uses the first,
// and int8 becomes float by a byte permute and an exact add instead of the
// slow integer-to-float conversion.  The block's rows of x for its split
// (at most 1024 columns of them) wait in shared memory, so registers hold
// the accumulators and the weight loads in flight.
//
// Layout: a block owns 128 columns, up to MT rows and one split of K
// (grid: column tiles x splits x row tiles).  Its 256 threads are 16
// column groups (8 columns each) by 16 k-lanes; k-lane r sums its split's
// k = r, r + 16, r + 32, ... in that order, the two k-lanes of a warp add by
// one shuffle, and the 8 warps in order through shared memory.  With more
// than one split (``n_split`` and ``split_rows`` come from the wrapper and
// depend on K and N only), each block stores its partial sums, and the
// last block of a tile to finish (a ticket counter, which is no part of
// the sum) adds the splits in split order.  So each output element's
// reduction over K runs in one fixed order whatever M is and wherever its
// row sits: a row's bits do not depend on the rows beside it, and no sum
// goes through an atomic.  Rows past K add x = 0 times a finite weight,
// exact zeros (x past K is staged as 0), so every thread of a split runs
// the same iterations.
//
// Simple first: no tensor cores, no TMA, no persistent schedule (a later
// redesign: wgmma with the int8 -> bf16 conversion in registers).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 8;                          // columns a thread owns
constexpr int kColGroups = 16;                    // threads across a block
constexpr int kBlockN = kCols * kColGroups;       // 128 columns a block
constexpr int kLanesK = kThreads / kColGroups;    // 16 k-lanes
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplitRows = 1024;               // x's staged columns

// Four int8 (one 32-bit word) as floats, exactly: each byte, biased by
// 128, becomes the low mantissa byte of 2^23 (0x4B0000bb is 2^23 + bb),
// and 2^23 + 128 is subtracted.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) -
           8388736.f;
}

// The 8 weights q[k, n0 .. n0+7] of a row k < K as raw bytes.  VEC: rows
// are 8-byte aligned (N % 8 == 0), and a block's columns past N read the
// row's last 8 (their sums are never stored), so the load is one
// unconditional instruction whose result nothing waits for until the
// compute loop; else byte loads, columns past N reading 0.
template <bool VEC>
__device__ __forceinline__ uint2 load_q(const int8_t* __restrict__ q, int k,
                                        int n0, int N) {
  const int8_t* row = q + (long long)k * N;
  if (VEC)
    return __ldcs(reinterpret_cast<const uint2*>(row + min(n0, N - kCols)));
  uint2 r = make_uint2(0u, 0u);
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const uint32_t b = n0 + c < N ? (uint8_t)row[n0 + c] : 0u;
    if (c < 4) r.x |= b << (8 * c);
    else r.y |= b << (8 * (c - 4));
  }
  return r;
}

// The two roundings of the reference: the float32 sum to bf16, then its
// product with the bf16 scale.
__device__ __forceinline__ __nv_bfloat16 finish(float sum, float scale) {
  const float r = __bfloat162float(__float2bfloat16(sum));
  return __float2bfloat16(r * __bfloat162float(__float2bfloat16(scale)));
}

// MT: rows of a block's tile; U: k-rows a thread loads before it uses the
// first (its loads in flight).  part: [n_split, M, N] float32 partial sums
// (unused with one split); tickets: one zeroed counter a tile, left zeroed
// again.
template <int MT, int U, bool VEC>
__global__ void __launch_bounds__(kThreads)
    w8a16_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                 const int8_t* __restrict__ q, const float* __restrict__ s,
                 __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                 unsigned int* __restrict__ tickets, int M, int N, int K,
                 int split_rows) {
  // x's tile [MT][split_rows] (bf16) during the K loop, then the warps'
  // sums [kWarps][MT][kBlockN] (float32)
  constexpr int kSmem = MT * (kMaxSplitRows * 2 > kWarps * kBlockN * 4
                                  ? kMaxSplitRows * 2 : kWarps * kBlockN * 4);
  __shared__ __align__(16) unsigned char smem[kSmem];
  __shared__ bool last;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float (*red)[MT][kBlockN] = reinterpret_cast<float (*)[MT][kBlockN]>(smem);
  const int t = threadIdx.x;
  const int cg = t % kColGroups;
  const int lane_k = t / kColGroups;
  const int n0 = blockIdx.x * kBlockN + cg * kCols;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int m0 = blockIdx.z * MT;
  const int kbeg = split * split_rows;
  // stage x: rows past M repeat row M - 1 (their sums are never stored),
  // columns past K are 0
  for (int i = t; i < MT * split_rows; i += kThreads) {
    const int m = i / split_rows, k = kbeg + i % split_rows;
    xs[i] = k < K ? x[(long long)min(m0 + m, M - 1) * ldx + k]
                  : __float2bfloat16(0.f);
  }
  __syncthreads();

  float acc[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;

  constexpr int kStep = U * kLanesK;
  for (int k0 = 0; k0 < split_rows; k0 += kStep) {
    // every weight load of the iteration first, from rows clamped to K - 1
    // (no branch; x is 0 there)
    uint2 raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      raw[u] = load_q<VEC>(q, min(kbeg + k0 + lane_k + u * kLanesK, K - 1),
                           n0, N);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = k0 + lane_k + u * kLanesK;
      float qf[kCols];
      i8x4_to_f32(raw[u].x, qf);
      i8x4_to_f32(raw[u].y, qf + 4);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = __bfloat162float(xs[m * split_rows + kk]);
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[m][c] = fmaf(xv, qf[c], acc[m][c]);
      }
    }
  }
  __syncthreads();  // x's tile is read: its memory takes the warps' sums

  // the warp's two k-lanes that share these columns (lanes l and l^16):
  // one shuffle, whose sum both hold alike
  const int lane = t % 32, warp = t / 32;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], 16);
  if (lane < kColGroups) {  // lane == cg here
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        red[warp][m][lane * kCols + c] = acc[m][c];
  }
  __syncthreads();
  // the 8 warps in order: this split's sums
  for (int i = t; i < MT * kBlockN; i += kThreads) {
    const int m = i / kBlockN, col = i % kBlockN;
    const int n = blockIdx.x * kBlockN + col;
    if (m0 + m >= M || n >= N) continue;
    float sum = red[0][m][col];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += red[w][m][col];
    if (n_split == 1)
      y[(long long)(m0 + m) * N + n] = finish(sum, s[n]);
    else
      part[((long long)split * M + m0 + m) * N + n] = sum;
  }
  if (n_split == 1) return;

  // the tile's last block to finish adds the splits in split order
  __threadfence();
  __syncthreads();
  unsigned int* ticket = tickets + blockIdx.z * gridDim.x + blockIdx.x;
  if (t == 0) last = atomicAdd(ticket, 1u) == (unsigned int)n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long long stride = (long long)M * N;
  for (int i = t; i < MT * kBlockN; i += kThreads) {
    const int m = i / kBlockN, col = i % kBlockN;
    const int n = blockIdx.x * kBlockN + col;
    if (m0 + m >= M || n >= N) continue;
    const float* p = part + (long long)(m0 + m) * N + n;
    // eight splits' loads in flight at a time, added in split order
    float sum = 0.f;
    for (int j0 = 0; j0 < n_split; j0 += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = j0 + u < n_split ? __ldcg(p + (j0 + u) * stride) : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (j0 + u < n_split) sum = j0 + u == 0 ? v[0] : sum + v[u];
    }
    y[(long long)(m0 + m) * N + n] = finish(sum, s[n]);
  }
  if (t == 0) *ticket = 0u;  // zeroed for the next launch on the stream
}

template <int MT, int U>
int launch(const void* x, long long ldx, const void* q, const void* s,
           void* y, void* part, void* tickets, int M, int N, int K,
           int n_split, int split_rows, cudaStream_t stream) {
  const dim3 grid((N + kBlockN - 1) / kBlockN, n_split, (M + MT - 1) / MT);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* sp = static_cast<const float*>(s);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  auto* pp = static_cast<float*>(part);
  auto* tp = static_cast<unsigned int*>(tickets);
  if (N % 8 == 0)
    w8a16_kernel<MT, U, true><<<grid, kThreads, 0, stream>>>(
        xp, ldx, qp, sp, yp, pp, tp, M, N, K, split_rows);
  else
    w8a16_kernel<MT, U, false><<<grid, kThreads, 0, stream>>>(
        xp, ldx, qp, sp, yp, pp, tp, M, N, K, split_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// y [M, N] bf16 (contiguous) = W8A16(x [M, K] bf16 with row stride ldx,
// q [K, N] int8 contiguous and 16-byte aligned, s [N] float32), K cut into
// n_split splits of split_rows rows (a multiple of 256, at most 1024); with
// more than one
// split, part is a float32 [n_split, M, N] scratch and tickets holds
// ceil(N / 128) * ceil(M / MT) zeroed counters (MT = the row tile below).
// Returns the launch's cudaError_t.  The row tile follows M (1, 2, 4,
// else 8 rows), which changes no element's order of summation.
extern "C" int tt_int8_matmul(const void* x, long long ldx, const void* q,
                              const void* s, void* y, void* part,
                              void* tickets, int M, int N, int K,
                              int n_split, int split_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1 || n_split < 1 || split_rows % 256 ||
      split_rows > kMaxSplitRows || (long long)n_split * split_rows < K ||
      (n_split > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (M == 1)
    return launch<1, 16>(x, ldx, q, s, y, part, tickets, M, N, K, n_split,
                         split_rows, st);
  if (M == 2)
    return launch<2, 16>(x, ldx, q, s, y, part, tickets, M, N, K, n_split,
                         split_rows, st);
  if (M <= 4)
    return launch<4, 16>(x, ldx, q, s, y, part, tickets, M, N, K, n_split,
                         split_rows, st);
  return launch<8, 8>(x, ldx, q, s, y, part, tickets, M, N, K, n_split,
                      split_rows, st);
}
