// Shared helpers of the attention kernels: element loads/stores in the two
// operand types (float32, bfloat16) and the online-softmax shift rule.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// dtype codes passed by the Python wrappers (tpuserver_torch/ops/flash.py)
enum { TT_F32 = 0, TT_BF16 = 1 };

__device__ __forceinline__ void tt_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void tt_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Eight consecutive elements as floats; p must be 16-byte aligned.
__device__ __forceinline__ void tt_load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void tt_load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// The online-softmax fold of tpuserver/ops/flash.py::_online_softmax_fold:
// a row whose running max is still -inf gets a finite shift (0) so that
// exp(-inf - shift) is 0, never nan; its old state is scaled by 0.
__device__ __forceinline__ float tt_shift(float m_new) {
  return isfinite(m_new) ? m_new : 0.f;
}
__device__ __forceinline__ float tt_alpha(float m_old, float shift) {
  return isfinite(m_old) ? expf(m_old - shift) : 0.f;
}
