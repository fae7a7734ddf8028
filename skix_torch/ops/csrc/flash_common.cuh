// Pieces shared by the attention kernels of skix_torch (the forward core
// flash_tc.cuh, the backward core flash_bwd_tc.cuh): dtype conversions,
// the rounding helpers that repeat the TPU kernels' casts, and the rope's
// rotation by code table.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace skix {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and read back as f32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// rot(x)[d] of one row: the rope style's signed permutation. TB false:
// rotate-half within each D/2 half by index (y[j] = -x[j + D/4],
// y[j + D/4] = x[j]), the style of every default path, compiled without a
// table read; TB true: one int32 code per column of `rot` (interleaved
// pairs, rotate-half per segment), code = sign * (partner + 1), code 0
// marking a column the style leaves untouched (a segments tail), whose rot
// is 0. Exact: a copy and a sign.
template <int D, bool TB, typename T>
__device__ __forceinline__ float rot_at(const T* __restrict__ row, const int* __restrict__ rot,
                                        int d) {
  if constexpr (!TB) {
    constexpr int Q4 = D / 4;
    const bool lo = (d % (D / 2)) < Q4;
    const float partner = to_f32(row[lo ? d + Q4 : d - Q4]);
    return lo ? -partner : partner;
  } else {
    const int c = rot[d];
    if (c == 0) return 0.f;
    return c > 0 ? to_f32(row[c - 1]) : -to_f32(row[-c - 1]);
  }
}

}  // namespace skix
