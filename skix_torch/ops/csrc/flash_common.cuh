// Pieces shared by the attention kernels of skix_torch (the forward core
// flash_tc.cuh, the backward flash_bwd_common.cuh): dtype conversions, the
// rounding helpers that repeat the TPU kernels' casts, the rope's rotation
// by code table, and the output-column map and f32 FMA update of the
// backward's P.V-shaped loops.

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

// The output columns of the P.V loops: the 16 column groups of a row group
// split the D columns, D/16 each. D = 32: two neighbours (cg*2, cg*2 + 1);
// D = 64, 128: four neighbours in each 64-column chunk (nc*64 + cg*4 + j),
// so the v tile is read as float4.
template <int D> __device__ __forceinline__ int out_col(int cg, int j) {
  if constexpr (D == 32) {
    return cg * 2 + j;
  } else {
    return (j / 4) * 64 + cg * 4 + (j % 4);
  }
}

// acc[i][j] += a[i] * Vrow[out_col<D>(cg, j)] for NR rows, reading the v
// row of the shared tile in the widest load the column map allows.
template <int D, int NR>
__device__ __forceinline__ void pv_update(float (&acc)[NR][D / 16], const float (&a)[NR],
                                          const float* __restrict__ vrow, int cg) {
  if constexpr (D == 32) {
    const float2 c = *reinterpret_cast<const float2*>(&vrow[cg * 2]);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      acc[i][0] = fmaf(a[i], c.x, acc[i][0]);
      acc[i][1] = fmaf(a[i], c.y, acc[i][1]);
    }
  } else {
#pragma unroll
    for (int nc = 0; nc < D / 64; ++nc) {
      const float4 c = *reinterpret_cast<const float4*>(&vrow[nc * 64 + cg * 4]);
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][nc * 4 + j] = fmaf(a[i], cv[j], acc[i][nc * 4 + j]);
    }
  }
}

}  // namespace skix
