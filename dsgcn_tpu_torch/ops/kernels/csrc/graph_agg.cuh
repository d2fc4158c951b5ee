// What every aggregation kernel shares: the limits on joints and edge
// classes, the float32/bfloat16 conversions, and the stride of the
// (channel, joint) query tables.  The graph build and the aggregation live
// in graph_agg_tiled.cuh (K1-K6); K7 (ms_tcn.cu) takes the conversions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace dsgcn {

constexpr int VMAX = 32;     // most joints a graph may have
constexpr int EMAX = 16;     // most edge classes

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Odd row stride of the (channel, joint) tables, so that threads of one
// warp reading one joint of consecutive channels hit distinct banks.
__host__ __device__ inline int row_stride(int V) { return V | 1; }

}  // namespace dsgcn
