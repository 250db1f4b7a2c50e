// Operand element types of the kernels: float, __half and
// __nv_bfloat16.  As in the TPU kernels (mxnet_tpu/ops/pallas_kernels.py:
// `.astype(jnp.float32)` on every load, `.astype(o_ref.dtype)` on the
// store), the output is rounded once to the operands' type, to nearest
// even, and float16 and bfloat16 convert to float32 exactly.  The 16-bit
// instances stage their operands in their own type and either convert
// each value as they read it (correlation's |a − b|, paged's one-row path,
// fc_epilogue's SIMT instances) or multiply them on the tensor cores
// (attention.cuh's mma_16: flash, paged's row tiles, correlation's
// products, fc_epilogue's tensor-core instance).  fc_epilogue.cu takes its
// conversions from here too.  Dtype codes of the C interfaces: 0 float32,
// 1 float16, 2 bfloat16 (as mxtt_fc_epilogue).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mxtt {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// v rounded to T, to nearest even
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}

// Whether p is aligned to `bytes`.
inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace mxtt
