// Operand element types of the attention and correlation kernels: float,
// __half and __nv_bfloat16.  As in the TPU kernels
// (mxnet_tpu/ops/pallas_kernels.py: `.astype(jnp.float32)` on every load,
// `.astype(o_ref.dtype)` on the store), the output is rounded once to the
// operands' type, to nearest even, and float16 and bfloat16 convert to
// float32 exactly.  Correlation's 16-bit instances convert each element to
// float32 as it is loaded and keep the float32 arithmetic, so they compute
// what the float32 instance computes on the same values upcast; the
// attention kernels' 16-bit instances stage K and V in their own type and
// convert them at the shared-memory read or multiply them there on the
// tensor cores (attention.cuh).
//
// stage_f32 (correlation's 16-bit loads): each thread loads kN consecutive
// elements (16 bytes for kN = 8, 8 for kN = 4, or one), converts them and
// stores kN float32s, so the shared-memory layout and every read of it
// stay those of the float32 instance.  Dtype codes of the C interfaces: 0
// float32, 1 float16, 2 bfloat16 (as mxtt_fc_epilogue).

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

// The register type of one load of kBytes.
template <int kBytes> struct RawOf;
template <> struct RawOf<2> { using type = unsigned short; };
template <> struct RawOf<4> { using type = unsigned int; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<16> { using type = uint4; };

// src[0 .. kN) as float32 into dst[0 .. kN) (shared memory) through
// registers, one load of kN·sizeof(T) bytes; zeros, and no read, when
// `valid` is false.  src aligned to kN·sizeof(T), dst to 16 bytes when
// kN % 4 == 0.
template <int kN, typename T>
__device__ __forceinline__ void stage_f32(float* dst, const T* src,
                                          bool valid) {
  using Raw = typename RawOf<kN * static_cast<int>(sizeof(T))>::type;
  float f[kN];
  if (valid) {
    const Raw raw = *reinterpret_cast<const Raw*>(src);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kN; ++i) f[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < kN; ++i) f[i] = 0.f;
  }
  if constexpr (kN % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kN; i += 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < kN; ++i) dst[i] = f[i];
  }
}

// Whether p is aligned to `bytes`.
inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace mxtt
