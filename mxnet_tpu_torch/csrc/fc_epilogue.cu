// Fully connected layer with its epilogue in one kernel:
//
//     out = act(x · Wᵀ + b)                      in x's dtype, or
//     out = clamp(rint(act(x · Wᵀ + b) * r), ±127)   as int8 when r is given
//
// r is the float32 reciprocal of the requantize scale s, computed by the
// wrapper: the reference's XLA rewrites y / s as y * (1/s), so the codes
// follow that product.
//
// x (M, K), W (N, K), b (N,) or none; x and W in float32, float16 or
// bfloat16, converted to float32 on load and summed in float32.  act is
// none, relu, sigmoid = 1/(1+e^-v), tanh or softrelu = logaddexp(v, 0).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py:326
// (_fc_epilogue_kernel, launched by fused_fc_epilogue at line 347).  The
// TPU version needed N % 128 == 0 and K % 128 == 0 for its MXU tiling; this
// kernel takes any M, N, K and masks the ragged edges itself.
//
// What bounds it.  On the serving path it runs VGG-16's fc6 (M <= 8,
// K = 25088, N = 4096) and fc7 (M <= 8, K = 4096, N = 4096) in float32.
// At M <= 8 the product does at most 2·8 flops per 4-byte weight, about
// 4 flop/byte, while the card balances float32 compute outside the tensor
// cores against memory near 20 flop/byte (67 TFLOP/s over 3.35 TB/s).  So
// the whole game is streaming W from device memory once: 411 MB for fc6
// (123 us at 3.35 TB/s), 67 MB for fc7 (20 us).
//
// Design.  A block is 4 warps and owns 16 output columns (4 rows of W per
// warp) and 8 output rows.  It walks K in tiles of 256.  Its 8 rows of x
// for a tile sit in shared memory as float32, double-buffered: while the
// warps multiply tile t out of one buffer, every thread already holds its
// share of tile t+1 in registers (x is small and mostly read from L2) and
// stores it into the other buffer afterwards, so the x reads overlap the W
// stream and a tile costs one barrier.  Each lane streams 4 consecutive K
// elements of each of its warp's 4 W rows straight into registers, one
// vector load per row, reading W along K where it is contiguous, and
// multiplies them against all 8 staged x rows.  Each W element is used by
// exactly one lane, so W skips shared memory and is loaded with the
// streaming (evict-first) hint.  Sums stay in float32 registers; after the
// K walk a warp shuffle reduces each lane's 32 partial sums, and each lane
// applies bias, activation and the optional int8 requantize to one output
// before a single store.  N = 4096 gives 256 blocks for 132 SMs.  Split-K,
// TMA/cp.async pipelines and wgmma are left to later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;                          // warps per block
constexpr int kRowsPerWarp = 4;                    // W rows per warp
constexpr int kTileN = kWarps * kRowsPerWarp;      // output columns per block
constexpr int kTileM = 8;                          // output rows per block
constexpr int kTileK = 256;                        // K elements per x tile
constexpr int kVec = 4;                            // K elements per lane load
constexpr int kStep = 32 * kVec;                   // K elements per warp load
static_assert(kTileM * kRowsPerWarp == 32, "one output per lane");
static_assert(kTileK % kStep == 0, "whole warp steps per tile");

enum Act { kNone = 0, kRelu = 1, kSigmoid = 2, kTanh = 3, kSoftrelu = 4 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A vector of kVec elements of T: 16 bytes for float, 8 for the 16-bit types.
template <typename T> struct VecOf { using type = uint2; };
template <> struct VecOf<float> { using type = float4; };

// Loads p[0..3] as float.  `vec` says p is aligned for one vector load;
// `valid` is the number of elements before the end of the row.  `stream`
// marks data read once (W): it bypasses the caches' keep-alive.
template <typename T, bool kStream>
__device__ __forceinline__ void load4(const T* __restrict__ p, int valid,
                                      bool vec, float out[kVec]) {
  using V = typename VecOf<T>::type;
  if (vec && valid >= kVec) {
    V raw = kStream ? __ldcs(reinterpret_cast<const V*>(p))
                    : __ldg(reinterpret_cast<const V*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) out[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) out[i] = i < valid ? to_f32(p[i]) : 0.f;
  }
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.f);
    case kSigmoid: return 1.f / (1.f + expf(-v));
    case kTanh: return tanhf(v);
    case kSoftrelu: return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
    default: return v;
  }
}

template <typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(kWarps * 32)
fc_epilogue_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   const float* __restrict__ bias, TO* __restrict__ out,
                   int M, int N, int K, int act, float inv_scale,
                   bool vec_x, bool vec_w) {
  __shared__ __align__(16) float xs[2][kTileM][kTileK];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * kTileM;
  const int rows = min(kTileM, M - m0);
  const int n0 = blockIdx.x * kTileN + warp * kRowsPerWarp;

  float acc[kTileM][kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kTileM; ++r)
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) acc[r][j] = 0.f;

  // x tiles are double-buffered: while the block multiplies tile t out of
  // one buffer, each thread holds its share of tile t+1 in registers and
  // stores it into the other buffer afterwards; one barrier per tile.
  constexpr int kPer = kTileM * (kTileK / kVec) / (kWarps * 32);
  float4 nxt[kPer];
  auto fetch = [&](int k0) {
    const int kt = min(kTileK, K - k0);
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int i = threadIdx.x + p * kWarps * 32;
      const int r = i / (kTileK / kVec);
      const int c = (i % (kTileK / kVec)) * kVec;
      float v[kVec] = {0.f, 0.f, 0.f, 0.f};
      if (r < rows && c < kt)
        load4<TX, false>(x + (size_t)(m0 + r) * K + k0 + c, kt - c, vec_x, v);
      nxt[p] = make_float4(v[0], v[1], v[2], v[3]);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int i = threadIdx.x + p * kWarps * 32;
      const int r = i / (kTileK / kVec);
      const int c = (i % (kTileK / kVec)) * kVec;
      *reinterpret_cast<float4*>(&xs[buf][r][c]) = nxt[p];
    }
  };
  fetch(0);
  stash(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += kTileK, buf ^= 1) {
    const int kt = min(kTileK, K - k0);
    const bool more = k0 + kTileK < K;
    if (more) fetch(k0 + kTileK);
#pragma unroll
    for (int s = 0; s < kTileK / kStep; ++s) {
      const int c = s * kStep + lane * kVec;
      if (c < kt) {
        float wv[kRowsPerWarp][kVec];
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          if (n0 + j < N) {
            load4<TW, true>(w + (size_t)(n0 + j) * K + k0 + c, kt - c, vec_w,
                            wv[j]);
          } else {
#pragma unroll
            for (int e = 0; e < kVec; ++e) wv[j][e] = 0.f;
          }
        }
#pragma unroll
        for (int r = 0; r < kTileM; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(&xs[buf][r][c]);
#pragma unroll
          for (int j = 0; j < kRowsPerWarp; ++j) {
            float a = acc[r][j];
            a = fmaf(xv.x, wv[j][0], a);
            a = fmaf(xv.y, wv[j][1], a);
            a = fmaf(xv.z, wv[j][2], a);
            a = fmaf(xv.w, wv[j][3], a);
            acc[r][j] = a;
          }
        }
      }
    }
    if (more) stash(buf ^ 1);
    __syncthreads();
  }

  // Sum the lanes' partial sums: afterwards every lane holds every total.
#pragma unroll
  for (int r = 0; r < kTileM; ++r)
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      float v = acc[r][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[r][j] = v;
    }

  // Lane r * kRowsPerWarp + j finishes output (m0 + r, n0 + j).  The select
  // loop keeps acc in registers (a dynamic index would spill it).
  const int my_r = lane / kRowsPerWarp;
  const int my_j = lane % kRowsPerWarp;
  float v = 0.f;
#pragma unroll
  for (int r = 0; r < kTileM; ++r)
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j)
      if (r == my_r && j == my_j) v = acc[r][j];
  const int n = n0 + my_j;
  if (my_r >= rows || n >= N) return;
  if (bias != nullptr) v += bias[n];
  v = activate(v, act);
  TO* dst = out + (size_t)(m0 + my_r) * N + n;
  if constexpr (std::is_same<TO, int8_t>::value) {
    // Multiply by the reciprocal and round half to even, as the
    // reference's jnp.round(y / out_scale) computes after XLA's rewrite.
    const float q = fminf(fmaxf(rintf(v * inv_scale), -127.f), 127.f);
    *dst = static_cast<int8_t>(q);
  } else {
    store(dst, v);
  }
}

template <typename T>
bool aligned4(const void* p, int K) {
  return K % kVec == 0 &&
         reinterpret_cast<uintptr_t>(p) % (kVec * sizeof(T)) == 0;
}

template <typename TX, typename TW, typename TO>
cudaError_t launch(const void* x, const void* w, const float* bias, void* out,
                   int M, int N, int K, int act, float inv_scale,
                   cudaStream_t stream) {
  const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
  fc_epilogue_kernel<TX, TW, TO><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), bias,
      static_cast<TO*>(out), M, N, K, act, inv_scale, aligned4<TX>(x, K),
      aligned4<TW>(w, K));
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch_out(const void* x, const void* w, const float* bias,
                       void* out, int M, int N, int K, int act, int quantize,
                       float inv_scale, cudaStream_t stream) {
  if (quantize)
    return launch<TX, TW, int8_t>(x, w, bias, out, M, N, K, act, inv_scale,
                                  stream);
  return launch<TX, TW, TX>(x, w, bias, out, M, N, K, act, inv_scale, stream);
}

template <typename TX>
cudaError_t launch_w(int w_dtype, const void* x, const void* w,
                     const float* bias, void* out, int M, int N, int K,
                     int act, int quantize, float inv_scale,
                     cudaStream_t stream) {
  switch (w_dtype) {
    case 0: return launch_out<TX, float>(x, w, bias, out, M, N, K, act,
                                         quantize, inv_scale, stream);
    case 1: return launch_out<TX, __half>(x, w, bias, out, M, N, K, act,
                                          quantize, inv_scale, stream);
    case 2: return launch_out<TX, __nv_bfloat16>(x, w, bias, out, M, N, K,
                                                 act, quantize, inv_scale,
                                                 stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 float16, 2 bfloat16.  act codes as in Act.
// The output is in x's dtype, or int8 when quantize is nonzero.  Returns a
// cudaError_t: the launch's configuration error, if any.  Faults during the
// run surface at the caller's next synchronisation.
extern "C" int mxtt_fc_epilogue(const void* x, const void* w, const void* bias,
                                void* out, int M, int N, int K, int x_dtype,
                                int w_dtype, int act, int quantize,
                                float inv_scale, int device, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || act < kNone || act > kSoftrelu)
    return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return err;
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0: return launch_w<float>(w_dtype, x, w, b, out, M, N, K, act,
                                   quantize, inv_scale, s);
    case 1: return launch_w<__half>(w_dtype, x, w, b, out, M, N, K, act,
                                    quantize, inv_scale, s);
    case 2: return launch_w<__nv_bfloat16>(w_dtype, x, w, b, out, M, N, K,
                                           act, quantize, inv_scale, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
