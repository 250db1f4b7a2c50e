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
// K = 25088, N = 4096) and fc7 (M <= 8, K = 4096, N = 4096).  At M <= 8
// the product does at most 2·8 flops per weight, far below what the card
// balances against memory (about 20 flop/byte in float32 outside the
// tensor cores, 295 on them), so the whole game is streaming W from device
// memory once: 411 MB for fc6 + fc7 in float32 (123 us at 3.35 TB/s), 239
// MB in float16 or bfloat16 (71 us).
//
// Two designs, chosen by the launcher (tc_route below):
//
// The SIMT instances (float32 operands, mixed dtype pairs, and 16-bit
// shapes the tensor-core instance cannot load).  A block is 4 warps and
// owns kRowsPerWarp rows of W per warp, 4 * kRowsPerWarp output columns
// (block_n), and 8 output rows.  block_n is a template parameter: 16 by
// default, and 8 and 32 besides for float32 x and W (float32 or int8
// out), the tiles the kernel search chooses among; the other dtype pairs
// have the default tile only, which keeps the library's build short.  A
// block walks K in tiles of 256.  Its 8 rows of x for a tile sit in shared
// memory as float32, double-buffered: while the warps multiply tile t out
// of one buffer, every thread already holds its share of tile t+1 in
// registers (x is small and mostly read from L2) and stores it into the
// other buffer afterwards, so the x reads overlap the W stream and a tile
// costs one barrier.  Each lane streams 4 consecutive K elements of each
// of its warp's W rows straight into registers, one vector load per row,
// reading W along K where it is contiguous, and multiplies them against
// all 8 staged x rows.  Each W element is used by exactly one lane, so W
// skips shared memory and is loaded with the streaming (evict-first) hint.
// Sums stay in float32 registers; after the K walk a warp shuffle reduces
// each lane's partial sums, and the lanes apply bias, activation and the
// optional int8 requantize to the warp's outputs (8 * kRowsPerWarp of
// them, one or two a lane, or one on half the lanes) before a single
// store each.  An output's sum runs over K in the same order whatever
// block_n is (the lane of a K element and the shuffle tree do not depend
// on it), so every tile gives bitwise the same result.
//
// The tensor-core instance (x and W both float16 or both bfloat16, K > 0,
// K % 8 == 0, both 16-byte aligned).  The 16-bit instances used to run
// the SIMT design above with 8-byte loads: float32 FMAs on half the bytes,
// a block barrier every 256 K, about 16 KB of W in flight an SM, 0.38
// TB/s.  The product of two 16-bit values is exact in float32, so mma.sync
// m16n8k16 with float32 accumulation computes the same sums in another
// order, and leaves the lanes free to keep loads in flight:
//
// * W in row-major (N, K) is the A operand as it lies (16 output columns
//   x 16 K), x in row-major (M, K) the column-major B operand (16 K x 8
//   rows of x).  Lane (g, t) = (lane / 4, lane % 4) loads K 8t..8t+7 of a
//   32-K chunk from W rows g and g + 8 and from x row g, one 16-byte load
//   each; elements 0..3 are its A and B slots (k 2t, 2t+1, 2t+8, 2t+9) of
//   the chunk's first m16n8k16 step and elements 4..7 those of the second.
//   That permutes K the same way in A and B, so the sum over K is the
//   same sum in another order, and W needs neither shared memory nor
//   ldmatrix.  W is loaded with the evict-first hint, x through L1 (every
//   warp of a column tile reads it).
// * Each warp has kTcUnroll = 8 chunks' loads in flight (8 KB of W)
//   before their products, and a block of 8 warps runs on each SM: up to
//   64 KB of W in flight an SM, where streaming at 3.35 TB/s needs about
//   27 KB (0.8 us of latency under load).
// * Stream-K (tc_plan): the work is the flat list of T (8-row x block,
//   16-column tile, chunk) units, and warp i of `warps` = min(kTcWarps,
//   T) takes units [i T / warps, (i + 1) T / warps): every warp streams
//   the same bytes within one chunk, whatever N's tile count against the
//   132 SMs.  A warp writes its float32 sum of each tile it touches (a
//   piece: one 16 x 8 fragment, 512 bytes) into the tile's slot of a
//   workspace, at its rank among the warps that meet the tile; the
//   wrapper takes the workspace's mxtt_fc_workspace_bytes from the
//   caching allocator.
//   fc_tc_reduce_kernel, launched as a programmatic dependent (it waits
//   on the chip, not behind a launch gap), sums each output's pieces in
//   warp order (a fixed order: no float atomics), adds the bias, applies
//   the activation and the optional int8 requantize, and rounds once
//   (elem.cuh from_f32).  The plan, and so every sum, depends on (M, N,
//   K) alone, so two calls give bitwise the same output.
// * What holds it (kernel_ab.py on variants, fc6 + fc7 at bucket 8): the
//   W stream at ~2.6 TB/s, not the products or x (without its products,
//   or without x's loads, the kernel takes the same time), and the
//   reduction's ~1.5 us a layer.
//
// Split-K over blocks for the SIMT instances, TMA pipelines and wgmma are
// left to later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention.cuh"

namespace {

using mxtt::from_f32;
using mxtt::to_f32;

constexpr int kWarps = 4;                          // warps per block
constexpr int kDefaultRows = 4;                    // W rows per warp, default
constexpr int kTileM = 8;                          // output rows per block
constexpr int kTileK = 256;                        // K elements per x tile
constexpr int kVec = 4;                            // K elements per lane load
constexpr int kStep = 32 * kVec;                   // K elements per warp load
static_assert(kTileK % kStep == 0, "whole warp steps per tile");

// the tensor-core instance: a warp's tile is the m16 x n8 of m16n8k16
constexpr int kTcRows = 16;                        // W rows (output columns)
constexpr int kTcCols = 8;                         // x rows
constexpr int kTcChunk = 32;                       // K a chunk: two k16 steps
constexpr int kTcUnroll = 8;                       // chunks loaded together
constexpr int kTcWarpsPerSM = 8;                   // warps a block, one an SM
constexpr int kTcSMs = 132;                        // the H100 SXM's SMs
constexpr int kTcWarps = kTcSMs * kTcWarpsPerSM;   // the plan's most warps
constexpr int kPieceFloats = kTcRows * kTcCols;    // one piece: 128 floats
constexpr int kReduceThreads = 256;
constexpr int kReduceBatch = 8;                    // pieces loaded together

enum Act { kNone = 0, kRelu = 1, kSigmoid = 2, kTanh = 3, kSoftrelu = 4 };

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

// bias, activation, and the int8 requantize or the rounding to TO
template <typename TO>
__device__ __forceinline__ void finish(TO* dst, float v, const float* bias,
                                       int n, int act, float inv_scale) {
  if (bias != nullptr) v += bias[n];
  v = activate(v, act);
  if constexpr (std::is_same<TO, int8_t>::value) {
    // Multiply by the reciprocal and round half to even, as the
    // reference's jnp.round(y / out_scale) computes after XLA's rewrite.
    const float q = fminf(fmaxf(rintf(v * inv_scale), -127.f), 127.f);
    *dst = static_cast<int8_t>(q);
  } else {
    *dst = from_f32<TO>(v);
  }
}

template <typename TX, typename TW, typename TO, int kRowsPerWarp>
__global__ void __launch_bounds__(kWarps * 32)
fc_epilogue_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   const float* __restrict__ bias, TO* __restrict__ out,
                   int M, int N, int K, int act, float inv_scale,
                   bool vec_x, bool vec_w) {
  constexpr int kTileN = kWarps * kRowsPerWarp;    // output columns per block
  constexpr int kOuts = kTileM * kRowsPerWarp;     // outputs per warp
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

  // Lane l finishes outputs l, l + 32, ... of the warp: output o is
  // (m0 + o / kRowsPerWarp, n0 + o % kRowsPerWarp).  The select loop keeps
  // acc in registers (a dynamic index would spill it).
#pragma unroll
  for (int base = 0; base < kOuts; base += 32) {
    const int o = base + lane;
    if (o >= kOuts) break;
    const int my_r = o / kRowsPerWarp;
    const int my_j = o % kRowsPerWarp;
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < kTileM; ++r)
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j)
        if (r == my_r && j == my_j) v = acc[r][j];
    const int n = n0 + my_j;
    if (my_r >= rows || n >= N) continue;
    finish(out + (size_t)(m0 + my_r) * N + n, v, bias, n, act, inv_scale);
  }
}

// ---------------------------------------------------------------------------
// the tensor-core instance

// The shape's stream-K geometry: T units of (x block, column tile, chunk),
// tile-major, chunks fastest.
struct TcShape {
  long long nt, kc, total;
};

__host__ __device__ __forceinline__ TcShape tc_shape(int M, int N, int K) {
  TcShape s;
  s.nt = (N + kTcRows - 1) / kTcRows;
  s.kc = (K + kTcChunk - 1) / kTcChunk;
  s.total = (long long)((M + kTcCols - 1) / kTcCols) * s.nt * s.kc;
  return s;
}

// the first unit of warp i: floor(i T / warps)
__device__ __forceinline__ long long tc_begin(long long i, long long total,
                                              int warps) {
  return i * total / warps;
}

// the warp whose units hold unit f: the last i with tc_begin(i) <= f
__device__ __forceinline__ int tc_owner(long long f, long long total,
                                        int warps) {
  return (int)(((f + 1) * warps - 1) / total);
}

// The launch plan, a function of (M, N, K) alone: `warps` share the T > 0
// units; a tile's slot holds `pieces`, the most warps one tile's kc units
// meet (every warp takes at least T / warps units).
struct TcPlan {
  TcShape s;
  int warps;
  long long pieces;
};

TcPlan tc_plan(int M, int N, int K) {
  TcPlan p;
  p.s = tc_shape(M, N, K);
  p.warps = (int)(p.s.total < kTcWarps ? p.s.total : kTcWarps);
  const long long seg = p.s.total / p.warps;
  p.pieces = (p.s.kc - 1 + seg - 1) / seg + 1;
  return p;
}

// the workspace's bytes: each tile's slot of pieces
size_t tc_workspace_bytes(const TcPlan& p) {
  return (size_t)(p.s.total / p.s.kc) * p.pieces * kPieceFloats *
         sizeof(float);
}

// One warp's units: for each tile they touch, kTcUnroll chunks' W and x
// loads in flight, then their m16n8k16 products; the tile's float32 sum
// goes to the tile's piece gw - (the tile's first warp), lane by lane as
// the fragment lies (c0..c3 of mma_16: columns n g, g + 8 by x rows 2t,
// 2t + 1).
template <typename E>
__global__ void __launch_bounds__(kTcWarpsPerSM * 32, 1)
fc_tc_kernel(const E* __restrict__ x, const E* __restrict__ w,
             float* __restrict__ part, int M, int N, int K, int warps,
             int pieces) {
  // the reduction kernel may launch now and wait at griddepcontrol.wait
  // for this grid's end, so no launch gap lies between the two
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int gw = blockIdx.x * kTcWarpsPerSM + (threadIdx.x >> 5);
  if (gw >= warps) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const TcShape s = tc_shape(M, N, K);
  long long f = tc_begin(gw, s.total, warps);
  const long long hi = tc_begin(gw + 1, s.total, warps);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  while (f < hi) {
    const long long tile = f / s.kc;
    const int ch0 = (int)(f - tile * s.kc);
    const int ch1 = (int)min(s.kc, hi - tile * s.kc);
    const int n_a = (int)(tile % s.nt) * kTcRows + g, n_b = n_a + 8;
    const int m = (int)(tile / s.nt) * kTcCols + g;
    const bool va = n_a < N, vb = n_b < N, vx = m < M;
    const E* wa = w + (size_t)(va ? n_a : 0) * K + 8 * t;
    const E* wb = w + (size_t)(vb ? n_b : 0) * K + 8 * t;
    const E* xr = x + (size_t)(vx ? m : 0) * K + 8 * t;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ch = ch0; ch < ch1; ch += kTcUnroll) {
      uint4 ra[kTcUnroll], rb[kTcUnroll], rx[kTcUnroll];
#pragma unroll
      for (int i = 0; i < kTcUnroll; ++i) {
        // K % 8 == 0: a lane's 8 elements lie all before K or all past it
        const int off = (ch + i) * kTcChunk;
        const bool in = ch + i < ch1 && off + 8 * t < K;
        ra[i] = in && va ? __ldcs(reinterpret_cast<const uint4*>(wa + off))
                         : zero;
        rb[i] = in && vb ? __ldcs(reinterpret_cast<const uint4*>(wb + off))
                         : zero;
        rx[i] = in && vx ? __ldg(reinterpret_cast<const uint4*>(xr + off))
                         : zero;
      }
#pragma unroll
      for (int i = 0; i < kTcUnroll; ++i) {
        if (ch + i >= ch1) break;                  // uniform over the warp
        const uint32_t lo[4] = {ra[i].x, rb[i].x, ra[i].y, rb[i].y};
        mxtt::mma_16<E>(acc, lo, rx[i].x, rx[i].y);
        const uint32_t hi4[4] = {ra[i].z, rb[i].z, ra[i].w, rb[i].w};
        mxtt::mma_16<E>(acc, hi4, rx[i].z, rx[i].w);
      }
    }
    const int first = tc_owner(tile * s.kc, s.total, warps);
    float4* dst = reinterpret_cast<float4*>(part) +
                  ((size_t)tile * pieces + (gw - first)) *
                      (kPieceFloats / 4) + lane;
    *dst = make_float4(acc[0], acc[1], acc[2], acc[3]);
    f = tile * s.kc + ch1;
  }
}

// One thread an output (m, n): the pieces of its tile in warp order
// (kReduceBatch loads in flight, then their sum in that order), then bias,
// activation and the store.  Launched as fc_tc_kernel's programmatic
// dependent: it waits for that grid's end and memory before reading.
template <typename TO>
__global__ void __launch_bounds__(kReduceThreads)
fc_tc_reduce_kernel(const float* __restrict__ part,
                    const float* __restrict__ bias, TO* __restrict__ out,
                    int M, int N, int K, int warps, int pieces, int act,
                    float inv_scale) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long i = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= (long long)M * N) return;
  const int m = (int)(i / N), n = (int)(i % N);
  const TcShape s = tc_shape(M, N, K);
  // where (n, m) lies in a piece: lane (g, t), element e of c0..c3
  const int r = n % kTcRows, c = m % kTcCols;
  const int at = ((r % 8) * 4 + c / 2) * 4 + (r / 8) * 2 + (c % 2);
  const long long tile = (long long)(m / kTcCols) * s.nt + n / kTcRows;
  const int count = tc_owner((tile + 1) * s.kc - 1, s.total, warps) -
                    tc_owner(tile * s.kc, s.total, warps) + 1;
  const float* tp = part + (size_t)tile * pieces * kPieceFloats + at;
  float v = 0.f;
  for (int k0 = 0; k0 < count; k0 += kReduceBatch) {
    float p[kReduceBatch];
#pragma unroll
    for (int j = 0; j < kReduceBatch; ++j)
      p[j] = k0 + j < count ? tp[(k0 + j) * kPieceFloats] : 0.f;
#pragma unroll
    for (int j = 0; j < kReduceBatch; ++j)
      if (k0 + j < count) v += p[j];
  }
  finish(out + i, v, bias, n, act, inv_scale);
}

template <typename E, typename TO>
cudaError_t launch_tc(const void* x, const void* w, const float* bias,
                      void* out, int M, int N, int K, int act,
                      float inv_scale, void* workspace, cudaStream_t stream) {
  if (workspace == nullptr) return cudaErrorInvalidValue;
  const TcPlan p = tc_plan(M, N, K);
  const int warps = p.warps, pieces = (int)p.pieces;
  float* part = static_cast<float*>(workspace);
  fc_tc_kernel<E><<<(warps + kTcWarpsPerSM - 1) / kTcWarpsPerSM,
                    kTcWarpsPerSM * 32, 0, stream>>>(
      static_cast<const E*>(x), static_cast<const E*>(w), part, M, N, K,
      warps, pieces);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long outs = (long long)M * N;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((outs + kReduceThreads - 1) /
                                kReduceThreads));
  cfg.blockDim = dim3(kReduceThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fc_tc_reduce_kernel<TO>, (const float*)part,
                            bias, static_cast<TO*>(out), M, N, K, warps,
                            pieces, act, inv_scale);
}

// ---------------------------------------------------------------------------
// launchers

template <typename T>
bool aligned4(const void* p, int K) {
  return K % kVec == 0 &&
         reinterpret_cast<uintptr_t>(p) % (kVec * sizeof(T)) == 0;
}

template <typename TX, typename TW, typename TO, int kRowsPerWarp>
cudaError_t launch(const void* x, const void* w, const float* bias, void* out,
                   int M, int N, int K, int act, float inv_scale,
                   cudaStream_t stream) {
  constexpr int kTileN = kWarps * kRowsPerWarp;
  const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
  fc_epilogue_kernel<TX, TW, TO, kRowsPerWarp>
      <<<grid, kWarps * 32, 0, stream>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(w), bias,
          static_cast<TO*>(out), M, N, K, act, inv_scale, aligned4<TX>(x, K),
          aligned4<TW>(w, K));
  return cudaGetLastError();
}

// block_n selects the SIMT instance: 8, 16 or 32 columns for float32 x and
// W, 16 (the default) for every other dtype pair.
template <typename TX, typename TW, typename TO>
cudaError_t launch_tile(int block_n, const void* x, const void* w,
                        const float* bias, void* out, int M, int N, int K,
                        int act, float inv_scale, cudaStream_t stream) {
  if (block_n == kWarps * kDefaultRows)
    return launch<TX, TW, TO, kDefaultRows>(x, w, bias, out, M, N, K, act,
                                            inv_scale, stream);
  if constexpr (std::is_same<TX, float>::value &&
                std::is_same<TW, float>::value) {
    if (block_n == kWarps * 2)
      return launch<TX, TW, TO, 2>(x, w, bias, out, M, N, K, act, inv_scale,
                                   stream);
    if (block_n == kWarps * 8)
      return launch<TX, TW, TO, 8>(x, w, bias, out, M, N, K, act, inv_scale,
                                   stream);
  }
  return cudaErrorInvalidValue;
}

// The tensor-core route's rule: x and W both float16 or both bfloat16, K
// > 0, K % 8 == 0 and both 16-byte aligned, so that every row's 8-element
// groups are 16-byte loads.  Every other call runs a SIMT instance.
bool tc_route(const void* x, const void* w, int K, int x_dtype,
              int w_dtype) {
  return x_dtype == w_dtype && x_dtype != 0 && K > 0 && K % 8 == 0 &&
         mxtt::aligned(x, 16) && mxtt::aligned(w, 16);
}

template <typename TX, typename TW>
cudaError_t launch_out(int block_n, const void* x, const void* w,
                       const float* bias, void* out, int M, int N, int K,
                       int act, int quantize, float inv_scale, bool tc,
                       void* workspace, cudaStream_t stream) {
  if constexpr (std::is_same<TX, TW>::value &&
                !std::is_same<TX, float>::value) {
    if (tc) {
      if (block_n != kWarps * kDefaultRows) return cudaErrorInvalidValue;
      return quantize ? launch_tc<TX, int8_t>(x, w, bias, out, M, N, K, act,
                                              inv_scale, workspace, stream)
                      : launch_tc<TX, TX>(x, w, bias, out, M, N, K, act,
                                          inv_scale, workspace, stream);
    }
  }
  if (quantize)
    return launch_tile<TX, TW, int8_t>(block_n, x, w, bias, out, M, N, K, act,
                                       inv_scale, stream);
  return launch_tile<TX, TW, TX>(block_n, x, w, bias, out, M, N, K, act,
                                 inv_scale, stream);
}

template <typename TX>
cudaError_t launch_w(int w_dtype, int block_n, const void* x, const void* w,
                     const float* bias, void* out, int M, int N, int K,
                     int act, int quantize, float inv_scale, bool tc,
                     void* workspace, cudaStream_t stream) {
  switch (w_dtype) {
    case 0: return launch_out<TX, float>(block_n, x, w, bias, out, M, N, K,
                                         act, quantize, inv_scale, tc,
                                         workspace, stream);
    case 1: return launch_out<TX, __half>(block_n, x, w, bias, out, M, N, K,
                                          act, quantize, inv_scale, tc,
                                          workspace, stream);
    case 2: return launch_out<TX, __nv_bfloat16>(
        block_n, x, w, bias, out, M, N, K, act, quantize, inv_scale, tc,
        workspace, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The bytes of float32 scratch mxtt_fc_epilogue needs for these operands
// (dtype codes as below): the tensor-core route's pieces, 0 on a SIMT route
// (tc_route) or an empty output.
extern "C" long long mxtt_fc_workspace_bytes(const void* x, const void* w,
                                             int M, int N, int K,
                                             int x_dtype, int w_dtype) {
  if (M <= 0 || N <= 0 || !tc_route(x, w, K, x_dtype, w_dtype)) return 0;
  return (long long)tc_workspace_bytes(tc_plan(M, N, K));
}

// dtype codes: 0 float32, 1 float16, 2 bfloat16.  act codes as in Act.
// The output is in x's dtype, or int8 when quantize is nonzero.  block_n:
// output columns per block of a SIMT instance (8, 16 or 32 for float32 x
// and W; 16 otherwise, which the tensor-core route takes too).
// workspace: mxtt_fc_workspace_bytes of scratch on the tensor-core route,
// ignored on the SIMT route.  Returns a cudaError_t: the launch's
// configuration error, if any (cudaErrorInvalidValue for a tile with no
// instance, or no workspace where one is needed).  Faults during the run
// surface at the caller's next synchronisation.
extern "C" int mxtt_fc_epilogue(const void* x, const void* w, const void* bias,
                                void* out, int M, int N, int K, int x_dtype,
                                int w_dtype, int act, int quantize,
                                float inv_scale, int block_n, void* workspace,
                                int device, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || act < kNone || act > kSoftrelu)
    return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return err;
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tc = tc_route(x, w, K, x_dtype, w_dtype);
  switch (x_dtype) {
    case 0: return launch_w<float>(w_dtype, block_n, x, w, b, out, M, N, K,
                                   act, quantize, inv_scale, tc, workspace,
                                   s);
    case 1: return launch_w<__half>(w_dtype, block_n, x, w, b, out, M, N, K,
                                    act, quantize, inv_scale, tc, workspace,
                                    s);
    case 2: return launch_w<__nv_bfloat16>(w_dtype, block_n, x, w, b, out, M,
                                           N, K, act, quantize, inv_scale, tc,
                                           workspace, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
