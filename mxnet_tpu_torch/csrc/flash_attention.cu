// Blockwise attention with an online softmax:
//
//     out[b, i, h] = softmax(q[b, i, h] · K[b, :, h]ᵀ / √D) · V[b, :, h]
//
// for q, k, v, out in the (B, T, H, D) layout, float32.  With `causal`, row i
// sees keys 0 .. i.  Softmax and sums are float32 with l clamped at 1e-20,
// as _flash_kernel computes them.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py:73 (_flash_kernel,
// launched by flash_attention at line 121).  There the grid ran (batch·head,
// q tile) in order, each step holding one head's whole K and V in VMEM and
// walking them with a fori_loop; the wrapper transposed q, k, v to
// (B·H, T, D) and padded T up to the tile grid.  Here nothing is copied: the
// kernel reads q, k and v in place with the token stride H·D, masks the
// ragged end of T itself, and one thread block owns one (b, h, q tile) and
// walks its key tiles in a loop.
//
// What bounds it.  A (row, visible key) pair costs 4·D flops (q·k and p·v)
// against 2·D floats of K and V that every row of a tile shares, so at the
// kernel-search shape (B 4, T 1024, H 12, D 64, causal) the work is 6.4
// GFLOP over 50 MB: bound by float32 arithmetic (no tensor cores here), near
// 0.1 ms on an H100 SXM at 67 TFLOP/s.
//
// Design.  A block is 4 warps and owns kBQ query rows: warp w owns rows
// w·kBQ/4 ..  The q tile sits in shared memory.  For each key tile of kBK
// keys (only tiles up to the block's last row when causal, so no tile is
// wholly masked) the block stages K (row stride padded odd, so lanes reading
// different keys hit different banks) and V in shared memory, zero past T.
// Lane j scores keys j, j+32, .. against all the warp's rows at once (each K
// element read once for all rows, q read as float4 broadcasts); the warp
// reduces each row's max and sum with butterfly shuffles and updates its
// float32 m/l/acc as _flash_kernel does (pallas_kernels.py:84-108), writing
// the row's p to its own shared-memory slab; lane t then accumulates head
// dims t, t+32, .. of p · V, p read as float4 broadcasts.  Causal q tiles
// carry unequal work, so the heaviest (last) tiles are launched first.  Every
// sum runs in an order fixed by the tile, with no atomics, so a call is
// bitwise repeatable.  Tensor cores (wgmma), TMA and a pipelined K/V ring are
// left to later work.
//
// Compiled tile instances (kBQ, kBK): kBQ in {16, 32, 64}, kBK in {32, 64,
// 128}, each for D <= 32, <= 64 and <= 128.  The largest, (64, 128) at
// D = 128, holds 197 KB of shared memory (q 32 KB, K 66 KB, V 64 KB, p 32 KB)
// of the 227 KB a block may opt into, and its 16 rows per warp keep
// 16 x 4 scores and 16 x 4 accumulators per lane in registers, within the
// 255 a thread may hold.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                        // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 128;                       // head dim limit
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Shared-memory geometry for head dim D: rows padded to a multiple of 4
// floats (float4 reads of q and V), K rows one float longer (odd stride).
struct Geometry {
  int qstride, kstride, vstride;                 // in floats
  __host__ __device__ explicit Geometry(int D) {
    qstride = (D + 3) / 4 * 4;
    kstride = qstride + 1;
    vstride = qstride;
  }
  __host__ __device__ int kfloats(int bk) const {
    return (bk * kstride + 3) / 4 * 4;           // keeps V 16-byte aligned
  }
  __host__ __device__ size_t floats(int bq, int bk) const {
    return (size_t)bq * qstride + kfloats(bk) + (size_t)bk * vstride +
           (size_t)bq * bk;
  }
};

// Copy `rows` tokens of one head (D floats each, token stride `tok`) from
// src, starting at token t_first, into dst rows of `stride` floats; tokens
// at or past T and the padding dims are written as 0.
__device__ __forceinline__ void stage(float* dst, int stride,
                                      const float* __restrict__ src,
                                      int t_first, int rows, int T,
                                      size_t tok, int D, int qstride,
                                      bool vec) {
  if (vec) {                                     // D % 4 == 0, aligned rows
    const int d4n = D / 4;
    for (int i = threadIdx.x; i < rows * d4n; i += kThreads) {
      const int r = i / d4n, d = (i % d4n) * 4;
      const int t = t_first + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < T)
        x = __ldg(reinterpret_cast<const float4*>(src + (size_t)t * tok + d));
      float* o = dst + r * stride + d;
      if (stride % 4 == 0) {
        *reinterpret_cast<float4*>(o) = x;
      } else {
        o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * qstride; i += kThreads) {
      const int r = i / qstride, d = i % qstride;
      const int t = t_first + r;
      dst[r * stride + d] =
          t < T && d < D ? __ldg(src + (size_t)t * tok + d) : 0.f;
    }
  }
}

// kBQ query rows and kBK keys per tile; kDpl head dims per lane.
template <int kBQ, int kBK, int kDpl>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int BH, int T, int H, int D, int causal, float scale,
                       int n_qtiles, bool vec) {
  constexpr int kR = kBQ / kWarps;               // query rows per warp
  constexpr int kKpl = kBK / 32;                 // keys per lane
  extern __shared__ __align__(16) float smem[];

  const Geometry g(D);
  float* qs = smem;
  float* ks = qs + kBQ * g.qstride;
  float* vs = ks + g.kfloats(kBK);
  float* ps = vs + kBK * g.vstride;

  const int bh = blockIdx.x % BH;
  const int qt = n_qtiles - 1 - blockIdx.x / BH;  // heaviest tiles first
  const int b = bh / H, h = bh % H;
  const int t0 = qt * kBQ;
  const size_t tok = (size_t)H * D;              // token stride
  const size_t head = ((size_t)b * T * H + h) * D;  // (b, 0, h, 0)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * kR;

  stage(qs, g.qstride, q + head, t0, kBQ, T, tok, D, g.qstride, vec);

  float m[kR], l[kR], acc[kR][kDpl];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < kDpl; ++t) acc[r][t] = 0.f;
  }

  // Keys any row of this tile can see: all of T, or up to its last row.
  const int k_limit = causal ? min(t0 + kBQ, T) : T;
  const int n_ktiles = (k_limit + kBK - 1) / kBK;
  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                             // K/V of the last tile read
    stage(ks, g.kstride, k + head, k0, kBK, T, tok, D, g.qstride, vec);
    stage(vs, g.vstride, v + head, k0, kBK, T, tok, D, g.qstride, vec);
    __syncthreads();

    // scores: lane j against every row of the warp
    float sc[kR][kKpl];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int j = 0; j < kKpl; ++j) sc[r][j] = 0.f;
    for (int d = 0; d < g.qstride; d += 4) {
      float kv[kKpl][4];
#pragma unroll
      for (int j = 0; j < kKpl; ++j) {
        const float* kr = ks + (lane + 32 * j) * g.kstride + d;
        kv[j][0] = kr[0]; kv[j][1] = kr[1]; kv[j][2] = kr[2]; kv[j][3] = kr[3];
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + (r0 + r) * g.qstride + d);
#pragma unroll
        for (int j = 0; j < kKpl; ++j) {
          float a = sc[r][j];
          a = fmaf(qv.x, kv[j][0], a);
          a = fmaf(qv.y, kv[j][1], a);
          a = fmaf(qv.z, kv[j][2], a);
          a = fmaf(qv.w, kv[j][3], a);
          sc[r][j] = a;
        }
      }
    }

    // online softmax update; p goes to the warp's rows of the p slab
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int row = t0 + r0 + r;
      float bmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKpl; ++j) {
        const int key = k0 + lane + 32 * j;
        const bool seen = key < T && (!causal || key <= row);
        sc[r][j] = seen ? sc[r][j] * scale : -INFINITY;
        bmax = fmaxf(bmax, sc[r][j]);
      }
      const float new_m = fmaxf(m[r], warp_max(bmax));
      const float safe_m = isinf(new_m) ? 0.f : new_m;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kKpl; ++j) {
        const float p = isinf(sc[r][j]) ? 0.f : expf(sc[r][j] - safe_m);
        ps[(r0 + r) * kBK + lane + 32 * j] = p;
        psum += p;
      }
      const float corr = isinf(m[r]) ? 0.f : expf(m[r] - safe_m);
      l[r] = l[r] * corr + warp_sum(psum);
      m[r] = new_m;
#pragma unroll
      for (int t = 0; t < kDpl; ++t) acc[r][t] *= corr;
    }
    __syncwarp();

    // p · V over the tile's keys inside T (V rows past T are 0, so are p)
    const int kn = min(kBK, T - k0);
    for (int j = 0; j < kn; j += 4) {
      float vv[4][kDpl];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int t = 0; t < kDpl; ++t) {
          const int d = lane + 32 * t;
          vv[i][t] = d < D ? vs[(j + i) * g.vstride + d] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(ps + (r0 + r) * kBK + j);
#pragma unroll
        for (int t = 0; t < kDpl; ++t) {
          float a = acc[r][t];
          a = fmaf(p4.x, vv[0][t], a);
          a = fmaf(p4.y, vv[1][t], a);
          a = fmaf(p4.z, vv[2][t], a);
          a = fmaf(p4.w, vv[3][t], a);
          acc[r][t] = a;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int row = t0 + r0 + r;
    if (row < T) {
      const float li = fmaxf(l[r], 1e-20f);
      float* dst = out + head + (size_t)row * tok;
#pragma unroll
      for (int t = 0; t < kDpl; ++t) {
        const int d = lane + 32 * t;
        if (d < D) dst[d] = acc[r][t] / li;
      }
    }
  }
}

template <int kBQ, int kBK, int kDpl>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   int B, int T, int H, int D, int causal, float scale,
                   bool vec, int device, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<kBQ, kBK, kDpl>;
  const size_t bytes = sizeof(float) * Geometry(D).floats(kBQ, kBK);
  // the largest dynamic shared memory opted into so far, per device
  static int opted[kMaxDevices];
  if (bytes > 48 * 1024 && (int)bytes > opted[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    opted[device] = (int)bytes;
  }
  const int n_qtiles = (T + kBQ - 1) / kBQ;
  const long long blocks = (long long)B * H * n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, bytes, stream>>>(
      q, k, v, out, B * H, T, H, D, causal, scale, n_qtiles, vec);
  return cudaGetLastError();
}

template <int kBQ, int kBK>
cudaError_t launch_tile(const float* q, const float* k, const float* v,
                        float* out, int B, int T, int H, int D, int causal,
                        float scale, bool vec, int device,
                        cudaStream_t stream) {
  if (D <= 32)
    return launch<kBQ, kBK, 1>(q, k, v, out, B, T, H, D, causal, scale, vec,
                               device, stream);
  if (D <= 64)
    return launch<kBQ, kBK, 2>(q, k, v, out, B, T, H, D, causal, scale, vec,
                               device, stream);
  return launch<kBQ, kBK, 4>(q, k, v, out, B, T, H, D, causal, scale, vec,
                             device, stream);
}

}  // namespace

// q, k, v, out (B, T, H, D): float32, contiguous.  (block_q, block_k) must
// be one of the compiled instances below.  Returns a cudaError_t: the
// launch's configuration error, if any.  Faults during the run surface at
// the caller's next synchronisation.
extern "C" int mxtt_flash_attention(const void* q, const void* k,
                                    const void* v, void* out, int B, int T,
                                    int H, int D, int causal, float scale,
                                    int block_q, int block_k, int device,
                                    void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || D <= 0 || D > kMaxD ||
      (long long)B * H > 0x7fffffffLL || device < 0 || device >= kMaxDevices)
    return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return err;
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_TILE(BQ, BK)                                                  \
  if (block_q == BQ && block_k == BK)                                       \
    return launch_tile<BQ, BK>(qf, kf, vf, o, B, T, H, D, causal, scale,    \
                               vec, device, st);
  FLASH_TILE(16, 32)
  FLASH_TILE(16, 64)
  FLASH_TILE(16, 128)
  FLASH_TILE(32, 32)
  FLASH_TILE(32, 64)
  FLASH_TILE(32, 128)
  FLASH_TILE(64, 32)
  FLASH_TILE(64, 64)
  FLASH_TILE(64, 128)
#undef FLASH_TILE
  return cudaErrorInvalidValue;
}

extern "C" const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
