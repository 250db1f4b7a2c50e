// Blockwise attention with an online softmax:
//
//     out[b, i, h] = softmax(q[b, i, h] · K[b, :, h]ᵀ / √D) · V[b, :, h]
//
// for q, k, v, out in the (B, T, H, D) layout, all float32, all float16 or
// all bfloat16.  With `causal`, row i sees keys 0 .. i.  Softmax and sums
// are float32 with l clamped at 1e-20, as _flash_kernel computes them on
// operands upcast at the load; out is rounded once to the operands' type
// (elem.cuh).
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
// GFLOP over 50 MB: bound by arithmetic.  Both products run on the tensor
// cores in 3xTF32 (three TF32 products per float32 product, see
// attention.cuh), so the floor is 3 x 6.4 GFLOP at the 495 TFLOP/s dense
// TF32 peak, near 0.04 ms on an H100 SXM.  One-pass TF32 would keep about
// three decimal digits and miss the 2e-5 tolerance the JAX package holds
// this kernel to.  With 16-bit operands q·k is one 16-bit product and p·v
// two, 1.5 x 6.4 GFLOP at the 989 TFLOP/s dense float16/bfloat16 peak,
// near 0.01 ms.
//
// Design (FlashAttention-2 on mma.sync), float32.  A block is kBQ / 16
// warps; warp w owns query rows w·16 .. w·16+15 of the tile and keeps them
// in registers as m16n8k8 A fragments, split once into TF32 parts.  Key tiles of kBK
// keys pass through a ring of kStages shared-memory stages filled by
// cp.async (16-byte copies when D % 4 == 0 and the tensors are aligned,
// zeros past T), so tile j+1 lands while tile j is multiplied.  Once tile
// j has landed (a barrier that also frees the stage tile j+1 is copied
// into), the block splits it for all warps, TF32 high parts in place and
// remainders in a buffer beside the ring, and a second barrier publishes
// them: each warp would otherwise split every element it reads.  K and V
// rows are padded to kD + 4 floats, so the (g, t) fragment reads of Kᵀ
// (row g, column t) and of V (row 2t, column g) hit 32 different banks.
// Each warp's step over a tile is attention.cuh's attention_tile, which the
// paged kernel shares.  S = Q·Kᵀ accumulates in registers; the softmax runs
// on the accumulator fragments, where a row lies in the 4 lanes of a quad
// (2 shuffles for its max; the row sum stays per lane until the end).
// P goes from the accumulator layout to the A layout of P·V without moving: the 8 keys of
// an n-tile are taken in the order 0, 2, 4, 6, 1, 3, 5, 7, and V's rows
// are read in the same order.  Causal q tiles carry unequal work, so the
// heaviest (last) tiles are launched first; each warp stops at its last
// visible key (the masked slices of its last tile are multiplied all the
// same: branching around them costs more than it saves).  Every sum runs
// in an order fixed by the tile, with no atomics, so a call is bitwise
// repeatable.
//
// The 16-bit instances (q, k, v float16 or bfloat16) are FlashAttention-2
// on 16-bit mma.sync.  K and V tiles pass through a ring of kHalfStages
// stages that hold the operands' own type, half a float32 stage's bytes
// (the room buys the third stage), filled by cp.async 16-byte copies of 8
// elements (zeros past T) when D % 8 == 0 and K and V are 16-byte
// aligned, else through registers one element at a time.  Rows are padded
// to kD + 8 elements, an odd number of 16-byte units, so ldmatrix's eight
// row reads of a matrix hit distinct banks.  Nothing is split: q lies in
// registers as m16n8k16 A fragments taken straight from its 16-bit
// values, K fragments come through ldmatrix and V's through
// ldmatrix.trans, and each warp's step is attention.cuh's
// attention_tile_16: S = Q·Kᵀ in one 16-bit product with float32
// accumulation (exact products, so float32's q·k up to the order of the
// sums), the same online softmax, and P·V in two 16-bit products, p split
// into rn(p) and rn(p - rn(p)) in v's type (22 bits of p in float16, 16
// in bfloat16, both far below the output's own rounding).  One barrier a
// tile.  The output is rounded once, so a 16-bit instance lies within one
// unit in the last place of the float32 instance's output on the upcast
// inputs, rounded.
//
// Compiled tile instances (kBQ, kBK): kBQ in {64, 128}, kBK in {32, 64},
// each for D <= 32, <= 64 and <= 128 and each element type.  The largest
// float32 one, kBK 64 at D 128, holds a two-stage ring and the
// remainders, 3 x 2 x 64 x 132 floats = 198 KB of the 227 KB a block may
// use; the largest 16-bit one three stages, 3 x 2 x 64 x 136 x 2 bytes =
// 102 KB.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention.cuh"
#include "elem.cuh"

namespace {

using mxtt::cp_async16;
using mxtt::cp_async4;
using mxtt::cp_async_commit;
using mxtt::cp_async_wait;
using mxtt::split_tf32;
using mxtt::to_f32;

constexpr int kStages = 2;                       // K/V ring depth, float32
constexpr int kHalfStages = 3;                   // K/V ring depth, 16-bit
constexpr int kMaxD = 128;                       // head dim limit
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// Blocks per SM the register budget must allow (the compiler caps each
// thread's registers to fit them): three 4-warp blocks at D <= 64; at
// D = 128, whose q fragments and accumulators alone take 192 registers,
// and for 8-warp blocks, whatever the registers allow.
__host__ __device__ constexpr int min_blocks(int bq, int d) {
  return bq > 64 || d > 64 ? 1 : 3;
}

// Shared memory of the instance: float32, a ring of kStages K/V stages
// and one stage of TF32 remainders, rows of kD + 4 floats; 16-bit, a ring
// of kHalfStages stages of E, rows of kD + 8 elements.
template <typename E, int kBK, int kD>
__host__ __device__ constexpr int smem_bytes() {
  return mxtt::is_f32<E>()
             ? (int)sizeof(float) * (kStages + 1) * 2 * kBK * (kD + 4)
             : (int)sizeof(E) * kHalfStages * 2 * kBK * (kD + 8);
}

// kBQ query rows (16 per warp) and kBK keys per tile; head dims padded to kD;
// operands and out of type E.
template <typename E, int kBQ, int kBK, int kD>
__global__ void __launch_bounds__(kBQ * 2, min_blocks(kBQ, kD))
flash_attention_kernel(const E* __restrict__ q, const E* __restrict__ k,
                       const E* __restrict__ v, E* __restrict__ out,
                       int BH, int T, int H, int D, int causal,
                       float scale_log2, int n_qtiles, bool vec) {
  constexpr bool kF32 = mxtt::is_f32<E>();
  constexpr int kThreads = kBQ * 2;
  constexpr int kRing = kF32 ? kStages : kHalfStages;
  // padded row, in elements: an odd number of 16-byte units (kD + 8 for
  // 16-bit rows, ldmatrix's rows) or kD + 4 floats (the fragment reads)
  constexpr int kStride = kF32 ? kD + 4 : kD + 8;
  constexpr int kTile = kBK * kStride;           // one K (or V) tile
  constexpr int kDSteps = kD / 8;                // 8-wide head-dim slices
  constexpr int kKSlices = kBK / 8;              // 8-key slices of a tile
  // [stage][K, V][kBK][kStride] of E; float32 only: raw, then TF32 high
  // parts in place, and after the ring [K, V][kBK][kStride] the TF32
  // remainders of the tile being multiplied
  extern __shared__ __align__(16) float smem[];
  E* const ring = reinterpret_cast<E*>(smem);
  float* const lo_k = smem + kStages * 2 * kTile;
  float* const lo_v = lo_k + kTile;

  const int bh = blockIdx.x % BH;
  const int qt = n_qtiles - 1 - blockIdx.x / BH;  // heaviest tiles first
  const int b = bh / H, h = bh % H;
  const int t0 = qt * kBQ;
  const size_t tok = (size_t)H * D;              // token stride
  const size_t head = ((size_t)b * T * H + h) * D;  // (b, 0, h, 0)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = t0 + warp * 16;                 // the warp's first row
  const int row_a = r0 + g, row_b = r0 + g + 8;  // this lane's two rows

  // Keys any row of this tile can see: all of T, or up to its last row.
  const int k_limit = causal ? min(t0 + kBQ, T) : T;
  const int n_ktiles = (k_limit + kBK - 1) / kBK;

  // Head dims D .. kD-1 are never copied: zero them once in every stage.
  if (D < kD)
    for (int i = threadIdx.x; i < kRing * 2 * kBK * (kD - D);
         i += kThreads) {
      const int r = i / (kD - D);
      ring[r * kStride + D + (i - r * (kD - D))] = mxtt::from_f32<E>(0.f);
    }

  // One key tile into its stage as one cp.async group (16-byte copies of
  // 4 floats or 8 16-bit elements; else 4-byte copies of a float, or a
  // 16-bit element through registers); zeros past T.
  auto load_tile = [&](int kt) {
    E* ks = ring + (kt % kRing) * 2 * kTile;
    E* vs = ks + kTile;
    const int k0 = kt * kBK;
    if (vec) {
      constexpr int kVec = 16 / (int)sizeof(E);  // elements a copy
      const int dn = D / kVec;
      for (int i = threadIdx.x; i < kBK * dn; i += kThreads) {
        const int r = i / dn, d = (i - r * dn) * kVec;
        const bool live = k0 + r < T;
        const size_t at = head + (size_t)(live ? k0 + r : 0) * tok + d;
        cp_async16(ks + r * kStride + d, k + at, live);
        cp_async16(vs + r * kStride + d, v + at, live);
      }
    } else {
      for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
        const int r = i / D, d = i - r * D;
        const bool live = k0 + r < T;
        const size_t at = head + (size_t)(live ? k0 + r : 0) * tok + d;
        if constexpr (kF32) {
          cp_async4(ks + r * kStride + d, k + at, live);
          cp_async4(vs + r * kStride + d, v + at, live);
        } else {
          const E zero = mxtt::from_f32<E>(0.f);
          ks[r * kStride + d] = live ? k[at] : zero;
          vs[r * kStride + d] = live ? v[at] : zero;
        }
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < kRing - 1; ++s) {
    if (s < n_ktiles)
      load_tile(s);
    else
      cp_async_commit();
  }

  // The warp's 16 query rows as A fragments, for the whole key walk:
  // float32, m16n8k8 fragments split once into TF32 high parts (qh) and
  // remainders (ql); 16-bit, m16n8k16 fragments of q's own values (qh[0 ..
  // kD/16)).
  uint32_t qh[kDSteps][4], ql[kF32 ? kDSteps : 1][4];
  const E* qa = q + head + (size_t)row_a * tok;
  const E* qb = q + head + (size_t)row_b * tok;
  if constexpr (kF32) {
#pragma unroll
    for (int ds = 0; ds < kDSteps; ++ds) {
      const int d0 = ds * 8 + tq, d1 = d0 + 4;
      split_tf32(row_a < T && d0 < D ? to_f32(qa[d0]) : 0.f, qh[ds][0],
                 ql[ds][0]);
      split_tf32(row_b < T && d0 < D ? to_f32(qb[d0]) : 0.f, qh[ds][1],
                 ql[ds][1]);
      split_tf32(row_a < T && d1 < D ? to_f32(qa[d1]) : 0.f, qh[ds][2],
                 ql[ds][2]);
      split_tf32(row_b < T && d1 < D ? to_f32(qb[d1]) : 0.f, qh[ds][3],
                 ql[ds][3]);
    }
  } else {
    const E zero = mxtt::from_f32<E>(0.f);
    auto pair = [&](const E* row, bool live, int d) {
      return mxtt::pack16(live && d < D ? row[d] : zero,
                          live && d + 1 < D ? row[d + 1] : zero);
    };
#pragma unroll
    for (int ds = 0; ds < kD / 16; ++ds) {
      const int d0 = ds * 16 + 2 * tq, d1 = d0 + 8;
      qh[ds][0] = pair(qa, row_a < T, d0);
      qh[ds][1] = pair(qb, row_b < T, d0);
      qh[ds][2] = pair(qa, row_a < T, d1);
      qh[ds][3] = pair(qb, row_b < T, d1);
    }
  }

  // o[n] holds output columns 8n + 2t, 8n + 2t + 1 of rows g and g + 8;
  // m in log2 units; l per lane until the end.
  float o[kDSteps][4];
#pragma unroll
  for (int n = 0; n < kDSteps; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int last_row = r0 + 15;

  for (int kt = 0; kt < n_ktiles; ++kt) {
    cp_async_wait<kRing - 2>();                  // tile kt has landed
    __syncthreads();                             // ... for every thread, and
    if (kt + kRing - 1 < n_ktiles)               // tile kt-1's stage is free
      load_tile(kt + kRing - 1);
    else
      cp_async_commit();
    const int k0 = kt * kBK;
    E* ks = ring + (kt % kRing) * 2 * kTile;
    E* vs = ks + kTile;

    if constexpr (kF32) {
      // Split the tile once for all warps: TF32 high parts in place, the
      // remainders beside them.
      for (int i = threadIdx.x; i < 2 * kBK * (kD / 4); i += kThreads) {
        const int r = i / (kD / 4), c = (i - r * (kD / 4)) * 4;
        float* x = ks + r * kStride + c;         // K rows, then V rows
        float* y = lo_k + r * kStride + c;
        float4 in = *reinterpret_cast<float4*>(x);
        uint32_t h4[4], l4[4];
        split_tf32(in.x, h4[0], l4[0]);
        split_tf32(in.y, h4[1], l4[1]);
        split_tf32(in.z, h4[2], l4[2]);
        split_tf32(in.w, h4[3], l4[3]);
        *reinterpret_cast<uint4*>(x) = make_uint4(h4[0], h4[1], h4[2], h4[3]);
        *reinterpret_cast<uint4*>(y) = make_uint4(l4[0], l4[1], l4[2], l4[3]);
      }
      __syncthreads();
    }
    if (causal && k0 > last_row) continue;       // every key after our rows
    auto seen = [&](int key, int r) {
      key += k0;
      return key < T && (!causal || key <= (r ? row_b : row_a));
    };
    // only tiles at T's end or across the causal diagonal mask keys
    const bool edge = k0 + kBK > T || (causal && k0 + kBK - 1 > r0);
    if constexpr (kF32) {
      const uint32_t* kh = reinterpret_cast<const uint32_t*>(ks);
      const uint32_t* kl = reinterpret_cast<const uint32_t*>(lo_k);
      const uint32_t* vh = reinterpret_cast<const uint32_t*>(vs);
      const uint32_t* vl = reinterpret_cast<const uint32_t*>(lo_v);
      // the tile's fragments, pre-split: Kᵀ (row g, column t), V (row 2t,
      // column g)
      auto k_frag = [&](int j, int ds, uint32_t& h0, uint32_t& h1,
                        uint32_t& l0, uint32_t& l1) {
        const int at = (8 * j + g) * kStride + 8 * ds + tq;
        h0 = kh[at]; h1 = kh[at + 4]; l0 = kl[at]; l1 = kl[at + 4];
      };
      auto v_frag = [&](int j, int n, uint32_t& h0, uint32_t& h1,
                        uint32_t& l0, uint32_t& l1) {
        const int at = (8 * j + 2 * tq) * kStride + g + 8 * n;
        h0 = vh[at]; h1 = vh[at + kStride]; l0 = vl[at];
        l1 = vl[at + kStride];
      };
      mxtt::attention_tile<kKSlices>(qh, ql, o, m, l, scale_log2, edge,
                                     k_frag, v_frag, seen);
    } else {
      mxtt::attention_tile_16<E, kKSlices, kD>(qh, o, m, l, scale_log2, edge,
                                               ks, vs, kStride, seen);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    l[r] = fmaxf(l[r], 1e-20f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row_b : row_a;
    if (row >= T) continue;
    E* dst = out + head + (size_t)row * tok;
#pragma unroll
    for (int n = 0; n < kDSteps; ++n) {
      const int d = 8 * n + 2 * tq;
      if (d < D) dst[d] = mxtt::from_f32<E>(o[n][2 * r] / l[r]);
      if (d + 1 < D)
        dst[d + 1] = mxtt::from_f32<E>(o[n][2 * r + 1] / l[r]);
    }
  }
}

template <typename E, int kBQ, int kBK, int kD>
cudaError_t launch(const E* q, const E* k, const E* v, E* out, int B,
                   int T, int H, int D, int causal, float scale, bool vec,
                   int device, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<E, kBQ, kBK, kD>;
  const size_t bytes = smem_bytes<E, kBK, kD>();
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
  kernel<<<(unsigned)blocks, kBQ * 2, bytes, stream>>>(
      q, k, v, out, B * H, T, H, D, causal, scale * kLog2e, n_qtiles, vec);
  return cudaGetLastError();
}

template <typename E, int kBQ, int kBK>
cudaError_t launch_tile(const E* q, const E* k, const E* v, E* out, int B,
                        int T, int H, int D, int causal, float scale,
                        bool vec, int device, cudaStream_t stream) {
  if (D <= 32)
    return launch<E, kBQ, kBK, 32>(q, k, v, out, B, T, H, D, causal, scale,
                                   vec, device, stream);
  if (D <= 64)
    return launch<E, kBQ, kBK, 64>(q, k, v, out, B, T, H, D, causal, scale,
                                   vec, device, stream);
  return launch<E, kBQ, kBK, 128>(q, k, v, out, B, T, H, D, causal, scale,
                                  vec, device, stream);
}

// The instance for element type E and tile (block_q, block_k).  Whole
// 16-byte copies of K and V need D a multiple of the elements in 16 bytes
// and both tensors 16-byte aligned.
template <typename E>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         void* out, int B, int T, int H, int D, int causal,
                         float scale, int block_q, int block_k, int device,
                         cudaStream_t st) {
  const bool vec = D % (16 / (int)sizeof(E)) == 0 && mxtt::aligned(k, 16) &&
                   mxtt::aligned(v, 16);
  const E* qt = static_cast<const E*>(q);
  const E* kt = static_cast<const E*>(k);
  const E* vt = static_cast<const E*>(v);
  E* o = static_cast<E*>(out);
#define FLASH_TILE(BQ, BK)                                                  \
  if (block_q == BQ && block_k == BK)                                       \
    return launch_tile<E, BQ, BK>(qt, kt, vt, o, B, T, H, D, causal,        \
                                  scale, vec, device, st);
  FLASH_TILE(64, 32)
  FLASH_TILE(64, 64)
  FLASH_TILE(128, 32)
  FLASH_TILE(128, 64)
#undef FLASH_TILE
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, out (B, T, H, D): contiguous, all of the type `dtype` names (0
// float32, 1 float16, 2 bfloat16).  (block_q, block_k) must be one of the
// compiled instances (launch_dtype).  Returns a cudaError_t: the launch's
// configuration error, if any.  Faults during the run surface at the
// caller's next synchronisation.
extern "C" int mxtt_flash_attention(const void* q, const void* k,
                                    const void* v, void* out, int B, int T,
                                    int H, int D, int causal, float scale,
                                    int block_q, int block_k, int dtype,
                                    int device, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || D <= 0 || D > kMaxD ||
      (long long)B * H > 0x7fffffffLL || device < 0 || device >= kMaxDevices)
    return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dtype<float>(q, k, v, out, B, T, H, D, causal,
                                       scale, block_q, block_k, device, st);
    case 1: return launch_dtype<__half>(q, k, v, out, B, T, H, D, causal,
                                        scale, block_q, block_k, device, st);
    case 2: return launch_dtype<__nv_bfloat16>(q, k, v, out, B, T, H, D,
                                               causal, scale, block_q,
                                               block_k, device, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
