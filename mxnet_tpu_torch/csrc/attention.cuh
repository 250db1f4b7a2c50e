// Asynchronous global -> shared copies (cp.async, sm_80 and later), the
// tensor-core products (3xTF32 over float32 operands; one m16n8k16 product
// over float16 or bfloat16 ones), and the FlashAttention-2 key-tile steps
// built on them, shared by the attention kernels: attention_tile for
// float32 q, attention_tile_16 for 16-bit q, K and V.  correlation.cu
// takes the copies, ldmatrix and mma_16 from here too, fc_epilogue.cu
// mma_16.
//
// A copy with `valid` false reads nothing and writes zeros (src-size 0), so
// rows past a sequence's end land as zeros without a branch around the
// copy.  Copies are grouped with cp_async_commit(); cp_async_wait<N>()
// returns once at most N of the calling thread's groups are still in
// flight, and a barrier then publishes the data to the other threads.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "elem.cuh"

namespace mxtt {

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// x = hi + lo with hi = x rounded to TF32 (nearest, ties away from zero)
// and lo the rest rounded to TF32: together they carry 22 of float32's 24
// mantissa bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// c += a · b for one 16x8x8 tile on the tensor cores, TF32 operands,
// float32 accumulate.  Fragments (g = lane / 4, t = lane % 4):
//   a0 (row g, k t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4);
//   b0 (k t, col g), b1 (t+4, g);
//   c0 (row g, col 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: c += a·b at float32 accuracy as hi·hi + hi·lo + lo·hi (the
// lo·lo term lies below float32's rounding), small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           uint32_t b_hi0, uint32_t b_hi1,
                                           uint32_t b_lo0, uint32_t b_lo1) {
  mma_tf32(c, a_lo, b_hi0, b_hi1);
  mma_tf32(c, a_hi, b_lo0, b_lo1);
  mma_tf32(c, a_hi, b_hi0, b_hi1);
}

// 16-bit fragments.  ldmatrix_x4 loads four 8x8 matrices of 16-bit
// elements from shared memory: lane l gives the address of row l % 8 of
// matrix l / 8 (8 elements, 16-byte aligned), and lane (g, t) receives
// elements (g, 2t) and (g, 2t+1) of each, or with .trans (2t, g) and
// (2t+1, g), in registers 0..3 by matrix.  ldmatrix_x2_trans loads two,
// from the addresses of lanes 0..15.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s));
}

// c += a · b for one 16x8x16 tile on the tensor cores, E (__half or
// __nv_bfloat16) operands, float32 accumulate; a product of two 16-bit
// values is exact in float32.  Fragments, two elements a register, the
// lower index in the low half:
//   a0 (row g, k 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8,
//   2t+8..); b0 (k 2t..2t+1, col g), b1 (k 2t+8.., g); c as mma_tf32's.
template <typename E>
__device__ __forceinline__ void mma_16(float (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<E, __half>::value)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits16(__half x) {
  return __half_as_ushort(x);
}
__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}

// (x0, x1) as E in one register, x0 in the low half
template <typename E>
__device__ __forceinline__ uint32_t pack16(E x0, E x1) {
  return bits16(x0) | bits16(x1) << 16;
}

// float32 x0, x1 as hi + lo, both in E: hi = rn(x), lo = rn(x - hi) (x -
// hi is exact in float32), 22 of x's bits in float16 and 16 in bfloat16
template <typename E>
__device__ __forceinline__ void split16(float x0, float x1, uint32_t& hi,
                                        uint32_t& lo) {
  const E h0 = from_f32<E>(x0), h1 = from_f32<E>(x1);
  hi = pack16(h0, h1);
  lo = pack16(from_f32<E>(x0 - to_f32(h0)), from_f32<E>(x1 - to_f32(h1)));
}

// The online softmax of one key tile on S's accumulator fragments
// (pallas_kernels.py:84-108), kSlices 8-key slices, slice j holding keys
// 8j + 2t and 8j + 2t + 1 of rows g and g + 8: scores and m in log2 units
// (scale_log2 = scale · log2 e), keys masked to -inf, the isinf guards for
// rows with no visible key yet; a row lies in the 4 lanes of a quad, so
// its max takes 2 shuffles, and its sum l stays per lane for the caller
// to add.  s becomes p in place and o is rescaled.  seen(key, r): whether
// row g + 8r sees the tile's key `key`; asked only when `masked`.
template <int kSlices, int kNTiles, class Seen>
__device__ __forceinline__ void online_softmax(
    float (&s)[kSlices][4], float (&o)[kNTiles][4], float (&m)[2],
    float (&l)[2], float scale_log2, bool masked, const Seen& seen) {
  const unsigned full = 0xffffffffu;
  const int t = threadIdx.x & 3;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kSlices; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * scale_log2;
      if (masked && !seen(8 * j + 2 * t + (e & 1), e >> 1)) x = -INFINITY;
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float safe[2], corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(full, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(full, mx[r], 2));
    const float new_m = fmaxf(m[r], mx[r]);
    safe[r] = isinf(new_m) ? 0.f : new_m;
    corr[r] = isinf(m[r]) ? 0.f : exp2f(m[r] - safe[r]);
    m[r] = new_m;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < kSlices; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = isinf(s[j][e]) ? 0.f : exp2f(s[j][e] - safe[e >> 1]);
      s[j][e] = p;
      l[e >> 1] += p;
    }
#pragma unroll
  for (int n = 0; n < kNTiles; ++n) {
    o[n][0] *= corr[0]; o[n][1] *= corr[0];
    o[n][2] *= corr[1]; o[n][3] *= corr[1];
  }
}

// One key tile of FlashAttention-2 on m16n8k8 fragments, for the 16 query
// rows a warp holds as A fragments split into TF32 parts (qh, ql), with
// g = lane / 4 and t = lane % 4:
//
// * S = Q·Kᵀ over kSlices 8-key slices in 3xTF32: slice j holds keys
//   8j + 2t and 8j + 2t + 1 of rows g and g + 8;
// * online_softmax on those accumulator fragments;
// * O += P·V in 3xTF32, the keys of each slice taken in the order 0, 2,
//   4, 6, 1, 3, 5, 7: the accumulator fragment is then P's A fragment as
//   it lies, and V's rows are read in the same order.
//
// The caller supplies the B fragments and the mask, each as a functor:
//   k_frag(j, ds, hi0, hi1, lo0, lo1): the TF32 parts of key 8j + g at
//     head dims 8ds + t and 8ds + t + 4;
//   v_frag(j, n, hi0, hi1, lo0, lo1): those of keys 8j + 2t and
//     8j + 2t + 1 at head dim 8n + g;
//   seen(key, r): as online_softmax's.
// Every sum runs in an order fixed by the fragments.
template <int kSlices, int kDSteps, class KFrag, class VFrag, class Seen>
__device__ __forceinline__ void attention_tile(
    const uint32_t (&qh)[kDSteps][4], const uint32_t (&ql)[kDSteps][4],
    float (&o)[kDSteps][4], float (&m)[2], float (&l)[2], float scale_log2,
    bool masked, const KFrag& k_frag, const VFrag& v_frag,
    const Seen& seen) {
  float s[kSlices][4];
#pragma unroll
  for (int j = 0; j < kSlices; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int ds = 0; ds < kDSteps; ++ds)
#pragma unroll
    for (int j = 0; j < kSlices; ++j) {
      uint32_t bh0, bh1, bl0, bl1;
      k_frag(j, ds, bh0, bh1, bl0, bl1);
      mma_3xtf32(s[j], qh[ds], ql[ds], bh0, bh1, bl0, bl1);
    }
  online_softmax(s, o, m, l, scale_log2, masked, seen);

  // slice j as P's A fragment: (p[g][2t], p[g+8][2t], p[g][2t+1],
  // p[g+8][2t+1])
#pragma unroll
  for (int j = 0; j < kSlices; ++j) {
    uint32_t ah[4], al[4];
    split_tf32(s[j][0], ah[0], al[0]);
    split_tf32(s[j][2], ah[1], al[1]);
    split_tf32(s[j][1], ah[2], al[2]);
    split_tf32(s[j][3], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < kDSteps; ++n) {
      uint32_t bh0, bh1, bl0, bl1;
      v_frag(j, n, bh0, bh1, bl0, bl1);
      mma_3xtf32(o[n], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// One key tile of FlashAttention-2 on m16n8k16 fragments, q, K and V of
// the 16-bit type E, for the 16 query rows a warp holds as A fragments
// qa (head dims 16ds .. 16ds + 15 in qa[ds], ds < kD / 16; further rows of
// qa are not read):
//
// * S = Q·Kᵀ in one 16-bit product, float32 accumulate: products of two
//   16-bit values are exact, so this is float32's q·k up to the order of
//   the sums; slice j holds keys 8j + 2t and 8j + 2t + 1 of rows g and
//   g + 8, as in attention_tile;
// * online_softmax on those accumulator fragments;
// * O += P·V with the float32 p in two 16-bit parts (split16), the small
//   part first: the accumulators of slices 2i and 2i + 1 are the A
//   fragment of P's keys 16i .. 16i + 15 as they lie.
//
// ks and vs: the tile's kSlices · 8 K and V rows in shared memory,
// `stride` elements apart (16-byte aligned; head dims D .. kD-1 zero), K
// read through ldmatrix, V through ldmatrix.trans.  o[n] holds output
// columns 8n + 2t and 8n + 2t + 1.  seen: as online_softmax's.  Every sum
// runs in an order fixed by the fragments.
template <typename E, int kSlices, int kD, int kQ, class Seen>
__device__ __forceinline__ void attention_tile_16(
    const uint32_t (&qa)[kQ][4], float (&o)[kD / 8][4], float (&m)[2],
    float (&l)[2], float scale_log2, bool masked, const E* ks, const E* vs,
    int stride, const Seen& seen) {
  static_assert(kSlices % 2 == 0 && kD % 16 == 0 && kQ >= kD / 16,
                "whole 16x16 steps");
  const int lane = threadIdx.x & 31;
  const int mat = lane >> 3, r = lane & 7;       // ldmatrix: matrix, row
  float s[kSlices][4];
#pragma unroll
  for (int j = 0; j < kSlices; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  // matrices: keys 8j.. and 8(j+1).. at head dims 16ds.. and 16ds + 8..
  const E* krow = ks + (8 * (mat >> 1) + r) * stride + 8 * (mat & 1);
#pragma unroll
  for (int ds = 0; ds < kD / 16; ++ds)
#pragma unroll
    for (int j = 0; j < kSlices; j += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, krow + 8 * j * stride + 16 * ds);
      mma_16<E>(s[j], qa[ds], b[0], b[1]);
      mma_16<E>(s[j + 1], qa[ds], b[2], b[3]);
    }
  online_softmax(s, o, m, l, scale_log2, masked, seen);

  // matrices: keys 16i.. and 16i + 8.. at head dims 8n.. and 8(n+1)..
  const E* vrow = vs + (8 * (mat & 1) + r) * stride + 8 * (mat >> 1);
#pragma unroll
  for (int i = 0; i < kSlices / 2; ++i) {
    uint32_t ph[4], pl[4];
    split16<E>(s[2 * i][0], s[2 * i][1], ph[0], pl[0]);
    split16<E>(s[2 * i][2], s[2 * i][3], ph[1], pl[1]);
    split16<E>(s[2 * i + 1][0], s[2 * i + 1][1], ph[2], pl[2]);
    split16<E>(s[2 * i + 1][2], s[2 * i + 1][3], ph[3], pl[3]);
#pragma unroll
    for (int n = 0; n < kD / 8; n += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vrow + 16 * i * stride + 8 * n);
      mma_16<E>(o[n], pl, b[0], b[1]);
      mma_16<E>(o[n], ph, b[0], b[1]);
      mma_16<E>(o[n + 1], pl, b[2], b[3]);
      mma_16<E>(o[n + 1], ph, b[2], b[3]);
    }
  }
}

}  // namespace mxtt
