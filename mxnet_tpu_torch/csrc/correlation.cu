// FlowNet correlation for kernel_size 1, stride1 1 and pad = max displacement
// m (the reference's correlation.cu in that configuration):
//
//     out[n, i·D2 + j, y, x] = Σ_c a[n, c, y, x] · b[n, c, y + dy_i, x + dx_j] / C
//     (or Σ_c |a − b| / C when is_multiply is false)
//
// with ng = m / s2, D2 = 2·ng + 1, dy_i = (i − ng)·s2, dx_j = (j − ng)·s2 and
// b read as 0 outside the image (the zero padding of width m).  a, b are
// (N, C, H, W) and out (N, D2², H, W), all float32, all float16 or all
// bfloat16; sums in float32, out rounded once to the operands' type
// (elem.cuh).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py:393
// (_correlation_kernel, launched by correlation at line 417).  There one
// grid step held a whole sample's a and zero-padded b in VMEM and unrolled
// the D2² displacements as static slices, which Mosaic needed; the wrapper
// padded b with a copy and declined D2² > 169 to bound the unroll.  Here b
// is read with a bounds check, no padded copy exists, and the displacement
// loop is data, not code, so any D2 runs (FlowNetC's 441 included).
//
// Which instance runs (mxtt_correlation):
//   * float16 and bfloat16 with is_multiply: the tensor-core instance
//     (correlation_tc_kernel) wherever 16-byte copies can stage a and b
//     (W % 8 == 0, both 16-byte aligned) and a 16-pixel tile's window fits
//     8 n-tiles, 16 + shift + 2·ng·s2 <= 64 columns (ng·s2 <= 24):
//     FlowNetC's and PWC-Net's stages and every such window up to m 24;
//   * everything else (float32; |a − b| in any dtype; 16-bit products at
//     another W or alignment, or over a wider window): the register-blocked
//     instance (stride2 1, and stride2 2 at W % 4 == 0 with a and b aligned
//     to 4 elements), else the general one.

// What bounds it.  Each output costs C multiply-adds (2·C flops) and each
// input pixel is used by D2² outputs, so at FlowNetC's stage (N 8, C 256,
// 48 x 64, D2² = 441) the work is 5.5 GFLOP over 94 MB in float32: bound by
// float32 arithmetic, near 0.083 ms on an H100 SXM at 67 TFLOP/s.  In
// 16-bit the same work on the tensor cores takes 0.0056 ms at 989 TFLOP/s
// and the bytes halve to 47 MB, 0.014 ms at 3.35 TB/s: bound by bytes.
//
// The tensor-core instance.  Fix a sample n, an output row y and a
// displacement row i: S = A_y · B_{y+dy_i}, A_y the (W x C) row of a and B
// the (C x W) row of b, and out[n, i·D2 + j, y, x] = S[x, x + dx_j] / C, a
// band of S.  A warp computes S for 16 pixels x (M) against the 8·kNT
// window columns x' they reach (N), 16 channels a step (K), on mma.sync
// m16n8k16 (attention.cuh's mma_16) over float32 accumulators.  Each
// product of two 16-bit values is exact in float32; the tensor cores sum
// 16 of them a step and the steps add in channel order, so the output lies
// within one unit in the last place of the float32 instance's, rounded.
// At FlowNetC's stage a tile of 16 x reaches 56 x' from a column 4 left
// of a multiple of 8.
//
// A block owns kTcRows output rows at stride s2 (y, y + s2, ...), 64
// columns (kTcMTiles m-tiles; one warp a row and m-tile) and ni consecutive
// displacement rows.  Row r and displacement row i_first + il read b row
// r + il of the block's window, so at FlowNetC's stage 4 rows and 3
// displacement rows read 6 b rows.  A warp keeps its A fragment for its ni
// displacement rows (ni·kNT·4 accumulators a thread, ni <= kNI = 24 / kNT,
// which fits 128 registers without spilling).  Channels go through a
// kTcStages ring of kTcChunk channels, a and b in their 16-bit type, by
// 16-byte cp.async copies, zero outside the image and past C; a warp
// copies whole (row, channel) lines, so each line's address is worked out
// once (copies whose addresses took divisions, or that moved 8 bytes, made
// the kernel 1.6x slower on an H100).  The window starts at the multiple of 8 at or left of the
// first column the tile's band reaches (`shift` columns left of it), so
// kNT = ceil((16 + shift + 2·ng·s2) / 8): 8 at FlowNetC's stage, where
// 336 of a tile's 1,024 products are the band's.  Rows hold channels at a
// stride of an odd number of 16-byte units, so ldmatrix.trans (channels
// the slow dimension, as NCHW has them) reads each 8x8 matrix from 8
// distinct bank groups.  The epilogue divides by C (a multiply by 1 / C
// when C is a power of two, where that is exact) and rounds once to the
// operands' type, writes a warp's S to shared memory (the stages' bytes),
// and reads the band back so each half-warp stores 16 consecutive x of
// one output row, 32 bytes.

// The register-blocked instance (float32; stride2 1, and stride2 2 at W %
// 4 == 0).  A thread owns kP = 8 output pixels of one row that share a
// column class mod s2 (x, x + s2, ..., x + 7·s2) and a run of J
// consecutive dx of one displacement row i.  Those need only kP + J − 1
// distinct b columns, so per channel a thread reads 8 a values and
// kP + J − 1 b values from shared memory for 8·J multiply-adds: 26 words
// for 88 at stride2 2 (J = 11), 24 for 72 at stride2 1 (J = 9), against
// one word per multiply-add before.  It walks the b columns along the
// diagonals q = p + j, one b value live at a time, so the accumulators
// and the 8 a values fit 128 registers without spilling.  A block holds
// the warps of ni consecutive displacement rows over an 8 x 32 tile, so
// one staged a tile and b window serve ni·D2 displacements (FlowNetC: 14
// warps over 7 rows, 3 displacement groups).  Registers bound the block:
// ptxas splits an SM's registers over four partitions, so 14 warps get
// 128 registers where 21 would get 80.  Channels go through a two-stage
// cp.async ring (16 channels a stage at stride2 2), the a tile and the b
// window zero outside the image and past C: 16-byte copies at stride2 2,
// 4-byte at stride2 1.  Row strides in shared memory are padded so a
// warp's lanes read distinct words in distinct banks (rb_thread, lane_stride).
// Sums run over the channels in order and divide by C at the end, as
// _correlation_kernel does.
//
// The general instance (the other shapes, and windows the register-blocked
// one cannot stage) is the earlier design: a block of 8 warps over an 8 x 32
// tile and kAcc = 32 flattened displacements, one accumulator each, one
// shared-memory read per multiply-add, the b window's channel stride the
// constant kFastStride when the window fits so every read is an
// immediate offset from one pointer per displacement.
//
// Both SIMT instances stage 16-bit operands in their own type: 8-byte
// cp.async copies of 4 elements where the float32 instance copies 16 bytes,
// one element (2 bytes) through a register where it copies 4, and each
// value is converted to float32 as it is read from shared memory.  All
// that follows is the float32 instance's code, so a 16-bit |a − b| output
// is bitwise the float32 instance's on the upcast inputs, rounded.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention.cuh"
#include "elem.cuh"

namespace {

constexpr int kTH = 8;                           // tile rows: one per warp
constexpr int kTW = 32;                          // tile columns: one per lane
constexpr int kThreads = kTH * kTW;
constexpr int kAcc = 32;                         // displacements per block
constexpr int kChunk = 8;                        // channels per stage
constexpr int kFastStride = 1024;                // b window elements a channel
constexpr int kMaxSmem = 227 * 1024;             // a block's opt-in limit
constexpr int kMaxDevices = 64;

// The register-blocked instances: the same 8 x 32 tile, a warp's lanes 8
// rows x kLanesX column groups, kP pixels a thread.  Per stride2: J dx a
// thread, channels a stage, the most warps a block, blocks an SM.
constexpr int kP = 8;
constexpr int kLanesX = 4;
constexpr int kS1J = 9;
constexpr int kS1Chunk = 8;
constexpr int kS1Warps = 5;
constexpr int kS1MinBlocks = 3;
constexpr int kS2J = 11;
constexpr int kS2Chunk = 16;
constexpr int kS2Warps = 14;
constexpr int kS2MinBlocks = 1;
static_assert(kP * kLanesX == kTW && kTH * kLanesX == 32, "lane layout");

// The tensor-core instances: output rows and 16-pixel m-tiles a block (one
// warp each pair), channels a stage, stages, the most n-tiles a warp, and
// blocks an SM (registers hold one).
constexpr int kTcRows = 4;
constexpr int kTcMTiles = 4;
constexpr int kTcChunk = 32;
constexpr int kTcStages = 3;
constexpr int kTcMaxNT = 8;
constexpr int kTcMinBlocks = 1;
constexpr int kTcWarps = kTcRows * kTcMTiles;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcCols = 16 * kTcMTiles;          // a block's columns

// The least odd multiple of 8 at or above n: a row stride, in 16-bit
// elements, at which 8 consecutive rows start in 8 distinct 16-byte bank
// groups (ldmatrix, and the epilogue's 32-bit stores).
__host__ __device__ constexpr int odd8(int n) { return ((n + 7) / 8 | 1) * 8; }

// A tensor-core warp's displacement rows at kNT n-tiles: at most 96
// accumulators a thread.
__host__ __device__ constexpr int tc_rows(int nt) { return 24 / nt; }

// kN elements of E from global to shared memory: one cp.async of
// kN·sizeof(E) bytes (4, 8 or 16); a single 16-bit element, a size cp.async
// does not move, through a register.  `valid` false writes zeros and reads
// nothing.
template <int kN, typename E>
__device__ __forceinline__ void stage_copy(E* dst, const E* src, bool valid) {
  constexpr int kBytes = kN * static_cast<int>(sizeof(E));
  if constexpr (kBytes == 16) {
    mxtt::cp_async16(dst, src, valid);
  } else if constexpr (kBytes == 8) {
    mxtt::cp_async8(dst, src, valid);
  } else if constexpr (kBytes == 4) {
    mxtt::cp_async4(dst, src, valid);
  } else {
    static_assert(kBytes == 2, "a copy of 2, 4, 8 or 16 bytes");
    *dst = valid ? *src : mxtt::from_f32<E>(0.f);
  }
}

// One stage's 16-byte copies of a tile of `rows` rows at stride s2 from
// (y0, x0), kTcChunk channels from c0: each row and channel a line of kQ
// groups of 8 elements, stored at kStride elements a line.  A warp copies
// whole lines, kL lanes a line (kQ rounded up to a power of two), so each
// line's address is worked out once.  Zero outside the image and past C;
// W % 8 == 0 and x0 a multiple of 8 put each group wholly inside or
// outside the image.
template <int kStride, int kQ, typename E>
__device__ __forceinline__ void stage_lines(E* dst, const E* img, int c0,
                                            int C, int H, int W,
                                            size_t plane, int y0, int x0,
                                            int s2, int rows, int warp,
                                            int lane) {
  constexpr int kL = kQ <= 8 ? 8 : kQ <= 16 ? 16 : 32;
  static_assert(kQ <= 32, "a line in one pass");
  const int g = lane % kL, xx = x0 + 8 * g;
  if (g >= kQ) return;
  const bool col_in = xx >= 0 && xx + 8 <= W;
  for (int line = warp * (32 / kL) + lane / kL; line < rows * kTcChunk;
       line += kTcWarps * (32 / kL)) {
    const int ch = line % kTcChunk, yy = y0 + line / kTcChunk * s2;
    const bool in = col_in && c0 + ch < C && yy >= 0 && yy < H;
    stage_copy<8>(dst + line * kStride + 8 * g,
                  img + (in ? (size_t)(c0 + ch) * plane + (size_t)yy * W +
                                  xx : 0),
                  in);
  }
}

// Tensor-core instance, E float16 or bfloat16, kNT n-tiles of 8 window
// columns a 16-pixel tile, at most kNI displacement rows a warp.  Shared
// memory per stage: the a tile (kTcRows rows x kTcChunk channels x kAS
// columns) then the b window (wrows = kTcRows + ni − 1 rows x kTcChunk x
// kBS), each row of a (or b) the block's columns from x0 (wx0).  W % 8 ==
// 0 and a and b 16-byte aligned (the launcher takes this instance only
// there); shift: wx0's offset left of x0 − ng·s2, so wx0 is a multiple
// of 8.
template <typename E, int kNT, int kNI>
__global__ void __launch_bounds__(kTcThreads, kTcMinBlocks)
correlation_tc_kernel(const E* __restrict__ a, const E* __restrict__ b,
                      E* __restrict__ out, int C, int H, int W, int D2,
                      int ng, int s2, int ni, int n_igroups, int shift) {
  constexpr int kAS = odd8(kTcCols);
  constexpr int kWC = 16 * (kTcMTiles - 1) + 8 * kNT;  // window columns
  constexpr int kBS = odd8(kWC);
  constexpr int kSS = odd8(8 * kNT);                   // epilogue row stride
  extern __shared__ __align__(16) unsigned char corr_smem[];
  E* smem = reinterpret_cast<E*>(corr_smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = warp / kTcMTiles, mt = warp % kTcMTiles;
  const int n = blockIdx.z / n_igroups;
  const int i_first = (blockIdx.z % n_igroups) * ni;
  const int n_i = min(ni, D2 - i_first);
  // rows ya0, ya0 + s2, ...: row r against displacement row i_first + il
  // reads b row wy0 + (r + il)·s2
  const int ya0 = blockIdx.y / s2 * kTcRows * s2 + blockIdx.y % s2;
  const int wy0 = ya0 + (i_first - ng) * s2;
  const int x0 = blockIdx.x * kTcCols;
  const int wx0 = x0 - ng * s2 - shift;
  const int wrows = kTcRows + ni - 1;
  const int a_elems = kTcRows * kTcChunk * kAS;
  const int stage_elems = a_elems + wrows * kTcChunk * kBS;
  const size_t plane = (size_t)H * W;
  const E* an = a + (size_t)n * C * plane;
  const E* bn = b + (size_t)n * C * plane;

  // Channels c0 .. c0 + kTcChunk − 1 of the a tile and the b window into
  // `buf` as one commit group (a zero past C adds nothing)
  auto stage = [&](int c0, E* buf) {
    stage_lines<kAS, kTcCols / 8>(buf, an, c0, C, H, W, plane, ya0, x0, s2,
                                  kTcRows, warp, lane);
    stage_lines<kBS, kWC / 8>(buf + a_elems, bn, c0, C, H, W, plane, wy0,
                              wx0, s2, wrows, warp, lane);
    mxtt::cp_async_commit();
  };

  float acc[kNI][kNT][4];
#pragma unroll
  for (int il = 0; il < kNI; ++il)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[il][nt][e] = 0.f;
  const int y = ya0 + r * s2;
  const bool active = y < H && x0 + 16 * mt < W;
  // ldmatrix rows (attention.cuh): A's matrices (x 0-7 | 8-15) x (channels
  // 0-7 | 8-15) as a0..a3, B's (channels 0-7 | 8-15) x (n-tile nt | nt + 1)
  // as b0, b1 of each
  const int a_lane = r * kTcChunk * kAS + 16 * mt +
                     ((lane & 7) + 8 * (lane >> 4)) * kAS +
                     8 * ((lane >> 3) & 1);
  const int b_lane = a_elems + r * kTcChunk * kBS + 16 * mt +
                     ((lane & 7) + 8 * ((lane >> 3) & 1)) * kBS +
                     8 * (lane >> 4);

  // a ring of kTcStages: chunk k + kTcStages − 1 is issued while chunk k
  // is multiplied, into the buffer chunk k − 1 left (every warp is past
  // the barrier, so done with it)
  const int n_chunks = (C + kTcChunk - 1) / kTcChunk;
#pragma unroll
  for (int k = 0; k < kTcStages - 1; ++k) {
    if (k < n_chunks)
      stage(k * kTcChunk, smem + k * stage_elems);
    else
      mxtt::cp_async_commit();
  }
  for (int k = 0; k < n_chunks; ++k) {
    mxtt::cp_async_wait<kTcStages - 2>();
    __syncthreads();
    const int next = k + kTcStages - 1;
    if (next < n_chunks)
      stage(next * kTcChunk, smem + next % kTcStages * stage_elems);
    else
      mxtt::cp_async_commit();
    if (!active) continue;
    const E* s = smem + k % kTcStages * stage_elems;
#pragma unroll
    for (int ks = 0; ks < kTcChunk / 16; ++ks) {
      uint32_t af[4];
      mxtt::ldmatrix_x4_trans(af, s + a_lane + ks * 16 * kAS);
#pragma unroll
      for (int il = 0; il < kNI; ++il) {
        if (il < n_i) {
          const E* sb = s + b_lane + (il * kTcChunk + ks * 16) * kBS;
#pragma unroll
          for (int nt = 0; nt + 1 < kNT; nt += 2) {
            uint32_t bf[4];
            mxtt::ldmatrix_x4_trans(bf, sb + 8 * nt);
            mxtt::mma_16<E>(acc[il][nt], af, bf[0], bf[1]);
            mxtt::mma_16<E>(acc[il][nt + 1], af, bf[2], bf[3]);
          }
          if constexpr (kNT % 2 == 1) {
            uint32_t bf[2];
            mxtt::ldmatrix_x2_trans(bf, sb + 8 * (kNT - 1));
            mxtt::mma_16<E>(acc[il][kNT - 1], af, bf[0], bf[1]);
          }
        }
      }
    }
  }
  mxtt::cp_async_wait<0>();
  __syncthreads();                     // the stages' bytes are free now
  if (!active) return;

  // S / C rounded to E into the warp's 16 x 8·kNT scratch (accumulator
  // (g, 2t), (g, 2t + 1), (g + 8, ...) of each n-tile), then the band:
  // lane (m, j parity) reads S[m, m + shift + j·s2] and a half-warp stores
  // x0 + 16·mt .. + 15 of one output row
  E* sc = smem + warp * 16 * kSS;
  const int g = lane >> 2, t = lane & 3, m = lane & 15;
  const int x = x0 + 16 * mt + m;
  // a power-of-two C divides exactly by a multiply with 1 / C, which
  // spares the division's range check and the slow path it takes on the
  // many zeros
  const float norm = (float)C, rcp = 1.f / norm;
  const bool pow2 = (C & (C - 1)) == 0;
  auto rounded = [&](float c) {
    return mxtt::from_f32<E>(pow2 ? c * rcp : c / norm);
  };
#pragma unroll
  for (int il = 0; il < kNI; ++il) {
    if (il < n_i) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        *reinterpret_cast<uint32_t*>(sc + g * kSS + 8 * nt + 2 * t) =
            mxtt::pack16(rounded(acc[il][nt][0]), rounded(acc[il][nt][1]));
        *reinterpret_cast<uint32_t*>(sc + (g + 8) * kSS + 8 * nt + 2 * t) =
            mxtt::pack16(rounded(acc[il][nt][2]), rounded(acc[il][nt][3]));
      }
      __syncwarp();
      if (x < W) {
        const E* band = sc + m * kSS + m + shift;
        E* o = out + ((size_t)n * D2 + i_first + il) * D2 * plane +
               (size_t)y * W + x;
        for (int j = lane >> 4; j < D2; j += 2)
          o[(size_t)j * plane] = band[j * s2];
      }
      __syncwarp();
    }
  }
}

// The b window of a displacement group: the rows it reaches, and columns
// from the multiple of 4 at or left of the tile's first column minus the
// largest displacement, padded to a multiple of 4 (every block's window has
// the same width, so 16-byte copies stay aligned).
struct Window {
  int i_first, rows, cols;
  __host__ __device__ Window(int d0, int nd, int D2, int s2) {
    i_first = d0 / D2;
    const int i_last = (d0 + nd - 1) / D2;
    rows = kTH + (i_last - i_first) * s2;
    cols = (kTW + (D2 - 1) * s2 + 3 + 3) / 4 * 4;
  }
};

// kStride: elements between one channel's b window and the next in a stage;
// a compile-time stride (kFastStride) turns every b read into a shared load
// at an immediate offset from one pointer per displacement.  0: the
// window's own size, for windows larger than kFastStride.
template <typename E, bool kMultiply, int kStride>
__global__ void __launch_bounds__(kThreads)
correlation_kernel(const E* __restrict__ a, const E* __restrict__ b,
                   E* __restrict__ out, int C, int H, int W, int D2,
                   int ng, int s2, int n_groups, bool vec) {
  extern __shared__ __align__(16) unsigned char corr_smem[];
  E* smem = reinterpret_cast<E*>(corr_smem);
  const int DD = D2 * D2;
  const int n = blockIdx.z / n_groups;
  const int d0 = (blockIdx.z % n_groups) * kAcc;
  const int nd = min(kAcc, DD - d0);
  const Window win(d0, nd, D2, s2);
  const int wsize = win.rows * win.cols;
  const int stride = kStride ? kStride : wsize;
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const int wy0 = y0 + (win.i_first - ng) * s2;  // window origin, image coords
  const int wx0 = (x0 - ng * s2) & ~3;             // 4-aligned, at or left
  const int shift = x0 - ng * s2 - wx0;            // 0 .. 3
  const int ty = threadIdx.x / kTW, tx = threadIdx.x % kTW;

  // offset of displacement d0 + k from the thread's own window position
  int koff[kAcc];
#pragma unroll
  for (int kk = 0; kk < kAcc; ++kk) {
    const int d = d0 + min(kk, nd - 1);
    koff[kk] = (d / D2 - win.i_first) * s2 * win.cols + (d % D2) * s2;
  }
  float acc[kAcc];
#pragma unroll
  for (int kk = 0; kk < kAcc; ++kk) acc[kk] = 0.f;

  const size_t plane = (size_t)H * W;
  const E* an = a + (size_t)n * C * plane;
  const E* bn = b + (size_t)n * C * plane;
  const int stage_elems = kChunk * (kThreads + stride);

  // Copy channels c0 .. c0 + kChunk - 1 of the a tile and the b window into
  // `buf` as one commit group (stage_copy), zero outside the image and past
  // channel C (a zero a and b add nothing to either sum): 4 elements at a
  // time when rows are aligned (`vec`: W % 4 == 0, so an aligned group of 4
  // columns lies wholly inside or outside), else 1.
  auto copy = [&](E* dst, const E* src, bool in, bool wide) {
    if (wide)
      stage_copy<4>(dst, src, in);
    else
      stage_copy<1>(dst, src, in);
  };
  auto stage = [&](int c0, E* buf) {
    E* as = buf;
    E* bs = buf + kChunk * kThreads;
    if (vec) {
      constexpr int kQ = kTW / 4;                  // float4s per tile row
      for (int i = threadIdx.x; i < kChunk * kTH * kQ; i += kThreads) {
        const int ci = i / (kTH * kQ), p = i % (kTH * kQ);
        const int yy = y0 + p / kQ, xx = x0 + (p % kQ) * 4;
        const bool in = c0 + ci < C && yy < H && xx < W;
        copy(as + ci * kThreads + p * 4,
             in ? an + (size_t)(c0 + ci) * plane + (size_t)yy * W + xx : an,
             in, true);
      }
      const int q = win.cols / 4, per = win.rows * q;
      for (int i = threadIdx.x; i < kChunk * per; i += kThreads) {
        const int ci = i / per, p = i % per;
        const int r = p / q, col = (p % q) * 4;
        const int yy = wy0 + r, xx = wx0 + col;
        const bool in = c0 + ci < C && yy >= 0 && yy < H && xx >= 0 && xx < W;
        copy(bs + ci * stride + r * win.cols + col,
             in ? bn + (size_t)(c0 + ci) * plane + (size_t)yy * W + xx : bn,
             in, true);
      }
    } else {
      for (int ci = 0; ci < kChunk; ++ci) {      // rows by warp, cols by lane
        const bool c_in = c0 + ci < C;
        const E* ac = an + (size_t)(c_in ? c0 + ci : 0) * plane;
        const E* bc = bn + (size_t)(c_in ? c0 + ci : 0) * plane;
        {
          const int yy = y0 + ty, xx = x0 + tx;
          const bool in = c_in && yy < H && xx < W;
          copy(as + ci * kThreads + threadIdx.x,
               in ? ac + (size_t)yy * W + xx : ac, in, false);
        }
        E* bsc = bs + ci * stride;
        for (int r = ty; r < win.rows; r += kTH) {
          const int yy = wy0 + r;
          const bool row_in = c_in && yy >= 0 && yy < H;
          for (int col = tx; col < win.cols; col += kTW) {
            const int xx = wx0 + col;
            const bool in = row_in && xx >= 0 && xx < W;
            copy(bsc + r * win.cols + col,
                 in ? bc + (size_t)yy * W + xx : bc, in, false);
          }
        }
      }
    }
    mxtt::cp_async_commit();
  };

  // two stages: chunk k + 1 is in flight while chunk k is summed
  const int n_chunks = (C + kChunk - 1) / kChunk;
  stage(0, smem);
  for (int k = 0; k < n_chunks; ++k) {
    const E* as = smem + (k & 1) * stage_elems;
    const E* bs = as + kChunk * kThreads;
    if (k + 1 < n_chunks) {
      stage((k + 1) * kChunk, smem + ((k + 1) & 1) * stage_elems);
      mxtt::cp_async_wait<1>();
    } else {
      mxtt::cp_async_wait<0>();
    }
    __syncthreads();
    float av[kChunk];
#pragma unroll
    for (int ci = 0; ci < kChunk; ++ci)
      av[ci] = mxtt::to_f32(as[ci * kThreads + threadIdx.x]);
    const E* bw = bs + ty * win.cols + tx + shift;
    // a group's spare slots repeat its last displacement and are never
    // stored, so no branch on nd splits the loads
#pragma unroll
    for (int kk = 0; kk < kAcc; ++kk) {
      const E* p = bw + koff[kk];
#pragma unroll
      for (int ci = 0; ci < kChunk; ++ci) {
        const float bv = mxtt::to_f32(p[ci * stride]);
        acc[kk] = kMultiply ? fmaf(av[ci], bv, acc[kk])
                            : acc[kk] + fabsf(av[ci] - bv);
      }
    }
    __syncthreads();                             // buffer k & 1 free again
  }

  const int y = y0 + ty, x = x0 + tx;
  if (y < H && x < W) {
    const float norm = (float)C;
    E* o = out + ((size_t)n * DD + d0) * plane + (size_t)y * W + x;
#pragma unroll
    for (int kk = 0; kk < kAcc; ++kk)
      if (kk < nd)
        o[(size_t)kk * plane] = mxtt::from_f32<E>(acc[kk] / norm);
  }
}

// Opt `kernel` into `bytes` of dynamic shared memory on `device`; `opted`
// holds, per device, the most this kernel was opted into so far.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int* opted, int device, size_t bytes) {
  if (bytes <= 48 * 1024 || (int)bytes <= opted[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) opted[device] = (int)bytes;
  return err;
}

template <typename E, bool kMultiply, int kStride>
cudaError_t launch_general(const E* a, const E* b, E* out, int C, int H,
                           int W, int D2, int ng, int s2, int n_groups,
                           bool vec, dim3 grid, size_t bytes, int device,
                           cudaStream_t stream) {
  auto kernel = correlation_kernel<E, kMultiply, kStride>;
  static int opted[kMaxDevices];
  const cudaError_t err = opt_in(kernel, opted, device, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, stream>>>(a, b, out, C, H, W, D2, ng, s2,
                                            n_groups, vec);
  return cudaGetLastError();
}

// Where thread (warp, lane) of a register-blocked block works: displacement
// row i_first + il, dx j0 .. j0 + kJ − 1, tile row ty and pixels x0 + xoff +
// p·kS2 (p < kP).  A warp covers `runs` dx runs of kJ (runs·kJ >= D2).
//   stride2 1: warp = (il, run); lane = (ty, column group g): xoff = 8g.
//   stride2 2: warp = (il, run pair, 16-column half h); lane = (ty, column
//     parity, run of the pair): xoff = 16h + parity.  The pair's runs sit
//     2·kJ ≡ 2 (mod 4) columns apart, so at a row stride ≡ 4 (mod 8), which
//     16-byte copies need, the 32 lanes still read 32 banks.
struct ThreadMap {
  int il, j0, ty, xoff;
};

__host__ __device__ inline int rb_runs(int D2, int s2, int J) {
  const int jg = (D2 + J - 1) / J;
  return s2 == 1 ? jg : 2 * ((jg + 1) / 2);
}

__host__ __device__ inline ThreadMap rb_thread(int warp, int lane, int D2,
                                               int s2, int J) {
  const int runs = rb_runs(D2, s2, J);
  ThreadMap t;
  t.il = warp / runs;                            // runs warps a row
  t.ty = lane / kLanesX;
  if (s2 == 1) {
    t.j0 = (warp % runs) * J;
    t.xoff = (lane % kLanesX) * kP;
  } else {
    const int pairs = runs / 2, w = warp % runs;
    t.j0 = (2 * (w % pairs) + (lane / 2) % 2) * J;
    t.xoff = (w / pairs) * kP * 2 + lane % 2;
  }
  return t;
}

// Register-blocked instance, stride2 = kS2 (1 or 2), kP pixels x kJ dx a
// thread (rb_thread).  Shared memory per channel: the a tile (kTH rows at
// stride ra) then the b window (wrows x wcols at stride rb) from (y0 +
// (i_first − ng)·kS2, wx0), wx0 the multiple of 4 at or left of x0 −
// ng·kS2; channel stride ra·kTH + rb·wrows.  Copies move 4 elements at
// stride2 2 (the launcher takes this instance there only for W % 4 == 0
// and inputs aligned to 4 elements), 1 at stride2 1.
template <typename E, bool kMultiply, int kS2, int kJ, int kChunkN,
          int kWarps, int kMinBlocks>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
correlation_rb_kernel(const E* __restrict__ a, const E* __restrict__ b,
                      E* __restrict__ out,
                      int C, int H, int W, int D2, int ng, int ni,
                      int n_igroups, int ra, int rb, int wrows, int wcols) {
  extern __shared__ __align__(16) unsigned char corr_smem[];
  E* smem = reinterpret_cast<E*>(corr_smem);
  const int n = blockIdx.z / n_igroups;
  const int i_first = (blockIdx.z % n_igroups) * ni;
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const int wy0 = y0 + (i_first - ng) * kS2;
  const int wx0 = (x0 - ng * kS2) & ~3;
  const int shift = x0 - ng * kS2 - wx0;          // 0 .. 3
  const int a_elems = kTH * ra;
  const int ch_elems = a_elems + wrows * rb;
  const int stage_elems = kChunkN * ch_elems;
  const ThreadMap t = rb_thread(threadIdx.x / 32, threadIdx.x % 32, D2, kS2,
                                kJ);

  const size_t plane = (size_t)H * W;
  const E* an = a + (size_t)n * C * plane;
  const E* bn = b + (size_t)n * C * plane;

  // Copy channels c0 .. c0 + kChunkN − 1 of the a tile and the b window
  // into `buf` as one commit group (stage_copy), zero outside the image
  // and past channel C (a zero a and b add nothing to either sum): 4
  // elements a copy at stride2 2 (W % 4 == 0 puts an aligned group of 4
  // wholly inside or outside the image), 1 at stride2 1.  Each group's
  // addresses are worked out once and walk the channels.
  auto stage = [&](int c0, E* buf) {
    constexpr int kWide = kS2 == 2 ? 4 : 1;
    const int qa = kTW / kWide, qb = wcols / kWide;
    const int per = kTH * qa + wrows * qb;
    for (int e = threadIdx.x; e < per; e += blockDim.x) {
      int dst, yy, xx;
      const E* base;
      if (e < kTH * qa) {
        dst = (e / qa) * ra + (e % qa) * kWide;
        yy = y0 + e / qa;
        xx = x0 + (e % qa) * kWide;
        base = an;
      } else {
        const int f = e - kTH * qa;
        dst = a_elems + (f / qb) * rb + (f % qb) * kWide;
        yy = wy0 + f / qb;
        xx = wx0 + (f % qb) * kWide;
        base = bn;
      }
      const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
      const E* src =
          base + (in ? (size_t)c0 * plane + (size_t)yy * W + xx : 0);
      E* to = buf + dst;
#pragma unroll
      for (int ci = 0; ci < kChunkN; ++ci) {
        const bool v = in && c0 + ci < C;
        stage_copy<kWide>(to, v ? src : base, v);
        src += plane;
        to += ch_elems;
      }
    }
    mxtt::cp_async_commit();
  };

  float acc[kP][kJ];
#pragma unroll
  for (int p = 0; p < kP; ++p)
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[p][j] = 0.f;
  const int a_off = t.ty * ra + t.xoff;
  const int b_off = a_elems + (t.ty + t.il * kS2) * rb + shift + t.xoff +
                    t.j0 * kS2;

  // two stages: chunk k + 1 is in flight while chunk k is summed
  const int n_chunks = (C + kChunkN - 1) / kChunkN;
  stage(0, smem);
  for (int k = 0; k < n_chunks; ++k) {
    const E* s = smem + (k & 1) * stage_elems;
    if (k + 1 < n_chunks) {
      stage((k + 1) * kChunkN, smem + ((k + 1) & 1) * stage_elems);
      mxtt::cp_async_wait<1>();
    } else {
      mxtt::cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll 2
    for (int ci = 0; ci < kChunkN; ++ci) {
      const E* sa = s + ci * ch_elems + a_off;
      const E* sb = s + ci * ch_elems + b_off;
      float av[kP];
#pragma unroll
      for (int p = 0; p < kP; ++p) av[p] = mxtt::to_f32(sa[p * kS2]);
      // b column q serves pixel p and dx j0 + q − p: one b value live at
      // a time, so accumulators and a take the registers
#pragma unroll
      for (int q = 0; q < kP + kJ - 1; ++q) {
        const float bv = mxtt::to_f32(sb[q * kS2]);
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          const int j = q - p;
          if (j >= 0 && j < kJ)
            acc[p][j] = kMultiply ? fmaf(av[p], bv, acc[p][j])
                                  : acc[p][j] + fabsf(av[p] - bv);
        }
      }
    }
    __syncthreads();                             // buffer k & 1 free again
  }

  const int i = i_first + t.il, y = y0 + t.ty;
  if (i < D2 && y < H) {
    const float norm = (float)C;
    E* o = out + ((size_t)n * D2 * D2 + (size_t)i * D2 + t.j0) * plane +
           (size_t)y * W + x0 + t.xoff;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if (x0 + t.xoff + p * kS2 >= W) break;
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        if (t.j0 + j < D2)
          o[(size_t)j * plane + p * kS2] =
              mxtt::from_f32<E>(acc[p][j] / norm);
    }
  }
}

// The smallest row stride >= width (a multiple of 4 at stride2 2, for
// 16-byte copies) at which the lanes of a warp that read distinct words
// (a reads: b_reads false) read them in distinct banks.
int lane_stride(int width, int s2, int J, bool b_reads) {
  const int step = s2 == 2 ? 4 : 1;
  const int first = (width + step - 1) / step * step;
  for (int r = first; r < first + 64; r += step) {
    int addr[32], distinct = 0;
    unsigned banks = 0;
    for (int lane = 0; lane < 32; ++lane) {
      // one warp's lanes; the warp's own offsets are the same for all
      const ThreadMap t = rb_thread(0, lane, 2 * J, s2, J);
      addr[lane] = t.ty * r + t.xoff + (b_reads ? t.j0 * s2 : 0);
      bool seen = false;
      for (int k = 0; k < lane; ++k) seen = seen || addr[k] == addr[lane];
      if (!seen) ++distinct;
      banks |= 1u << (addr[lane] % 32);
    }
    if (__builtin_popcount(banks) == distinct) return r;
  }
  return first;
}

// The register-blocked launch's geometry: ni displacement rows a block,
// n_igroups blocks over the D2 rows, the strides and window, threads and
// shared bytes.  ok false when the stride2 has no instance or no ni fits
// the shared memory.
struct RbPlan {
  bool ok;
  int ni, n_igroups, ra, rb, wrows, wcols, threads;
  size_t bytes;
};

template <typename E, bool kMultiply, int kS2>
cudaError_t launch_rb(const E* a, const E* b, E* out, int C, int H, int W,
                      int D2, int ng, const RbPlan& pl, dim3 grid,
                      int device, cudaStream_t stream) {
  constexpr int kJ = kS2 == 1 ? kS1J : kS2J;
  constexpr int kChunkN = kS2 == 1 ? kS1Chunk : kS2Chunk;
  constexpr int kWarps = kS2 == 1 ? kS1Warps : kS2Warps;
  constexpr int kMinBlocks = kS2 == 1 ? kS1MinBlocks : kS2MinBlocks;
  auto kernel = correlation_rb_kernel<E, kMultiply, kS2, kJ, kChunkN,
                                      kWarps, kMinBlocks>;
  static int opted[kMaxDevices];
  const cudaError_t err = opt_in(kernel, opted, device, pl.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, pl.threads, pl.bytes, stream>>>(
      a, b, out, C, H, W, D2, ng, pl.ni, pl.n_igroups, pl.ra, pl.rb,
      pl.wrows, pl.wcols);
  return cudaGetLastError();
}

RbPlan rb_plan(int D2, int ng, int s2, bool vec, size_t esize) {
  RbPlan pl{};
  if (s2 != 1 && !(s2 == 2 && vec)) return pl;
  const int J = s2 == 1 ? kS1J : kS2J;
  const int warps = s2 == 1 ? kS1Warps : kS2Warps;
  const int chunk = s2 == 1 ? kS1Chunk : kS2Chunk;
  const int runs = rb_runs(D2, s2, J);
  if (runs > warps) return pl;
  const int shift = (-ng * s2) & 3;   // wx0's offset left of x0 − ng·s2
  pl.ra = lane_stride(kTW, s2, J, false);
  pl.wcols = (shift + kTW + (runs * J - 1) * s2 + 3) / 4 * 4;
  pl.rb = lane_stride(pl.wcols, s2, J, true);
  // the most rows a block can take, then rows spread evenly over blocks;
  // fewer rows while the two stages overflow the shared memory
  for (int cap = warps / runs; cap >= 1; --cap) {
    pl.n_igroups = (D2 + cap - 1) / cap;
    pl.ni = (D2 + pl.n_igroups - 1) / pl.n_igroups;
    pl.wrows = kTH + (pl.ni - 1) * s2;
    pl.bytes = 2 * esize * chunk * (size_t)(kTH * pl.ra + pl.wrows * pl.rb);
    if (pl.bytes <= (size_t)kMaxSmem) {
      pl.threads = 32 * pl.ni * runs;
      pl.ok = true;
      return pl;
    }
  }
  return pl;
}

// The tensor-core launch's geometry: n-tiles a 16-pixel tile, its
// displacement rows a block and blocks over the D2 rows, the window's
// shift, the grid and the shared bytes.  ok false where 16-byte copies
// cannot stage the operands (W % 8 != 0, or a or b not 16-byte aligned),
// a tile's window needs more than kTcMaxNT n-tiles, or the grid or the
// shared memory cannot hold the shape.
struct TcPlan {
  bool ok;
  int nt, ni, n_igroups, shift;
  dim3 grid;
  size_t bytes;
};

TcPlan tc_plan(const void* a, const void* b, int N, int H, int W, int D2,
               int ng, int s2) {
  TcPlan pl{};
  if (W % 8 != 0 || !mxtt::aligned(a, 16) || !mxtt::aligned(b, 16))
    return pl;
  const int reach = ng * s2;          // the band's reach left and right
  pl.shift = (8 - reach % 8) % 8;
  pl.nt = (16 + pl.shift + 2 * reach + 7) / 8;
  if (pl.nt > kTcMaxNT) return pl;
  // the most displacement rows a warp holds, then rows spread evenly over
  // blocks; fewer while the stages overflow the shared memory
  const int bs = odd8(16 * (kTcMTiles - 1) + 8 * pl.nt);
  for (int cap = tc_rows(pl.nt); cap >= 1 && !pl.ok; --cap) {
    pl.n_igroups = (D2 + cap - 1) / cap;
    pl.ni = (D2 + pl.n_igroups - 1) / pl.n_igroups;
    pl.bytes = 2 * kTcStages * kTcChunk *
               (size_t)(kTcRows * odd8(kTcCols) +
                        (kTcRows + pl.ni - 1) * bs);
    pl.ok = pl.bytes <= (size_t)kMaxSmem;
  }
  const long long gy =
      (long long)s2 * ((H + kTcRows * s2 - 1) / (kTcRows * s2));
  const long long gz = (long long)N * pl.n_igroups;
  pl.ok = pl.ok && gy <= 65535 && gz <= 65535;
  pl.grid = dim3((W + kTcCols - 1) / kTcCols, (unsigned)gy, (unsigned)gz);
  return pl;
}

template <typename E, int kNT>
cudaError_t launch_tc(const E* a, const E* b, E* out, int C, int H, int W,
                      int D2, int ng, int s2, const TcPlan& pl, int device,
                      cudaStream_t stream) {
  auto kernel = correlation_tc_kernel<E, kNT, tc_rows(kNT)>;
  static int opted[kMaxDevices];
  const cudaError_t err = opt_in(kernel, opted, device, pl.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<pl.grid, kTcThreads, pl.bytes, stream>>>(
      a, b, out, C, H, W, D2, ng, s2, pl.ni, pl.n_igroups, pl.shift);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_tc_dtype(const void* a, const void* b, void* out, int C,
                            int H, int W, int D2, int ng, int s2,
                            const TcPlan& pl, int device, cudaStream_t st) {
  const E* ae = static_cast<const E*>(a);
  const E* be = static_cast<const E*>(b);
  E* o = static_cast<E*>(out);
  switch (pl.nt) {
#define CORR_TC(NT)                                                            case NT:                                                                       return launch_tc<E, NT>(ae, be, o, C, H, W, D2, ng, s2, pl, device, st)
    CORR_TC(2);
    CORR_TC(3);
    CORR_TC(4);
    CORR_TC(5);
    CORR_TC(6);
    CORR_TC(7);
    CORR_TC(8);
#undef CORR_TC
  }
  return cudaErrorInvalidValue;
}

// The SIMT instance for element type E: the register-blocked one where the
// plan found one, else the general one with a fixed or a runtime window
// stride.
template <typename E>
cudaError_t launch_dtype(const void* a, const void* b, void* out, int C,
                         int H, int W, int D2, int ng, int s2,
                         int is_multiply, const RbPlan& pl, int n_groups,
                         bool fast, bool vec, dim3 grid, size_t bytes,
                         int device, cudaStream_t st) {
  const E* ae = static_cast<const E*>(a);
  const E* be = static_cast<const E*>(b);
  E* o = static_cast<E*>(out);
  if (pl.ok) {
#define CORR_RB(MUL, S) \
  return launch_rb<E, MUL, S>(ae, be, o, C, H, W, D2, ng, pl, grid, device, st)
    if (is_multiply) {
      if (s2 == 1) CORR_RB(true, 1);
      CORR_RB(true, 2);
    }
    if (s2 == 1) CORR_RB(false, 1);
    CORR_RB(false, 2);
#undef CORR_RB
  }
#define CORR_LAUNCH(MUL, STRIDE)                                         \
  return launch_general<E, MUL, STRIDE>(ae, be, o, C, H, W, D2, ng, s2,  \
                                        n_groups, vec, grid, bytes,      \
                                        device, st)
  if (is_multiply) {
    if (fast) CORR_LAUNCH(true, kFastStride);
    CORR_LAUNCH(true, 0);
  }
  if (fast) CORR_LAUNCH(false, kFastStride);
  CORR_LAUNCH(false, 0);
#undef CORR_LAUNCH
}

}  // namespace

// a, b (N, C, H, W), out (N, D2², H, W) with D2 = 2·(m / s2) + 1:
// contiguous, all of the type `dtype` names (0 float32, 1 float16, 2
// bfloat16).  Returns a cudaError_t: the launch's configuration error (or
// cudaErrorInvalidValue for a shape the grid or shared memory cannot hold),
// if any.  Faults during the run surface at the caller's next
// synchronisation.
extern "C" int mxtt_correlation(const void* a, const void* b, void* out,
                                int N, int C, int H, int W, int m, int s2,
                                int is_multiply, int dtype, int device,
                                void* stream) {
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || m < 0 || s2 <= 0 ||
      dtype < 0 || dtype > 2 || device < 0 || device >= kMaxDevices)
    return cudaErrorInvalidValue;
  const int ng = m / s2, D2 = 2 * ng + 1, DD = D2 * D2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto use_device = [&]() {
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    return err;
  };
  if (dtype != 0 && is_multiply) {
    const TcPlan tp = tc_plan(a, b, N, H, W, D2, ng, s2);
    if (tp.ok) {
      const cudaError_t err = use_device();
      if (err != cudaSuccess) return err;
      if (dtype == 1)
        return launch_tc_dtype<__half>(a, b, out, C, H, W, D2, ng, s2, tp,
                                       device, st);
      return launch_tc_dtype<__nv_bfloat16>(a, b, out, C, H, W, D2, ng, s2,
                                            tp, device, st);
    }
  }
  const int gy = (H + kTH - 1) / kTH, gx = (W + kTW - 1) / kTW;
  // copies of 4 elements: 16 bytes of float32, 8 of a 16-bit type
  const size_t esize = dtype == 0 ? 4 : 2;
  const bool vec = W % 4 == 0 && mxtt::aligned(a, 4 * (int)esize) &&
                   mxtt::aligned(b, 4 * (int)esize);
  const RbPlan pl = rb_plan(D2, ng, s2, vec, esize);
  // the general instance: the largest window of any group sets the
  // stride and shared memory
  const int n_groups = (DD + kAcc - 1) / kAcc;
  int window = 0;
  if (!pl.ok) {
    for (int g = 0; g < n_groups; ++g) {
      const Window w(g * kAcc, (g + 1) * kAcc <= DD ? kAcc : DD - g * kAcc,
                     D2, s2);
      window = window > w.rows * w.cols ? window : w.rows * w.cols;
    }
  }
  const bool fast = window <= kFastStride;
  const size_t bytes =
      pl.ok ? pl.bytes
            : 2 * esize * kChunk *
                  (kThreads + (size_t)(fast ? kFastStride : window));
  const long long gz = (long long)N * (pl.ok ? pl.n_igroups : n_groups);
  if (gz > 65535 || gy > 65535 || bytes > (size_t)kMaxSmem)
    return cudaErrorInvalidValue;
  const cudaError_t err = use_device();
  if (err != cudaSuccess) return err;
  const dim3 grid(gx, gy, (unsigned)gz);
  if (dtype == 1)
    return launch_dtype<__half>(a, b, out, C, H, W, D2, ng, s2, is_multiply,
                                pl, n_groups, fast, vec, grid, bytes, device,
                                st);
  if (dtype == 2)
    return launch_dtype<__nv_bfloat16>(a, b, out, C, H, W, D2, ng, s2,
                                       is_multiply, pl, n_groups, fast, vec,
                                       grid, bytes, device, st);
  return launch_dtype<float>(a, b, out, C, H, W, D2, ng, s2, is_multiply, pl,
                             n_groups, fast, vec, grid, bytes, device, st);
}

extern "C" const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
