// FlowNet correlation for kernel_size 1, stride1 1 and pad = max displacement
// m (the reference's correlation.cu in that configuration):
//
//     out[n, i·D2 + j, y, x] = Σ_c a[n, c, y, x] · b[n, c, y + dy_i, x + dx_j] / C
//     (or Σ_c |a − b| / C when is_multiply is false)
//
// with ng = m / s2, D2 = 2·ng + 1, dy_i = (i − ng)·s2, dx_j = (j − ng)·s2 and
// b read as 0 outside the image (the zero padding of width m).  a, b are
// (N, C, H, W) and out (N, D2², H, W), all float32, all float16 or all
// bfloat16: each element converted to float32 as it is loaded, sums in
// float32, out rounded once to the operands' type (elem.cuh).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py:393
// (_correlation_kernel, launched by correlation at line 417).  There one
// grid step held a whole sample's a and zero-padded b in VMEM and unrolled
// the D2² displacements as static slices, which Mosaic needed; the wrapper
// padded b with a copy and declined D2² > 169 to bound the unroll.  Here b
// is read with a bounds check, no padded copy exists, and the displacement
// loop is data, not code, so any D2 runs (FlowNetC's 441 included).
//
// What bounds it.  Each output costs C multiply-adds (2·C flops) and each
// input pixel is used by D2² outputs, so at FlowNetC's stage (N 8, C 256,
// 48 x 64, D2² = 441) the work is 5.5 GFLOP over 94 MB: bound by float32
// arithmetic, near 0.083 ms on an H100 SXM at 67 TFLOP/s.  A shared-memory
// word feeds at most 4 of the SM's 128 float32 lanes a clock, so a design
// that reads one word per multiply-add runs at a quarter of that peak.
//
// Design: the register-blocked instance (stride2 1, and stride2 2 at W %
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
// The 16-bit instances fill the same float32 stages through registers
// (elem.cuh's stage_f32: 8-byte loads of 4 elements where the float32
// instance copies 16 bytes, with W % 4 == 0 and a and b 8-byte aligned;
// else one element a load), so all that follows the loads is the float32
// instance's code: a half instance's output is bitwise the float32
// instance's on the upcast inputs, rounded.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "elem.cuh"

namespace {

constexpr int kTH = 8;                           // tile rows: one per warp
constexpr int kTW = 32;                          // tile columns: one per lane
constexpr int kThreads = kTH * kTW;
constexpr int kAcc = 32;                         // displacements per block
constexpr int kChunk = 8;                        // channels per stage
constexpr int kFastStride = 1024;                // b window floats per channel
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

// 4- and 16-byte asynchronous copies global -> shared; `valid` false writes
// zeros and reads nothing.
__device__ __forceinline__ void cp_async4(float* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
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

// kStride: floats between one channel's b window and the next in a stage;
// a compile-time stride (kFastStride) turns every b read into a shared load
// at an immediate offset from one pointer per displacement.  0: the
// window's own size, for windows larger than kFastStride.
template <typename E, bool kMultiply, int kStride>
__global__ void __launch_bounds__(kThreads)
correlation_kernel(const E* __restrict__ a, const E* __restrict__ b,
                   E* __restrict__ out, int C, int H, int W, int D2,
                   int ng, int s2, int n_groups, bool vec) {
  extern __shared__ __align__(16) float smem[];
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
  const int stage_floats = kChunk * (kThreads + stride);

  // Copy channels c0 .. c0 + kChunk - 1 of the a tile and the b window into
  // `buf` with cp.async as one commit group (through registers for 16-bit
  // operands), zero outside the image and past channel C (a zero a and b
  // add nothing to either sum): 4 elements at a time when rows are aligned
  // (`vec`: W % 4 == 0, so an aligned group of 4 columns lies wholly
  // inside or outside), else 1.
  auto copy = [&](float* dst, const E* src, bool in, bool wide) {
    if constexpr (mxtt::is_f32<E>()) {
      if (wide)
        cp_async16(dst, src, in);
      else
        cp_async4(dst, src, in);
    } else {
      if (wide)
        mxtt::stage_f32<4>(dst, src, in);
      else
        mxtt::stage_f32<1>(dst, src, in);
    }
  };
  auto stage = [&](int c0, float* buf) {
    float* as = buf;
    float* bs = buf + kChunk * kThreads;
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
        float* bsc = bs + ci * stride;
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
    cp_async_commit();
  };

  // two stages: chunk k + 1 is in flight while chunk k is summed
  const int n_chunks = (C + kChunk - 1) / kChunk;
  stage(0, smem);
  for (int k = 0; k < n_chunks; ++k) {
    const float* as = smem + (k & 1) * stage_floats;
    const float* bs = as + kChunk * kThreads;
    if (k + 1 < n_chunks) {
      stage((k + 1) * kChunk, smem + ((k + 1) & 1) * stage_floats);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float av[kChunk];
#pragma unroll
    for (int ci = 0; ci < kChunk; ++ci) av[ci] = as[ci * kThreads + threadIdx.x];
    const float* bw = bs + ty * win.cols + tx + shift;
    // a group's spare slots repeat its last displacement and are never
    // stored, so no branch on nd splits the loads
#pragma unroll
    for (int kk = 0; kk < kAcc; ++kk) {
      const float* p = bw + koff[kk];
#pragma unroll
      for (int ci = 0; ci < kChunk; ++ci) {
        const float bv = p[ci * stride];
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
  extern __shared__ __align__(16) float smem[];
  const int n = blockIdx.z / n_igroups;
  const int i_first = (blockIdx.z % n_igroups) * ni;
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const int wy0 = y0 + (i_first - ng) * kS2;
  const int wx0 = (x0 - ng * kS2) & ~3;
  const int shift = x0 - ng * kS2 - wx0;          // 0 .. 3
  const int a_floats = kTH * ra;
  const int ch_floats = a_floats + wrows * rb;
  const int stage_floats = kChunkN * ch_floats;
  const ThreadMap t = rb_thread(threadIdx.x / 32, threadIdx.x % 32, D2, kS2,
                                kJ);

  const size_t plane = (size_t)H * W;
  const E* an = a + (size_t)n * C * plane;
  const E* bn = b + (size_t)n * C * plane;

  // Copy channels c0 .. c0 + kChunkN − 1 of the a tile and the b window
  // into `buf` as one commit group (through registers for 16-bit
  // operands), zero outside the image and past channel C (a zero a and b
  // add nothing to either sum): 4 elements a copy at stride2 2 (W % 4 == 0
  // puts an aligned group of 4 wholly inside or outside the image), 1 at
  // stride2 1.  Each group's addresses are worked out once and walk the
  // channels.
  auto stage = [&](int c0, float* buf) {
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
        dst = a_floats + (f / qb) * rb + (f % qb) * kWide;
        yy = wy0 + f / qb;
        xx = wx0 + (f % qb) * kWide;
        base = bn;
      }
      const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
      const E* src =
          base + (in ? (size_t)c0 * plane + (size_t)yy * W + xx : 0);
      float* to = buf + dst;
#pragma unroll
      for (int ci = 0; ci < kChunkN; ++ci) {
        const bool v = in && c0 + ci < C;
        if constexpr (!mxtt::is_f32<E>())
          mxtt::stage_f32<kWide>(to, v ? src : base, v);
        else if (kWide == 4)
          cp_async16(to, v ? src : base, v);
        else
          cp_async4(to, v ? src : base, v);
        src += plane;
        to += ch_floats;
      }
    }
    cp_async_commit();
  };

  float acc[kP][kJ];
#pragma unroll
  for (int p = 0; p < kP; ++p)
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[p][j] = 0.f;
  const int a_off = t.ty * ra + t.xoff;
  const int b_off = a_floats + (t.ty + t.il * kS2) * rb + shift + t.xoff +
                    t.j0 * kS2;

  // two stages: chunk k + 1 is in flight while chunk k is summed
  const int n_chunks = (C + kChunkN - 1) / kChunkN;
  stage(0, smem);
  for (int k = 0; k < n_chunks; ++k) {
    const float* s = smem + (k & 1) * stage_floats;
    if (k + 1 < n_chunks) {
      stage((k + 1) * kChunkN, smem + ((k + 1) & 1) * stage_floats);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll 2
    for (int ci = 0; ci < kChunkN; ++ci) {
      const float* sa = s + ci * ch_floats + a_off;
      const float* sb = s + ci * ch_floats + b_off;
      float av[kP];
#pragma unroll
      for (int p = 0; p < kP; ++p) av[p] = sa[p * kS2];
      // b column q serves pixel p and dx j0 + q − p: one b value live at
      // a time, so accumulators and a take the registers
#pragma unroll
      for (int q = 0; q < kP + kJ - 1; ++q) {
        const float bv = sb[q * kS2];
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

RbPlan rb_plan(int D2, int ng, int s2, bool vec) {
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
    pl.bytes = 2 * sizeof(float) * chunk *
               (size_t)(kTH * pl.ra + pl.wrows * pl.rb);
    if (pl.bytes <= (size_t)kMaxSmem) {
      pl.threads = 32 * pl.ni * runs;
      pl.ok = true;
      return pl;
    }
  }
  return pl;
}

// The instance for element type E: the register-blocked one where the
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
  const int gy = (H + kTH - 1) / kTH, gx = (W + kTW - 1) / kTW;
  // copies of 4 elements: 16 bytes of float32, 8 of a 16-bit type
  const int wide = dtype == 0 ? 16 : 8;
  const bool vec = W % 4 == 0 && mxtt::aligned(a, wide) &&
                   mxtt::aligned(b, wide);
  const RbPlan pl = rb_plan(D2, ng, s2, vec);
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
            : 2 * sizeof(float) * kChunk *
                  (kThreads + (size_t)(fast ? kFastStride : window));
  const long long gz = (long long)N * (pl.ok ? pl.n_igroups : n_groups);
  if (gz > 65535 || gy > 65535 || bytes > (size_t)kMaxSmem)
    return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return err;
  const dim3 grid(gx, gy, (unsigned)gz);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
