// FlowNet correlation for kernel_size 1, stride1 1 and pad = max displacement
// m (the reference's correlation.cu in that configuration):
//
//     out[n, i·D2 + j, y, x] = Σ_c a[n, c, y, x] · b[n, c, y + dy_i, x + dx_j] / C
//     (or Σ_c |a − b| / C when is_multiply is false)
//
// with ng = m / s2, D2 = 2·ng + 1, dy_i = (i − ng)·s2, dx_j = (j − ng)·s2 and
// b read as 0 outside the image (the zero padding of width m).  a, b are
// (N, C, H, W) float32; out is (N, D2², H, W) float32.
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
// arithmetic, near 0.083 ms on an H100 SXM at 67 TFLOP/s.
//
// Design.  A block is 8 warps over an 8 x 32 tile of output pixels (warp =
// row, lane = column) and a group of kAcc = 32 consecutive displacements
// (flattened i·D2 + j), one float32 accumulator per displacement in each
// thread's registers.  It walks the channels in chunks of 8: for each chunk
// it stages the a tile and the window of b that the group's displacements
// reach (the tile widened by (D2 − 1)·s2 columns and by s2 rows for each
// further displacement row the group spans) in shared memory, zero outside
// the image and past C, with cp.async (16 bytes at a time when W % 4 == 0)
// into two stages, so the next chunk's copies are in flight while the
// current one is summed.  Each thread reads its 8 a values once, then for
// each displacement one pointer (its offset fixed per block, held in a
// register) and 8 b values at compile-time offsets from it: the channel
// stride of a staged window is the constant kFastStride whenever the window
// fits (FlowNetC's and PWC-Net's do), so a b read costs one shared load and
// no address arithmetic.  Lanes read consecutive addresses: no bank
// conflicts.  Sums run over the channels in order and divide by C at the
// end, as _correlation_kernel does.  Each multiply-add still takes one
// shared-memory read, so shared-memory bandwidth holds it near a quarter of
// the float32 peak; blocking several pixels per thread over x, to reuse b
// values across displacements in registers, is left to later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTH = 8;                           // tile rows: one per warp
constexpr int kTW = 32;                          // tile columns: one per lane
constexpr int kThreads = kTH * kTW;
constexpr int kAcc = 32;                         // displacements per block
constexpr int kChunk = 8;                        // channels per stage
constexpr int kFastStride = 1024;                // b window floats per channel
constexpr int kMaxSmem = 227 * 1024;             // a block's opt-in limit
constexpr int kMaxDevices = 64;

// 4- and 16-byte asynchronous copies global -> shared; `valid` false writes
// zeros and reads nothing.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
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
template <bool kMultiply, int kStride>
__global__ void __launch_bounds__(kThreads)
correlation_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ out, int C, int H, int W, int D2,
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
  const float* an = a + (size_t)n * C * plane;
  const float* bn = b + (size_t)n * C * plane;
  const int stage_floats = kChunk * (kThreads + stride);

  // Copy channels c0 .. c0 + kChunk - 1 of the a tile and the b window into
  // `buf` with cp.async as one commit group, zero outside the image and
  // past channel C (a zero a and b add nothing to either sum): 16 bytes at
  // a time when rows are 16-byte aligned (`vec`: W % 4 == 0, so an aligned
  // group of 4 columns lies wholly inside or outside), else 4.
  auto stage = [&](int c0, float* buf) {
    float* as = buf;
    float* bs = buf + kChunk * kThreads;
    if (vec) {
      constexpr int kQ = kTW / 4;                  // float4s per tile row
      for (int i = threadIdx.x; i < kChunk * kTH * kQ; i += kThreads) {
        const int ci = i / (kTH * kQ), p = i % (kTH * kQ);
        const int yy = y0 + p / kQ, xx = x0 + (p % kQ) * 4;
        const bool in = c0 + ci < C && yy < H && xx < W;
        cp_async16(as + ci * kThreads + p * 4,
                   in ? an + (size_t)(c0 + ci) * plane + (size_t)yy * W + xx
                      : an, in);
      }
      const int q = win.cols / 4, per = win.rows * q;
      for (int i = threadIdx.x; i < kChunk * per; i += kThreads) {
        const int ci = i / per, p = i % per;
        const int r = p / q, col = (p % q) * 4;
        const int yy = wy0 + r, xx = wx0 + col;
        const bool in = c0 + ci < C && yy >= 0 && yy < H && xx >= 0 && xx < W;
        cp_async16(bs + ci * stride + r * win.cols + col,
                   in ? bn + (size_t)(c0 + ci) * plane + (size_t)yy * W + xx
                      : bn, in);
      }
    } else {
      for (int ci = 0; ci < kChunk; ++ci) {      // rows by warp, cols by lane
        const bool c_in = c0 + ci < C;
        const float* ac = an + (size_t)(c_in ? c0 + ci : 0) * plane;
        const float* bc = bn + (size_t)(c_in ? c0 + ci : 0) * plane;
        {
          const int yy = y0 + ty, xx = x0 + tx;
          const bool in = c_in && yy < H && xx < W;
          cp_async4(as + ci * kThreads + threadIdx.x,
                    in ? ac + (size_t)yy * W + xx : ac, in);
        }
        float* bsc = bs + ci * stride;
        for (int r = ty; r < win.rows; r += kTH) {
          const int yy = wy0 + r;
          const bool row_in = c_in && yy >= 0 && yy < H;
          for (int col = tx; col < win.cols; col += kTW) {
            const int xx = wx0 + col;
            const bool in = row_in && xx >= 0 && xx < W;
            cp_async4(bsc + r * win.cols + col,
                      in ? bc + (size_t)yy * W + xx : bc, in);
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
    float* o = out + ((size_t)n * DD + d0) * plane + (size_t)y * W + x;
#pragma unroll
    for (int kk = 0; kk < kAcc; ++kk)
      if (kk < nd) o[(size_t)kk * plane] = acc[kk] / norm;
  }
}

template <bool kMultiply, int kStride>
cudaError_t launch(const float* a, const float* b, float* out, int C, int H,
                   int W, int D2, int ng, int s2, int n_groups, bool vec,
                   dim3 grid, size_t bytes, int device, cudaStream_t stream) {
  auto kernel = correlation_kernel<kMultiply, kStride>;
  // the largest dynamic shared memory opted into so far, per device
  static int opted[kMaxDevices];
  if (bytes > 48 * 1024 && (int)bytes > opted[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    opted[device] = (int)bytes;
  }
  kernel<<<grid, kThreads, bytes, stream>>>(a, b, out, C, H, W, D2, ng, s2,
                                            n_groups, vec);
  return cudaGetLastError();
}

}  // namespace

// a, b (N, C, H, W), out (N, D2², H, W) with D2 = 2·(m / s2) + 1: float32,
// contiguous.  Returns a cudaError_t: the launch's configuration error (or
// cudaErrorInvalidValue for a shape the grid or shared memory cannot hold),
// if any.  Faults during the run surface at the caller's next
// synchronisation.
extern "C" int mxtt_correlation(const void* a, const void* b, void* out,
                                int N, int C, int H, int W, int m, int s2,
                                int is_multiply, int device, void* stream) {
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || m < 0 || s2 <= 0 ||
      device < 0 || device >= kMaxDevices)
    return cudaErrorInvalidValue;
  const int ng = m / s2, D2 = 2 * ng + 1, DD = D2 * D2;
  const int n_groups = (DD + kAcc - 1) / kAcc;
  const long long gz = (long long)N * n_groups;
  const int gy = (H + kTH - 1) / kTH, gx = (W + kTW - 1) / kTW;
  if (gz > 65535 || gy > 65535) return cudaErrorInvalidValue;
  // the largest window of any group sets the stride and shared memory
  int window = 0;
  for (int g = 0; g < n_groups; ++g) {
    const Window w(g * kAcc, (g + 1) * kAcc <= DD ? kAcc : DD - g * kAcc, D2,
                   s2);
    window = window > w.rows * w.cols ? window : w.rows * w.cols;
  }
  const bool fast = window <= kFastStride;
  const size_t bytes = 2 * sizeof(float) * kChunk *
                       (kThreads + (size_t)(fast ? kFastStride : window));
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return err;
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const dim3 grid(gx, gy, (unsigned)gz);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* o = static_cast<float*>(out);
#define CORR_LAUNCH(MUL, STRIDE)                                            \
  return launch<MUL, STRIDE>(af, bf, o, C, H, W, D2, ng, s2, n_groups, vec, \
                             grid, bytes, device, st)
  if (is_multiply) {
    if (fast) CORR_LAUNCH(true, kFastStride);
    CORR_LAUNCH(true, 0);
  }
  if (fast) CORR_LAUNCH(false, kFastStride);
  CORR_LAUNCH(false, 0);
#undef CORR_LAUNCH
}

extern "C" const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
