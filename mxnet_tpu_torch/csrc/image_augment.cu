// The last step of the JPEG records route on the card (feed/staging.py
// JpegDeviceRoute): from a batch's decoded HWC RGB images
// (csrc/jpeg_decode.cu: nvjpeg, then jpeg_color_kernel), image_augment_kernel
// writes the (B, 3, H, W) float32 batch the host loader would have written
// (csrc/native/data_loader.cc Emit).
//
// It replaces no TPU kernel.  No Pallas kernel decodes or augments images:
// the JAX package does this on the host, in its native loader
// (src/data_loader.cc, src/image_decode.cc's resize), and so does the
// port's loader where it iterates on the host.
//
// image_augment_kernel: one thread per output element (b, c, y, x).  The
// thread reads its image's row of the per-batch geometry (kAug* below: the
// image's offset in the decoded bytes, whether the record was read, the
// decoded size, the size after the shorter-edge resize, the crop's offset
// and the mirror bit), then the resized image's value at (dy + y, mirror ?
// dx + W-1-x : dx + x) as image_decode.cc ResizeBilinear computes it:
// half-pixel centres, fy clamped at 0, y0 at h - 1, y1 = y0 + 1 or y0, the
// four products summed in the host's order, uint8(v + 0.5f) by truncation.
// Where the resize is a no-op it reads the decoded pixel itself.  Then
// (float(u8) - mean[c]) * scale, as Emit does, and a record that could not
// be read gives zeros.  Every operation is an IEEE-rounded float operation
// in the host expression's order (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn; the source is also compiled with --fmad=false), so the batch
// is bitwise the host loader's arithmetic on the same decoded pixels.  The
// host builds with g++ -O3 for x86-64 without -march, which has no FMA to
// contract into.
//
// What bounds it: bytes.  It writes the float32 batch (77.07 MB at batch
// 128 x 3 x 224 x 224) and reads the decoded pixels it samples (each byte
// of a resized crop's source region once at least); at 3.35 TB/s that is
// about 0.03 ms.  It does ~20 float operations an element, 0.4 GFLOP, far
// below the float32 rate.  The design does the simple thing: one pass,
// coalesced stores (neighbouring threads write neighbouring x), gathers
// that mostly hit L1/L2 (neighbouring x read neighbouring source pixels).
// It is CUDA C++ and not Triton because each image is a ragged gather
// through its own pointer and geometry.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// a row of the per-batch geometry (ops/cuda_kernels.py AUG_FIELDS)
enum AugField {
  kAugOffset, kAugOk, kAugSrcH, kAugSrcW, kAugResH, kAugResW, kAugDy, kAugDx,
  kAugMirror, kAugFields
};

// The value of the shorter-edge-resized (oh x ow) image at (y, x), channel
// c, from the decoded (h x w) HWC image: image_decode.cc ResizeBilinear.
__device__ __forceinline__ unsigned int resized_at(
    const uint8_t* __restrict__ src, int h, int w, int oh, int ow, int y,
    int x, int c) {
  const float sy = __fdiv_rn(static_cast<float>(h), static_cast<float>(oh));
  const float sx = __fdiv_rn(static_cast<float>(w), static_cast<float>(ow));
  float fy = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(y), 0.5f), sy),
                       0.5f);
  if (fy < 0) fy = 0;
  int y0 = __float2int_rz(fy);
  if (y0 > h - 1) y0 = h - 1;
  const int y1 = y0 + 1 < h ? y0 + 1 : y0;
  const float wy = __fsub_rn(fy, static_cast<float>(y0));
  float fx = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(x), 0.5f), sx),
                       0.5f);
  if (fx < 0) fx = 0;
  int x0 = __float2int_rz(fx);
  if (x0 > w - 1) x0 = w - 1;
  const int x1 = x0 + 1 < w ? x0 + 1 : x0;
  const float wx = __fsub_rn(fx, static_cast<float>(x0));
  const float v00 = src[(static_cast<size_t>(y0) * w + x0) * 3 + c];
  const float v01 = src[(static_cast<size_t>(y0) * w + x1) * 3 + c];
  const float v10 = src[(static_cast<size_t>(y1) * w + x0) * 3 + c];
  const float v11 = src[(static_cast<size_t>(y1) * w + x1) * 3 + c];
  const float ay = __fsub_rn(1.0f, wy), ax = __fsub_rn(1.0f, wx);
  // v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx + v10 * wy * (1 - wx)
  //   + v11 * wy * wx, left to right
  float v = __fmul_rn(__fmul_rn(v00, ay), ax);
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(v01, ay), wx));
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(v10, wy), ax));
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(v11, wy), wx));
  return __float2uint_rz(__fadd_rn(v, 0.5f)) & 0xFFu;
}

__global__ void __launch_bounds__(kThreads) image_augment_kernel(
    const uint8_t* __restrict__ pixels, const long long* __restrict__ geom,
    float* __restrict__ out, int B, int H, int W, float mean0, float mean1,
    float mean2, float scale) {
  const long long total = static_cast<long long>(B) * 3 * H * W;
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int x = static_cast<int>(i % W);
  long long t = i / W;
  const int y = static_cast<int>(t % H);
  t /= H;
  const int c = static_cast<int>(t % 3);
  const int b = static_cast<int>(t / 3);
  const long long* g = geom + static_cast<size_t>(b) * kAugFields;
  if (!g[kAugOk]) {
    out[i] = 0.0f;
    return;
  }
  const int h = static_cast<int>(g[kAugSrcH]);
  const int w = static_cast<int>(g[kAugSrcW]);
  const int rh = static_cast<int>(g[kAugResH]);
  const int rw = static_cast<int>(g[kAugResW]);
  const int sy = static_cast<int>(g[kAugDy]) + y;
  const int sx = static_cast<int>(g[kAugDx]) + (g[kAugMirror] ? W - 1 - x : x);
  const uint8_t* img = pixels + g[kAugOffset];
  const unsigned int u =
      (rh == h && rw == w)
          ? img[(static_cast<size_t>(sy) * w + sx) * 3 + c]
          : resized_at(img, h, w, rh, rw, sy, sx, c);
  const float mean = c == 0 ? mean0 : (c == 1 ? mean1 : mean2);
  out[i] = __fmul_rn(__fsub_rn(static_cast<float>(u), mean), scale);
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

// out (B, 3, H, W) float32 from the decoded pixels and a (B, kAugFields)
// int64 geometry, both on the card.  Returns a cudaError_t.
extern "C" int mxtt_image_augment(const void* pixels, const void* geom,
                                  void* out, int B, int H, int W, float mean0,
                                  float mean1, float mean2, float scale,
                                  int device, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || device < 0) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(B) * 3 * H * W;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  image_augment_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pixels),
      static_cast<const long long*>(geom), static_cast<float*>(out), B, H, W,
      mean0, mean1, mean2, scale);
  return cudaGetLastError();
}

extern "C" const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
