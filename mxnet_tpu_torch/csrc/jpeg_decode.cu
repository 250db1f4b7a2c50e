// The decode of the JPEG records route on the card (feed/staging.py
// JpegDeviceRoute): nvjpeg decodes each JPEG of a batch to its components,
// Y and, for a colour JPEG, Cb and Cr at their sampled sizes
// (NVJPEG_OUTPUT_YUV; NVJPEG_OUTPUT_Y for a grayscale one), and
// jpeg_color_kernel upsamples the chroma and converts to HWC RGB as libjpeg
// does, which the host loader decodes with (csrc/native/image_decode.cc
// DecodeJPEG: JCS_RGB, libjpeg's defaults).  image_augment.cu takes the RGB
// from there.
//
// nvjpeg stands where libjpeg stands in the host loader (the card's machine
// has no libjpeg): a library, no hand kernel, and it replaces no TPU kernel.
// Its own RGB output (NVJPEG_OUTPUT_RGBI) upsamples the chroma otherwise
// than libjpeg's "fancy" triangle filter, and on the repository's fixtures
// it lies further from libjpeg's pixels than the route's gate allows
// (PERF.md gives the numbers).
// So the upsampling and the colour conversion are done here, in libjpeg's
// integer arithmetic, and only nvjpeg's IDCT stays apart from libjpeg's.
//
// jpeg_color_kernel replaces no TPU kernel either: the JAX package decodes
// on the host with libjpeg (src/image_decode.cc).  One thread per pixel of
// one image (blockIdx.y), all in integers, as libjpeg-turbo's jdsample.c
// and jdcolor.c compute them:
//   * 4:2:0 (h2v2_fancy_upsample): colsum(j) = 3 * C[r][j] + C[r'][j], r =
//     y / 2, r' the chroma row above (y even) or below (y odd), clamped to
//     the plane; x even: (3 * colsum(j) + colsum(j - 1) + 8) >> 4, x odd:
//     (3 * colsum(j) + colsum(j + 1) + 7) >> 4, j = x / 2 and its
//     neighbours clamped to the plane;
//   * 4:2:2 (h2v1_fancy_upsample): x even (3 * C[j] + C[j - 1] + 1) >> 2,
//     x odd (3 * C[j] + C[j + 1] + 2) >> 2;
//   * chroma planes at most 2 wide: plain replication (libjpeg's
//     h2v1_upsample/h2v2_upsample); 4:4:4: the chroma as it is;
//   * ycc_rgb_convert with SCALEBITS 16: R = Y + ((91881 * Cr' + 32768) >>
//     16), G = Y + ((-22554 * Cb' + 32768 - 46802 * Cr') >> 16), B = Y +
//     ((116130 * Cb' + 32768) >> 16), Cb' = Cb - 128, Cr' = Cr - 128, each
//     clamped to 0..255; a grayscale JPEG's Y in all three.
// Other samplings (4:4:0, 4:1:1, ...) are refused with the record named.
//
// What bounds it: bytes.  It reads the components (Y and two quarter-size
// chroma planes at 4:2:0) and writes 3 bytes a pixel: about 49 MB for a
// batch of 128 of the fixtures' sizes, 0.015 ms at 3.35 TB/s; some 30
// integer operations a pixel are far below the card's rate.  One thread a
// pixel, neighbouring threads on neighbouring pixels.
#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// a row of a decode job (ops/cuda_kernels.py JPEG_JOB_FIELDS): the JPEG's
// offset and length in the payload, its slot in the planes and in the RGB
// output (3 * h * w bytes each), its planned size, whether it was read
enum JobField {
  kJobPayloadOffset, kJobPayloadLength, kJobSlot, kJobH, kJobW, kJobOk,
  kJobFields
};

// a row of jpeg_color's geometry (ops/cuda_kernels.py COLOR_FIELDS): the
// image's slot, its size, its chroma planes' size, its sampling (kind)
enum ColorField {
  kColSlot, kColH, kColW, kColCw, kColCh, kColKind, kColFields
};

// ColorField kind (native_io.JPEG_SAMPLINGS); -1: no image
enum Sampling { kGray = 0, k444 = 1, k422 = 2, k420 = 3 };

__device__ __forceinline__ int clamp255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

// The upsampled chroma value at (y, x) of a (ch x cw) plane.
__device__ __forceinline__ int chroma_at(const uint8_t* __restrict__ c,
                                         int cw, int ch, int kind, int y,
                                         int x) {
  if (kind == k444) return c[static_cast<size_t>(y) * cw + x];
  const int j = x >> 1;
  const int r = kind == k420 ? y >> 1 : y;
  if (cw <= 2) return c[static_cast<size_t>(r) * cw + j];
  const int jn = (x & 1) ? (j + 1 < cw ? j + 1 : j) : (j > 0 ? j - 1 : 0);
  if (kind == k422) {
    const uint8_t* row = c + static_cast<size_t>(r) * cw;
    return (x & 1) ? (3 * row[j] + row[jn] + 2) >> 2
                   : (3 * row[j] + row[jn] + 1) >> 2;
  }
  const int r2 = (y & 1) ? (r + 1 < ch ? r + 1 : r) : (r > 0 ? r - 1 : 0);
  const uint8_t* row = c + static_cast<size_t>(r) * cw;
  const uint8_t* near = c + static_cast<size_t>(r2) * cw;
  const int here = 3 * row[j] + near[j];
  const int next = 3 * row[jn] + near[jn];
  return (x & 1) ? (3 * here + next + 7) >> 4 : (3 * here + next + 8) >> 4;
}

__global__ void __launch_bounds__(kThreads) jpeg_color_kernel(
    const uint8_t* __restrict__ planes, const long long* __restrict__ geom,
    uint8_t* __restrict__ rgb) {
  const long long* g = geom + static_cast<size_t>(blockIdx.y) * kColFields;
  const int kind = static_cast<int>(g[kColKind]);
  const int h = static_cast<int>(g[kColH]), w = static_cast<int>(g[kColW]);
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (kind < 0 || p >= h * w) return;
  const uint8_t* img = planes + g[kColSlot];
  uint8_t* out = rgb + g[kColSlot] + static_cast<size_t>(p) * 3;
  const int Y = img[p];
  if (kind == kGray) {
    out[0] = out[1] = out[2] = static_cast<uint8_t>(Y);
    return;
  }
  const int cw = static_cast<int>(g[kColCw]);
  const int ch = static_cast<int>(g[kColCh]);
  const uint8_t* cb_plane = img + static_cast<size_t>(h) * w;
  const uint8_t* cr_plane = cb_plane + static_cast<size_t>(cw) * ch;
  const int y = p / w, x = p - y * w;
  const int cb = chroma_at(cb_plane, cw, ch, kind, y, x) - 128;
  const int cr = chroma_at(cr_plane, cw, ch, kind, y, x) - 128;
  out[0] = static_cast<uint8_t>(clamp255(Y + ((91881 * cr + 32768) >> 16)));
  out[1] = static_cast<uint8_t>(
      clamp255(Y + ((-22554 * cb + 32768 - 46802 * cr) >> 16)));
  out[2] = static_cast<uint8_t>(clamp255(Y + ((116130 * cb + 32768) >> 16)));
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

// One decode context: nvjpeg's handle on the default backend and one
// nvjpegJpegState, for one decode stream.
struct JpegContext {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  int device = 0;
};

}  // namespace

// rgb (HWC, 3 bytes a pixel, at each image's slot) from the components at
// the same slots of planes, for n images of a (n, kColFields) int64
// geometry; max_pixels bounds h * w.  Returns a cudaError_t.
extern "C" int mxtt_jpeg_color(const void* planes, const void* geom,
                               void* rgb, int n, int max_pixels, int device,
                               void* stream) {
  if (n <= 0 || n > 65535 || max_pixels <= 0 || device < 0)
    return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((max_pixels + kThreads - 1) / kThreads, n);
  jpeg_color_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes),
      static_cast<const long long*>(geom), static_cast<uint8_t*>(rgb));
  return cudaGetLastError();
}

extern "C" const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// nvjpeg's version (nvjpegGetProperty): major * 10000 + minor * 100 +
// patch, or -1.
extern "C" int mxtt_nvjpeg_version() {
  int major = -1, minor = -1, patch = -1;
  if (nvjpegGetProperty(MAJOR_VERSION, &major) != NVJPEG_STATUS_SUCCESS ||
      nvjpegGetProperty(MINOR_VERSION, &minor) != NVJPEG_STATUS_SUCCESS ||
      nvjpegGetProperty(PATCH_LEVEL, &patch) != NVJPEG_STATUS_SUCCESS)
    return -1;
  return major * 10000 + minor * 100 + patch;
}

// A decode context on device: nvjpegCreateEx on the default backend with
// nvjpeg's own allocators, and one JPEG state.  Returns an nvjpegStatus_t;
// *ctx is set on success.
extern "C" int mxtt_jpeg_create(int device, void** ctx) {
  if (use_device(device) != cudaSuccess) return NVJPEG_STATUS_EXECUTION_FAILED;
  auto* c = new JpegContext;
  c->device = device;
  nvjpegStatus_t st = nvjpegCreateEx(NVJPEG_BACKEND_DEFAULT, nullptr, nullptr,
                                     0, &c->handle);
  if (st == NVJPEG_STATUS_SUCCESS)
    st = nvjpegJpegStateCreate(c->handle, &c->state);
  if (st != NVJPEG_STATUS_SUCCESS) {
    if (c->handle) nvjpegDestroy(c->handle);
    delete c;
    return st;
  }
  *ctx = c;
  return NVJPEG_STATUS_SUCCESS;
}

extern "C" void mxtt_jpeg_destroy(void* ctx) {
  auto* c = static_cast<JpegContext*>(ctx);
  if (c == nullptr) return;
  use_device(c->device);
  if (c->state) nvjpegJpegStateDestroy(c->state);
  if (c->handle) nvjpegDestroy(c->handle);
  delete c;
}

// Decode n JPEGs, each from payload (host memory, pinned by the caller) at
// its job row's offset and length, to its components at planes + its slot,
// on stream: Y (h x w), then for a colour JPEG Cb and Cr at nvjpeg's chroma
// size (NVJPEG_OUTPUT_YUV; NVJPEG_OUTPUT_Y for a grayscale JPEG).  Each
// JPEG's size is checked against the job's first, so nvjpeg never writes
// past its slot.
//
// The stream is drained before the first image and after each one.
// nvjpegDecode's host phase refills buffers of the state that the previous
// image's transfer and IDCT, queued on the stream, may still read: on an
// H100 with a matrix-product load on another stream, back-to-back decodes
// gave garbage from some image of a batch on in every pass over 1,024
// records, and none once each image's work had completed before the next
// began.  The
// drain before the first image also keeps nvjpeg's writes after the work
// earlier on the stream (the previous batch's kernels, whose buffers the
// caching allocator may hand out again as planes).  color (n x
// kColFields, host) gets each image's row for mxtt_jpeg_color; a job with
// ok == 0 gets kind -1 and is skipped.  Returns an nvjpegStatus_t, -1 for
// a size that is not the job's, -2 for a sampling other than gray, 4:4:4,
// 4:2:2 and 4:2:0; *failed is the job that failed.
extern "C" int mxtt_jpeg_decode(void* ctx, const void* payload,
                                const void* jobs, int n, void* planes,
                                void* color, void* stream, int* failed) {
  auto* c = static_cast<JpegContext*>(ctx);
  const auto* src = static_cast<const unsigned char*>(payload);
  const auto* job = static_cast<const long long*>(jobs);
  auto* row = static_cast<long long*>(color);
  auto* dst = static_cast<unsigned char*>(planes);
  *failed = 0;
  const cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (use_device(c->device) != cudaSuccess ||
      cudaStreamSynchronize(strm) != cudaSuccess)
    return NVJPEG_STATUS_EXECUTION_FAILED;
  for (int i = 0; i < n; ++i, job += kJobFields, row += kColFields) {
    *failed = i;
    row[kColSlot] = job[kJobSlot];
    row[kColH] = job[kJobH];
    row[kColW] = job[kJobW];
    row[kColCw] = row[kColCh] = 0;
    row[kColKind] = -1;
    if (!job[kJobOk]) continue;
    const unsigned char* data = src + job[kJobPayloadOffset];
    const size_t length = static_cast<size_t>(job[kJobPayloadLength]);
    int comps = 0;
    nvjpegChromaSubsampling_t sub;
    int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
    nvjpegStatus_t st = nvjpegGetImageInfo(c->handle, data, length, &comps,
                                           &sub, widths, heights);
    if (st != NVJPEG_STATUS_SUCCESS) return st;
    if (heights[0] != job[kJobH] || widths[0] != job[kJobW]) return -1;
    int kind = -1;
    if (comps == 1 || sub == NVJPEG_CSS_GRAY) kind = kGray;
    else if (comps == 3 && sub == NVJPEG_CSS_444) kind = k444;
    else if (comps == 3 && sub == NVJPEG_CSS_422) kind = k422;
    else if (comps == 3 && sub == NVJPEG_CSS_420) kind = k420;
    if (kind < 0) return -2;
    const size_t hw = static_cast<size_t>(widths[0]) * heights[0];
    nvjpegImage_t img = {};
    img.channel[0] = dst + job[kJobSlot];
    img.pitch[0] = static_cast<size_t>(widths[0]);
    if (kind != kGray) {
      const size_t cwh = static_cast<size_t>(widths[1]) * heights[1];
      // the chroma planes must fit the slot's 3 * h * w bytes
      if (hw + 2 * cwh > 3 * hw || widths[2] != widths[1] ||
          heights[2] != heights[1])
        return -2;
      img.channel[1] = img.channel[0] + hw;
      img.channel[2] = img.channel[1] + cwh;
      img.pitch[1] = img.pitch[2] = static_cast<size_t>(widths[1]);
      row[kColCw] = widths[1];
      row[kColCh] = heights[1];
    }
    st = nvjpegDecode(c->handle, c->state, data, length,
                      kind == kGray ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV,
                      &img, strm);
    if (st != NVJPEG_STATUS_SUCCESS) return st;
    if (cudaStreamSynchronize(strm) != cudaSuccess)
      return NVJPEG_STATUS_EXECUTION_FAILED;
    row[kColKind] = kind;
  }
  *failed = -1;
  return NVJPEG_STATUS_SUCCESS;
}
