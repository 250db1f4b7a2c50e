#include "image_decode.h"

#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#ifdef MXTT_HAVE_JPEG
#include <jpeglib.h>
#endif

namespace mxtpu {

bool IsJPEG(const uint8_t* buf, size_t len) {
  return len >= 3 && buf[0] == 0xFF && buf[1] == 0xD8 && buf[2] == 0xFF;
}

#ifdef MXTT_HAVE_JPEG
bool JpegAvailable() { return true; }

namespace {

// libjpeg's default error handler exit()s the process; trap into longjmp
// so a corrupt record becomes a recoverable false (the reference's OpenCV
// imdecode likewise returns an empty Mat).
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

void JpegErrExit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

}  // namespace

bool DecodeJPEG(const uint8_t* buf, size_t len, std::vector<uint8_t>* rgb,
                int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = JpegErrExit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  const size_t stride = cinfo.output_width * 3;
  rgb->resize(static_cast<size_t>(*h) * stride);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb->data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool EncodeJPEG(const uint8_t* rgb, int h, int w, int quality,
                std::vector<uint8_t>* out) {
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = JpegErrExit;
  // volatile: mutated between setjmp and longjmp, then read in the
  // handler — a register-cached copy would be indeterminate there
  unsigned char* volatile mem = nullptr;
  unsigned long mem_size = 0;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_compress(&cinfo);
    if (mem) free(mem);
    return false;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, const_cast<unsigned char**>(&mem), &mem_size);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  const size_t stride = static_cast<size_t>(w) * 3;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(rgb + cinfo.next_scanline * stride);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  out->assign(mem, mem + mem_size);
  free(mem);
  return true;
}

#else  // built without libjpeg: every JPEG call fails, the caller says why
bool JpegAvailable() { return false; }

bool DecodeJPEG(const uint8_t*, size_t, std::vector<uint8_t>*, int*, int*) {
  return false;
}

bool EncodeJPEG(const uint8_t*, int, int, int, std::vector<uint8_t>*) {
  return false;
}
#endif  // MXTT_HAVE_JPEG

void ResizeBilinear(const uint8_t* src, int h, int w, uint8_t* dst, int oh,
                    int ow, int channels) {
  // half-pixel-center sampling, the cv::resize INTER_LINEAR convention the
  // reference inherits from OpenCV (image_aug_default.cc)
  const float sy = static_cast<float>(h) / oh;
  const float sx = static_cast<float>(w) / ow;
  for (int y = 0; y < oh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    if (y0 > h - 1) y0 = h - 1;
    int y1 = y0 + 1 < h ? y0 + 1 : y0;
    float wy = fy - y0;
    for (int x = 0; x < ow; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      if (x0 > w - 1) x0 = w - 1;
      int x1 = x0 + 1 < w ? x0 + 1 : x0;
      float wx = fx - x0;
      for (int c = 0; c < channels; ++c) {
        float v00 = src[(static_cast<size_t>(y0) * w + x0) * channels + c];
        float v01 = src[(static_cast<size_t>(y0) * w + x1) * channels + c];
        float v10 = src[(static_cast<size_t>(y1) * w + x0) * channels + c];
        float v11 = src[(static_cast<size_t>(y1) * w + x1) * channels + c];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        dst[(static_cast<size_t>(y) * ow + x) * channels + c] =
            static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

bool ResizeShorterEdge(const std::vector<uint8_t>& src, int h, int w,
                       int target, std::vector<uint8_t>* dst, int* oh,
                       int* ow) {
  int shorter = h < w ? h : w;
  if (target <= 0 || shorter == target) return false;
  if (h < w) {
    *oh = target;
    *ow = static_cast<int>(static_cast<int64_t>(w) * target / h);
  } else {
    *ow = target;
    *oh = static_cast<int>(static_cast<int64_t>(h) * target / w);
  }
  dst->resize(static_cast<size_t>(*oh) * (*ow) * 3);
  ResizeBilinear(src.data(), h, w, dst->data(), *oh, *ow, 3);
  return true;
}

}  // namespace mxtpu
