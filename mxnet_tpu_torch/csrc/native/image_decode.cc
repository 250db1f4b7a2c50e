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

int JpegDims(const uint8_t* buf, size_t len, int* h, int* w, int* comps) {
  if (!IsJPEG(buf, len)) return kJpegUnreadable;
  size_t i = 2;
  while (i < len) {
    if (buf[i] != 0xFF) return kJpegUnreadable;
    while (i < len && buf[i] == 0xFF) ++i;     // fill bytes
    if (i >= len) return kJpegUnreadable;
    const int marker = buf[i++];
    // markers without a segment: TEM, RST0..7, SOI
    if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD8)) continue;
    // the image data or its end before any frame header
    if (marker == 0xD9 || marker == 0xDA) return kJpegUnreadable;
    if (i + 2 > len) return kJpegUnreadable;
    const size_t seg = (static_cast<size_t>(buf[i]) << 8) | buf[i + 1];
    if (seg < 2 || i + seg > len) return kJpegUnreadable;
    // SOF0..SOF15 but DHT (C4), JPG (C8) and DAC (CC)
    if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 &&
        marker != 0xC8 && marker != 0xCC) {
      if (marker > 0xC2) return kJpegOtherProcess;
      if (seg < 8) return kJpegUnreadable;
      *h = (buf[i + 3] << 8) | buf[i + 4];
      *w = (buf[i + 5] << 8) | buf[i + 6];
      *comps = buf[i + 7];
      if (*h == 0 || *w == 0 || (*comps != 1 && *comps != 3))
        return kJpegUnreadable;
      return kJpegOk;
    }
    i += seg;
  }
  return kJpegUnreadable;
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

bool DecodeJPEGPlanes(const uint8_t* buf, size_t len,
                      std::vector<uint8_t>* planes, int* h, int* w, int* cw,
                      int* ch, int* kind) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = JpegErrExit;
  // component row buffers, freed on every exit
  std::vector<std::vector<uint8_t>> comp;
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
  const int n = cinfo.num_components;
  const jpeg_component_info* c = cinfo.comp_info;
  int k = -1;
  if (n == 1) {
    k = kJpegGray;
  } else if (n == 3 && c[1].h_samp_factor == 1 && c[1].v_samp_factor == 1 &&
             c[2].h_samp_factor == 1 && c[2].v_samp_factor == 1) {
    const int hs = c[0].h_samp_factor, vs = c[0].v_samp_factor;
    k = hs == 1 && vs == 1 ? kJpeg444 : hs == 2 && vs == 1 ? kJpeg422
        : hs == 2 && vs == 2 ? kJpeg420 : -1;
  }
  if (k < 0) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.raw_data_out = TRUE;
  jpeg_start_decompress(&cinfo);
  *h = static_cast<int>(cinfo.image_height);
  *w = static_cast<int>(cinfo.image_width);
  *kind = k;
  // a component's rows in iMCU-row steps of v_samp_factor * DCTSIZE, into
  // buffers a whole number of blocks wide and tall
  comp.resize(n);
  std::vector<std::vector<JSAMPROW>> rows(n);
  const int step = cinfo.max_v_samp_factor * DCTSIZE;
  for (int i = 0; i < n; ++i) {
    const size_t bw = c[i].width_in_blocks * DCTSIZE;
    const size_t bh = (c[i].height_in_blocks + c[i].v_samp_factor) * DCTSIZE;
    comp[i].resize(bw * bh);
  }
  JSAMPARRAY arrays[3];
  for (JDIMENSION done = 0; cinfo.output_scanline < cinfo.output_height;) {
    for (int i = 0; i < n; ++i) {
      const int lines = c[i].v_samp_factor * DCTSIZE;
      const size_t bw = c[i].width_in_blocks * DCTSIZE;
      const size_t first = static_cast<size_t>(done) * lines / step;
      rows[i].resize(lines);
      for (int r = 0; r < lines; ++r)
        rows[i][r] = comp[i].data() + (first + r) * bw;
      arrays[i] = rows[i].data();
    }
    const JDIMENSION got = jpeg_read_raw_data(&cinfo, arrays, step);
    if (got == 0) break;
    done += got;
  }
  // the component sizes live in memory jpeg_finish_decompress frees
  *cw = static_cast<int>(c[n - 1].downsampled_width);
  *ch = static_cast<int>(c[n - 1].downsampled_height);
  planes->clear();
  for (int i = 0; i < n; ++i) {
    const int pw = static_cast<int>(c[i].downsampled_width);
    const int ph = static_cast<int>(c[i].downsampled_height);
    const size_t bw = c[i].width_in_blocks * DCTSIZE;
    for (int r = 0; r < ph; ++r)
      planes->insert(planes->end(), comp[i].data() + r * bw,
                     comp[i].data() + r * bw + pw);
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

bool DecodeJPEGPlanes(const uint8_t*, size_t, std::vector<uint8_t>*, int*,
                      int*, int*, int*, int*) {
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

bool ShorterEdgeSize(int h, int w, int target, int* oh, int* ow) {
  int shorter = h < w ? h : w;
  if (target <= 0 || shorter == target) return false;
  if (h < w) {
    *oh = target;
    *ow = static_cast<int>(static_cast<int64_t>(w) * target / h);
  } else {
    *ow = target;
    *oh = static_cast<int>(static_cast<int64_t>(h) * target / w);
  }
  return true;
}

bool ResizeShorterEdge(const std::vector<uint8_t>& src, int h, int w,
                       int target, std::vector<uint8_t>* dst, int* oh,
                       int* ow) {
  if (!ShorterEdgeSize(h, w, target, oh, ow)) return false;
  dst->resize(static_cast<size_t>(*oh) * (*ow) * 3);
  ResizeBilinear(src.data(), h, w, dst->data(), *oh, *ow, 3);
  return true;
}

}  // namespace mxtpu
