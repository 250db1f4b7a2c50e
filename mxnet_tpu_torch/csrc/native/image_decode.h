// JPEG decode/encode + bilinear resize for the native IO pipeline.
// Reference analogue: the OpenCV imdecode/resize calls inside
// src/io/image_aug_default.cc and tools/im2rec.cc; here libjpeg + a small
// bilinear kernel, no OpenCV dependency.  The library is built with
// -DMXTT_HAVE_JPEG -ljpeg where jpeglib.h is found; without it the JPEG
// functions return false and JpegAvailable() says why.
#ifndef MXTPU_IMAGE_DECODE_H_
#define MXTPU_IMAGE_DECODE_H_

#include <cstdint>
#include <cstddef>
#include <vector>

namespace mxtpu {

// True when this build links libjpeg (MXTT_HAVE_JPEG).
bool JpegAvailable();

// True when buf starts with the JPEG SOI marker.
bool IsJPEG(const uint8_t* buf, size_t len);

// Decode a JPEG into packed RGB (HWC, 8-bit).  Returns false on corrupt
// input (libjpeg errors are trapped, never exit()).
bool DecodeJPEG(const uint8_t* buf, size_t len, std::vector<uint8_t>* rgb,
                int* h, int* w);

// Encode packed RGB (HWC, 8-bit) to JPEG at the given quality (1-100).
bool EncodeJPEG(const uint8_t* rgb, int h, int w, int quality,
                std::vector<uint8_t>* out);

// Bilinear resize of packed RGB (HWC) to (oh, ow).
void ResizeBilinear(const uint8_t* src, int h, int w, uint8_t* dst, int oh,
                    int ow, int channels = 3);

// Shorter-edge resize: scale so min(h, w) == target, preserving aspect.
// No-op (copy-free, returns false) when already at target.
bool ResizeShorterEdge(const std::vector<uint8_t>& src, int h, int w,
                       int target, std::vector<uint8_t>* dst, int* oh,
                       int* ow);

}  // namespace mxtpu

#endif  // MXTPU_IMAGE_DECODE_H_
