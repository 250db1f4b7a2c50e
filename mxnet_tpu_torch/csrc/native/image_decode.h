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

// Read a JPEG's frame header without decoding it, and without libjpeg:
// height, width and component count from its SOF0, SOF1 or SOF2 marker
// (baseline, extended sequential or progressive Huffman).  Returns
// kJpegOk, kJpegUnreadable (no frame header, a truncated segment, a zero
// side, a component count other than 1 or 3, which libjpeg's RGB output
// refuses too) or kJpegOtherProcess (a frame of another coding process:
// lossless, arithmetic or hierarchical).
enum JpegHeader { kJpegOk = 0, kJpegUnreadable = 1, kJpegOtherProcess = 2 };
int JpegDims(const uint8_t* buf, size_t len, int* h, int* w, int* comps);

// Decode a JPEG into packed RGB (HWC, 8-bit).  Returns false on corrupt
// input (libjpeg errors are trapped, never exit()).
bool DecodeJPEG(const uint8_t* buf, size_t len, std::vector<uint8_t>* rgb,
                int* h, int* w);

// A JPEG's components as its entropy decode and IDCT leave them, before
// libjpeg's chroma upsampling and colour conversion: Y (h x w), then for a
// colour JPEG Cb and Cr (ch x cw each), packed in *planes.  *kind is
// kJpegGray, kJpeg444, kJpeg422 (chroma halved across) or kJpeg420 (halved
// both ways).  Returns false on corrupt input or another sampling.  The
// card's route upsamples and converts these as libjpeg does
// (csrc/jpeg_decode.cu).
enum JpegSampling { kJpegGray = 0, kJpeg444 = 1, kJpeg422 = 2, kJpeg420 = 3 };
bool DecodeJPEGPlanes(const uint8_t* buf, size_t len,
                      std::vector<uint8_t>* planes, int* h, int* w, int* cw,
                      int* ch, int* kind);

// Encode packed RGB (HWC, 8-bit) to JPEG at the given quality (1-100).
bool EncodeJPEG(const uint8_t* rgb, int h, int w, int quality,
                std::vector<uint8_t>* out);

// Bilinear resize of packed RGB (HWC) to (oh, ow).
void ResizeBilinear(const uint8_t* src, int h, int w, uint8_t* dst, int oh,
                    int ow, int channels = 3);

// The size of a shorter-edge resize to target: min(oh, ow) == target, the
// other side scaled in integers, preserving aspect.  Returns false (no
// resize) when target <= 0 or the shorter edge is already target.
bool ShorterEdgeSize(int h, int w, int target, int* oh, int* ow);

// Shorter-edge resize: scale so min(h, w) == target, preserving aspect.
// No-op (copy-free, returns false) when already at target.
bool ResizeShorterEdge(const std::vector<uint8_t>& src, int h, int w,
                       int target, std::vector<uint8_t>* dst, int* oh,
                       int* ow);

}  // namespace mxtpu

#endif  // MXTPU_IMAGE_DECODE_H_
