// im2rec: pack an image list into a RecordIO file
// (reference tools/im2rec.cc capability, including --resize/--quality).
//
// Input list format (same as reference): image_index \t label \t path
// JPEG inputs can be re-encoded at pack time: --resize N scales the shorter
// edge to N (bilinear, libjpeg round trip) and --quality Q sets the encoder
// quality, so .rec files carry training-resolution images instead of paying
// decode-size cost on every epoch (reference tools/im2rec.cc resize= and
// quality= options via OpenCV).  Non-JPEG payloads pass through verbatim.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

#include "image_decode.h"
#include "recordio.h"

int main(int argc, char** argv) {
  int resize = 0;
  int quality = 95;
  std::vector<std::string> pos;
  for (int i = 1; i < argc; ++i) {
    if (strncmp(argv[i], "--resize=", 9) == 0) {
      resize = atoi(argv[i] + 9);
    } else if (strncmp(argv[i], "--quality=", 10) == 0) {
      quality = atoi(argv[i] + 10);
    } else if (strcmp(argv[i], "--resize") == 0 && i + 1 < argc) {
      resize = atoi(argv[++i]);
    } else if (strcmp(argv[i], "--quality") == 0 && i + 1 < argc) {
      quality = atoi(argv[++i]);
    } else {
      pos.push_back(argv[i]);
    }
  }
  if (pos.size() < 2) {
    fprintf(stderr,
            "Usage: im2rec [--resize N] [--quality Q] image.lst image_root "
            "output.rec\n"
            "  image.lst lines: index\\tlabel\\trelative_path\n"
            "  --resize N   re-encode JPEGs with shorter edge scaled to N\n"
            "  --quality Q  JPEG re-encode quality (default 95)\n");
    return 1;
  }
  std::string lst_path = pos[0];
  std::string root = pos.size() >= 3 ? pos[1] : "";
  std::string out_path = pos.size() >= 3 ? pos[2] : pos[1];

  std::ifstream lst(lst_path);
  if (!lst) {
    fprintf(stderr, "cannot open %s\n", lst_path.c_str());
    return 1;
  }
  mxtpu::RecordWriter writer(out_path);
  if (!writer.ok()) {
    fprintf(stderr, "cannot open %s for write\n", out_path.c_str());
    return 1;
  }
  std::string line;
  size_t count = 0, reencoded = 0;
  std::vector<uint8_t> rgb, resized, jpg;
  while (std::getline(lst, line)) {
    if (line.empty()) continue;
    std::istringstream ss(line);
    uint64_t idx;
    float label;
    std::string rel;
    ss >> idx >> label >> rel;
    std::string path = root.empty() ? rel : root + "/" + rel;
    std::ifstream img(path, std::ios::binary);
    if (!img) {
      fprintf(stderr, "skip missing %s\n", path.c_str());
      continue;
    }
    std::vector<uint8_t> bytes((std::istreambuf_iterator<char>(img)),
                               std::istreambuf_iterator<char>());
    const uint8_t* payload = bytes.data();
    size_t payload_len = bytes.size();
    if (resize > 0 && mxtpu::IsJPEG(bytes.data(), bytes.size()) &&
        !mxtpu::JpegAvailable()) {
      fprintf(stderr, "--resize re-encodes JPEGs, but this im2rec was built "
              "without libjpeg (jpeglib.h was not found): %s\n",
              path.c_str());
      return 1;
    }
    if (resize > 0 && mxtpu::IsJPEG(bytes.data(), bytes.size())) {
      int h = 0, w = 0;
      if (mxtpu::DecodeJPEG(bytes.data(), bytes.size(), &rgb, &h, &w)) {
        int oh = h, ow = w;
        const uint8_t* px = rgb.data();
        if (mxtpu::ResizeShorterEdge(rgb, h, w, resize, &resized, &oh, &ow))
          px = resized.data();
        // re-encode even when the size already matches so --quality
        // applies uniformly
        if (mxtpu::EncodeJPEG(px, oh, ow, quality, &jpg)) {
          payload = jpg.data();
          payload_len = jpg.size();
          ++reencoded;
        }
      } else {
        fprintf(stderr, "corrupt JPEG, packing verbatim: %s\n", path.c_str());
      }
    }
    writer.WriteImageRecord(label, idx, payload, payload_len);
    if (++count % 1000 == 0) fprintf(stderr, "packed %zu images\n", count);
  }
  fprintf(stderr, "done: %zu records (%zu re-encoded) -> %s\n", count,
          reencoded, out_path.c_str());
  return 0;
}
