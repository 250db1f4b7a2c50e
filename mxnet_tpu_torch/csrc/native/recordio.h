// RecordIO framing + packed image records — native core of the data pipeline.
// Byte-compatible with the python mxnet_tpu.recordio module (and the
// reference dmlc-core recordio format): magic 0xced7230a, little-endian
// length word (low 29 bits), payload padded to 4 bytes.
// Reference analogue: dmlc-core recordio + src/io/iter_image_recordio.cc.
#ifndef MXTPU_RECORDIO_H_
#define MXTPU_RECORDIO_H_

#include <cstdint>
#include <cstdio>
#include <string>
#include <vector>

namespace mxtpu {

constexpr uint32_t kRecordMagic = 0xced7230a;

// One parsed record: header (flag/label/id) + payload bytes.
struct ImageRecord {
  uint32_t flag = 0;
  std::vector<float> labels;  // single or multi-label
  uint64_t id = 0;
  uint64_t id2 = 0;
  const uint8_t* payload = nullptr;  // points into the mapped file
  size_t payload_size = 0;
};

// Memory-MAPPED sequential reader: one index-building pass at open, then
// O(resident) memory — the kernel pages records in and out on demand, so an
// ImageNet-scale .rec (~150 GB) iterates in bounded RAM.  The reference
// streams bounded chunks instead (iter_image_recordio.cc:311-395); mmap
// gives the same bound with random (shuffled) access for free.  Falls back
// to a heap read when mmap is unavailable (pipes, tiny test files).
class RecordFile {
 public:
  ~RecordFile();
  bool Open(const std::string& path);
  size_t size() const { return offsets_.size(); }
  // Parse record i (IRHeader + payload view into the mapped file).
  bool Get(size_t i, ImageRecord* out) const;

 private:
  bool BuildIndex();
  const uint8_t* base_ = nullptr;  // mmap base or heap fallback
  size_t bytes_ = 0;
  void* map_ = nullptr;            // non-null when mmapped
  std::vector<uint8_t> heap_;      // fallback storage
  std::vector<std::pair<size_t, size_t>> offsets_;  // (begin, length)
};

// Writer used by im2rec.
class RecordWriter {
 public:
  explicit RecordWriter(const std::string& path);
  ~RecordWriter();
  bool ok() const { return f_ != nullptr; }
  void Write(const uint8_t* buf, size_t len);
  // Pack IRHeader(flag=0, label, id) + payload.
  void WriteImageRecord(float label, uint64_t id, const uint8_t* payload,
                        size_t len);

 private:
  FILE* f_;
};

}  // namespace mxtpu

#endif  // MXTPU_RECORDIO_H_
