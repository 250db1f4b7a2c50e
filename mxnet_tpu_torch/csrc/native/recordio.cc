#include "recordio.h"

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cstring>

namespace mxtpu {

RecordFile::~RecordFile() {
  if (map_ != nullptr) munmap(map_, bytes_);
}

bool RecordFile::Open(const std::string& path) {
  int fd = ::open(path.c_str(), O_RDONLY);
  if (fd >= 0) {
    struct stat st;
    if (fstat(fd, &st) == 0 && st.st_size > 0) {
      void* m = mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                     MAP_PRIVATE, fd, 0);
      if (m != MAP_FAILED) {
        // the access pattern is one sequential index pass, then batched
        // reads that sweep forward per epoch (or jump when shuffled)
        madvise(m, static_cast<size_t>(st.st_size), MADV_WILLNEED);
        map_ = m;
        base_ = static_cast<const uint8_t*>(m);
        bytes_ = static_cast<size_t>(st.st_size);
        ::close(fd);
        return BuildIndex();
      }
    }
    ::close(fd);
  }
  // fallback: whole-file heap read (small test files, exotic filesystems)
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  heap_.resize(n);
  if (n > 0 && fread(heap_.data(), 1, n, f) != static_cast<size_t>(n)) {
    fclose(f);
    return false;
  }
  fclose(f);
  base_ = heap_.data();
  bytes_ = heap_.size();
  return BuildIndex();
}

bool RecordFile::BuildIndex() {
  size_t pos = 0;
  while (pos + 8 <= bytes_) {
    uint32_t magic, lrec;
    memcpy(&magic, base_ + pos, 4);
    memcpy(&lrec, base_ + pos + 4, 4);
    if (magic != kRecordMagic) return false;
    size_t len = lrec & ((1u << 29) - 1);
    pos += 8;
    if (pos + len > bytes_) return false;
    offsets_.emplace_back(pos, len);
    pos += len + ((4 - len % 4) % 4);
  }
  return true;
}

bool RecordFile::Get(size_t i, ImageRecord* out) const {
  if (i >= offsets_.size()) return false;
  const uint8_t* p = base_ + offsets_[i].first;
  size_t len = offsets_[i].second;
  // IRHeader: uint32 flag, float label, uint64 id, uint64 id2  (24 bytes)
  if (len < 24) return false;
  uint32_t flag;
  float label;
  memcpy(&flag, p, 4);
  memcpy(&label, p + 4, 4);
  memcpy(&out->id, p + 8, 8);
  memcpy(&out->id2, p + 16, 8);
  out->flag = flag;
  p += 24;
  len -= 24;
  out->labels.clear();
  if (flag > 0) {  // multi-label: flag floats follow
    if (len < flag * 4) return false;
    out->labels.resize(flag);
    memcpy(out->labels.data(), p, flag * 4);
    p += flag * 4;
    len -= flag * 4;
  } else {
    out->labels.push_back(label);
  }
  out->payload = p;
  out->payload_size = len;
  return true;
}

RecordWriter::RecordWriter(const std::string& path) {
  f_ = fopen(path.c_str(), "wb");
}

RecordWriter::~RecordWriter() {
  if (f_) fclose(f_);
}

void RecordWriter::Write(const uint8_t* buf, size_t len) {
  uint32_t magic = kRecordMagic;
  uint32_t lrec = static_cast<uint32_t>(len);
  fwrite(&magic, 4, 1, f_);
  fwrite(&lrec, 4, 1, f_);
  fwrite(buf, 1, len, f_);
  static const uint8_t zeros[4] = {0, 0, 0, 0};
  size_t pad = (4 - len % 4) % 4;
  if (pad) fwrite(zeros, 1, pad, f_);
}

void RecordWriter::WriteImageRecord(float label, uint64_t id,
                                    const uint8_t* payload, size_t len) {
  std::vector<uint8_t> buf(24 + len);
  uint32_t flag = 0;
  uint64_t id2 = 0;
  memcpy(buf.data(), &flag, 4);
  memcpy(buf.data() + 4, &label, 4);
  memcpy(buf.data() + 8, &id, 8);
  memcpy(buf.data() + 16, &id2, 8);
  memcpy(buf.data() + 24, payload, len);
  Write(buf.data(), buf.size());
}

}  // namespace mxtpu
