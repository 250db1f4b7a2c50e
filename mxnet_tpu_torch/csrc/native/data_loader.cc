// Native threaded batch loader of the PyTorch port: the reference's C++ IO
// stack (src/io/iter_image_recordio.cc ImageRecordIOParser with N OMP
// decode threads + iter_normalize.h + iter_batchloader.h + iter_prefetcher.h).
//
// Pipeline: mmapped RecordFile index -> worker threads decode JPEG (libjpeg,
// matching the reference's per-thread cv::imdecode) or raw CHW payloads,
// apply resize/crop/mirror/mean/scale -> completed float32 batches land in a
// bounded double-buffer queue -> python (ctypes) copies a batch out; the
// port's iterator hands it to the module, which copies it to the card.
//
// A loader created with plan = 1 is the host half of the device route
// (feed/staging.py JpegDeviceRoute): its workers read each JPEG record's
// frame header (JpegDims, no libjpeg), size its shorter-edge resize and draw
// its crop and mirror exactly as the host route would, and deliver per batch
// the JPEG payloads back to back with each record's geometry (kPlanFields);
// nvjpeg decodes them on the card, and the jpeg_color and image_augment
// kernels (csrc/jpeg_decode.cu, csrc/image_augment.cu) finish the batch.
//
// The crop and mirror draws come from one stream an epoch, drawn batch by
// batch in sequence order after each batch's decode, so a seed gives the
// same batches at every thread count (at one thread, those of the JAX
// package's loader); decode and emit run in parallel.
//
// Exposed as a C ABI (ctypes).
#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstring>
#include <map>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

#include "image_decode.h"
#include "recordio.h"

namespace mxtpu {

struct Batch {
  std::vector<float> data;
  std::vector<float> label;
  int pad = 0;
  // plan mode: the batch's JPEG payloads back to back, and kPlanFields
  // numbers a record (PlanField)
  std::vector<uint8_t> payload;
  std::vector<int64_t> geom;
};

// A planned record's numbers, in this order: its payload's offset and
// length in the batch's payload, its record number, whether it was read
// (0: the record could not be read, its image is zeros), the decoded size,
// the size after the shorter-edge resize (the decoded size where there is
// none), the crop's offset in the resized image and the mirror bit.
enum PlanField {
  kPlanOffset, kPlanLength, kPlanRecord, kPlanOk, kPlanSrcH, kPlanSrcW,
  kPlanResH, kPlanResW, kPlanDy, kPlanDx, kPlanMirror, kPlanFields
};

class BatchLoader {
 public:
  BatchLoader(const char* path, int batch, int c, int h, int w,
              int label_width, int threads, int shuffle, int rand_crop,
              int rand_mirror, const float* mean_rgb, float scale,
              int part_index, int num_parts, int seed, int queue_depth,
              int resize, int plan)
      : batch_(batch), c_(c), h_(h), w_(w), label_width_(label_width),
        shuffle_(shuffle), rand_crop_(rand_crop), rand_mirror_(rand_mirror),
        scale_(scale), queue_depth_(queue_depth), resize_(resize),
        plan_(plan != 0), rng_(seed) {
    ok_ = rec_.Open(path);
    if (!ok_) return;
    if (mean_rgb) {
      mean_[0] = mean_rgb[0]; mean_[1] = mean_rgb[1]; mean_[2] = mean_rgb[2];
      has_mean_ = true;
    }
    size_t n = rec_.size();
    size_t shard = num_parts > 1 ? n / num_parts : n;
    size_t begin = num_parts > 1 ? shard * part_index : 0;
    for (size_t i = begin; i < begin + shard && i < n; ++i)
      order_.push_back(i);
    n_threads_ = threads > 0 ? threads : 4;
    Reset();
  }

  ~BatchLoader() { Stop(); }

  bool ok() const { return ok_; }
  size_t num_records() const { return order_.size(); }

  void Reset() {
    Stop();
    if (shuffle_) {
      std::shuffle(order_.begin(), order_.end(), rng_);
    }
    // one seed an epoch for its augmentation stream, whatever the thread
    // count (the JAX package's loader draws one a worker, which is the
    // same stream at one thread)
    plan_rng_.seed(rng_());
    plan_seq_ = 0;
    cursor_.store(0);
    stop_.store(false);
    for (int i = 0; i < n_threads_; ++i)
      workers_.emplace_back([this] { WorkerLoop(); });
  }

  // Returns 0 and fills data/label on success; 1 at end of epoch; 2 on a
  // decode error (message via last_error()).  Batches are delivered IN
  // ORDER (sequence = record position / batch): workers complete out of
  // order, but eval parity and reproducible training require the
  // reference's sequential batch stream.
  int Next(float* data, float* label, int* pad) {
    Batch b;
    const int rc = Pop(&b);
    if (rc != 0) return rc;
    memcpy(data, b.data.data(), b.data.size() * sizeof(float));
    memcpy(label, b.label.data(), b.label.size() * sizeof(float));
    *pad = b.pad;
    return 0;
  }

  // Plan mode: take the next batch's plan (return codes as Next) and say
  // how many payload bytes TakePlan will write.
  int NextPlan(long long* payload_bytes) {
    const int rc = Pop(&plan_out_);
    *payload_bytes = rc == 0
        ? static_cast<long long>(plan_out_.payload.size()) : 0;
    return rc;
  }

  // Copy out the plan NextPlan took: payloads, batch x kPlanFields
  // numbers, labels and pad.
  void TakePlan(uint8_t* payload, long long* geom, float* label, int* pad) {
    memcpy(payload, plan_out_.payload.data(), plan_out_.payload.size());
    for (size_t i = 0; i < plan_out_.geom.size(); ++i)
      geom[i] = plan_out_.geom[i];
    memcpy(label, plan_out_.label.data(),
           plan_out_.label.size() * sizeof(float));
    *pad = plan_out_.pad;
  }

  const char* last_error() {
    std::lock_guard<std::mutex> lk(mu_);
    return error_.c_str();
  }

  size_t total_batches() const {
    return order_.empty() ? 0
        : (order_.size() + static_cast<size_t>(batch_) - 1) /
              static_cast<size_t>(batch_);
  }

 private:
  int Pop(Batch* out) {
    std::unique_lock<std::mutex> lk(mu_);
    // End-of-epoch is EXACT: every one of the ceil(n/batch) sequences
    // must be delivered.  "Some worker ran off the end" is NOT the
    // condition — with more workers than the admission window, the
    // first worker past the cursor end races ahead of workers still
    // waiting at the gate with undelivered earlier sequences, and an
    // eof flag alone truncated an 8-batch epoch to 2.
    const size_t total = total_batches();
    not_empty_.wait(lk, [this, total] {
      return !error_.empty() || pending_.count(next_seq_) != 0 ||
             next_seq_ >= total;
    });
    if (!error_.empty()) return 2;
    if (next_seq_ >= total) return 1;
    auto it = pending_.find(next_seq_);
    if (it == pending_.end()) {
      // unreachable by the wait predicate; a lost batch must be LOUD,
      // never a silent end-of-epoch (the truncation bug this replaced)
      error_ = "internal: sequence " + std::to_string(next_seq_) +
               " missing from the reorder buffer";
      return 2;
    }
    *out = std::move(it->second);
    pending_.erase(it);
    ++next_seq_;
    lk.unlock();
    not_full_.notify_all();
    return 0;
  }

  void Stop() {
    stop_.store(true);
    not_full_.notify_all();
    not_empty_.notify_all();
    plan_cv_.notify_all();
    for (auto& t : workers_) t.join();
    workers_.clear();
    pending_.clear();
    next_seq_ = 0;
    error_.clear();
  }

  // A bad record is a hard, loud error (the reference CHECKs and aborts
  // on decode failure): silently emitting zero images with real labels
  // would train on garbage invisibly.
  void Fail(const std::string& msg) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (error_.empty()) error_ = msg;
    }
    stop_.store(true);
    not_empty_.notify_all();
    not_full_.notify_all();
    plan_cv_.notify_all();
  }

  // One record of a batch between its decode and its emit: the pixels
  // (HWC RGB for JPEG, CHW for raw payloads), their geometry, and the
  // crop/mirror draws planned for it.  In plan mode px stays null: the
  // payload, its decoded size (dec_h, dec_w) and src_h, src_w (after the
  // resize) are what the card needs.
  struct Decoded {
    bool ok = false;       // false: the record could not be read (zeros)
    bool hwc = false;
    const uint8_t* px = nullptr;
    int src_h = 0, src_w = 0;
    std::vector<uint8_t> rgb, resized;  // JPEG scratch, reused
    int dy = 0, dx = 0;
    bool mirror = false;
    size_t rec_no = 0;
    const uint8_t* payload = nullptr;   // plan mode: the JPEG bytes
    size_t payload_size = 0;
    int dec_h = 0, dec_w = 0;
  };

  // The draws of one record, in the order and under the conditions of the
  // reference loader's single worker: a crop offset pair when the source
  // is larger than the target and rand_crop is on, then a mirror bit.
  void Plan(Decoded* d) {
    d->dy = d->dx = 0;
    if (d->src_h > h_ || d->src_w > w_) {
      if (rand_crop_) {
        d->dy = plan_rng_() % (d->src_h - h_ + 1);
        d->dx = plan_rng_() % (d->src_w - w_ + 1);
      } else {
        d->dy = (d->src_h - h_) / 2;
        d->dx = (d->src_w - w_) / 2;
      }
    }
    d->mirror = rand_mirror_ && (plan_rng_() & 1);
  }

  // Decode record rec_idx's payload into d and its labels into label_out.
  // Returns false after Fail() on a record that must not be delivered.
  bool Decode(size_t rec_idx, Decoded* d, float* label_out) {
    d->ok = false;
    ImageRecord r;
    const size_t rec_no = order_[rec_idx % order_.size()];
    d->rec_no = rec_no;
    if (!rec_.Get(rec_no, &r)) return true;
    for (int l = 0; l < label_width_; ++l)
      label_out[l] = l < static_cast<int>(r.labels.size()) ? r.labels[l] : 0.f;

    if (plan_) return PlanJpeg(r, rec_no, d);
    if (IsJPEG(r.payload, r.payload_size)) {
      if (!JpegAvailable()) {
        char msg[200];
        snprintf(msg, sizeof(msg),
                 "record %zu holds a JPEG, but this I/O library was built "
                 "without libjpeg (jpeglib.h was not found); pack raw CHW "
                 "records or build where libjpeg is installed", rec_no);
        Fail(msg);
        return false;
      }
      // DecodeJPEG emits 3-channel RGB; the emit strides by c_.  With
      // c_ != 3 (grayscale data_shape) the stride would walk RGB bytes
      // across x positions — corrupt images with real labels.  Fail
      // loud; the python side gates delegation on shape[0] == 3.
      if (!CheckChannels(rec_no)) return false;
      // reference path: per-thread JPEG decode
      // (iter_image_recordio.cc:139-291 + image_aug_default.cc resize)
      int ih = 0, iw = 0;
      if (!DecodeJPEG(r.payload, r.payload_size, &d->rgb, &ih, &iw)) {
        char msg[128];
        snprintf(msg, sizeof(msg), "corrupt JPEG at record %zu", rec_no);
        Fail(msg);
        return false;
      }
      d->px = d->rgb.data();
      if (resize_ > 0) {
        int oh = 0, ow = 0;
        if (ResizeShorterEdge(d->rgb, ih, iw, resize_, &d->resized, &oh,
                              &ow)) {
          d->px = d->resized.data();
          ih = oh;
          iw = ow;
        }
      }
      if (!CheckCrop(rec_no, ih, iw)) return false;
      d->hwc = true;
      d->src_h = ih;
      d->src_w = iw;
      d->ok = true;
      return true;
    }

    // raw-packed payload: uint8 CHW at source resolution (>= target)
    size_t want = static_cast<size_t>(c_) * h_ * w_;
    d->src_h = h_;
    d->src_w = w_;
    size_t header = 0;
    if (r.payload_size > want) {
      // payload stores uint16 src_h, src_w prefix when larger than target
      // (im2rec --resize writes exact size, so this is the uncommon path)
      d->src_h = r.payload[0] | (r.payload[1] << 8);
      d->src_w = r.payload[2] | (r.payload[3] << 8);
      header = 4;
    }
    d->px = r.payload + header;
    d->hwc = false;
    d->ok = true;
    return true;
  }

  bool CheckChannels(size_t rec_no) {
    if (c_ == 3) return true;
    char msg[160];
    snprintf(msg, sizeof(msg),
             "JPEG records decode to 3 channels but data_shape has "
             "%d; use a 3-channel data_shape (record %zu)", c_, rec_no);
    Fail(msg);
    return false;
  }

  bool CheckCrop(size_t rec_no, int ih, int iw) {
    if (ih >= h_ && iw >= w_) return true;
    char msg[160];
    snprintf(msg, sizeof(msg),
             "record %zu decodes to %dx%d, smaller than the %dx%d "
             "crop (resize=%d)", rec_no, ih, iw, h_, w_, resize_);
    Fail(msg);
    return false;
  }

  // Plan mode: a JPEG record's sizes from its frame header, with the host
  // route's checks and messages; the decode is left to the card.
  bool PlanJpeg(const ImageRecord& r, size_t rec_no, Decoded* d) {
    if (!IsJPEG(r.payload, r.payload_size)) {
      char msg[200];
      snprintf(msg, sizeof(msg),
               "record %zu is not a JPEG; the device route decodes JPEG "
               "records only (iterate the records on the host)", rec_no);
      Fail(msg);
      return false;
    }
    if (!CheckChannels(rec_no)) return false;
    int ih = 0, iw = 0, comps = 0;
    const int hdr = JpegDims(r.payload, r.payload_size, &ih, &iw, &comps);
    if (hdr != kJpegOk) {
      char msg[160];
      if (hdr == kJpegOtherProcess)
        snprintf(msg, sizeof(msg), "corrupt JPEG at record %zu (a frame "
                 "other than SOF0/1/2, which nvjpeg does not decode)",
                 rec_no);
      else
        snprintf(msg, sizeof(msg), "corrupt JPEG at record %zu", rec_no);
      Fail(msg);
      return false;
    }
    d->payload = r.payload;
    d->payload_size = r.payload_size;
    d->dec_h = ih;
    d->dec_w = iw;
    int oh = 0, ow = 0;
    if (ShorterEdgeSize(ih, iw, resize_, &oh, &ow)) {
      ih = oh;
      iw = ow;
    }
    if (!CheckCrop(rec_no, ih, iw)) return false;
    d->hwc = true;
    d->src_h = ih;
    d->src_w = iw;
    d->ok = true;
    return true;
  }

  // Plan mode: append a planned record's payload and numbers to b.
  void EmitPlan(const Decoded& d, Batch* b) {
    b->geom.resize(b->geom.size() + kPlanFields, 0);
    int64_t* g = b->geom.data() + b->geom.size() - kPlanFields;
    g[kPlanRecord] = static_cast<int64_t>(d.rec_no);
    g[kPlanOffset] = static_cast<int64_t>(b->payload.size());
    if (!d.ok) return;
    g[kPlanLength] = static_cast<int64_t>(d.payload_size);
    b->payload.insert(b->payload.end(), d.payload,
                      d.payload + d.payload_size);
    g[kPlanOk] = 1;
    g[kPlanSrcH] = d.dec_h;
    g[kPlanSrcW] = d.dec_w;
    g[kPlanResH] = d.src_h;
    g[kPlanResW] = d.src_w;
    g[kPlanDy] = d.dy;
    g[kPlanDx] = d.dx;
    g[kPlanMirror] = d.mirror ? 1 : 0;
  }

  // Crop/mirror/normalize a decoded record into CHW float out.
  void Emit(const Decoded& d, float* out) {
    if (!d.ok) return;
    for (int ch = 0; ch < c_; ++ch) {
      float mean = has_mean_ ? mean_[ch % 3] : 0.f;
      for (int y = 0; y < h_; ++y) {
        float* dst = out + (static_cast<size_t>(ch) * h_ + y) * w_;
        if (d.hwc) {
          const uint8_t* row = d.px +
              (static_cast<size_t>(y + d.dy) * d.src_w + d.dx) * c_ + ch;
          if (!d.mirror) {
            for (int x = 0; x < w_; ++x)
              dst[x] = (static_cast<float>(row[static_cast<size_t>(x) * c_])
                        - mean) * scale_;
          } else {
            for (int x = 0; x < w_; ++x)
              dst[x] = (static_cast<float>(
                            row[static_cast<size_t>(w_ - 1 - x) * c_]) -
                        mean) * scale_;
          }
        } else {
          const uint8_t* row = d.px +
              (static_cast<size_t>(ch) * d.src_h + y + d.dy) * d.src_w + d.dx;
          if (!d.mirror) {
            for (int x = 0; x < w_; ++x)
              dst[x] = (static_cast<float>(row[x]) - mean) * scale_;
          } else {
            for (int x = 0; x < w_; ++x)
              dst[x] = (static_cast<float>(row[w_ - 1 - x]) - mean) * scale_;
          }
        }
      }
    }
  }

  void WorkerLoop() {
    std::vector<Decoded> recs(static_cast<size_t>(batch_));
    const size_t n = order_.size();
    const size_t img_sz = static_cast<size_t>(c_) * h_ * w_;
    while (!stop_.load()) {
      size_t start = cursor_.fetch_add(batch_);
      if (start >= n) return;   // the exact end condition lives in Next()
      size_t seq = start / static_cast<size_t>(batch_);
      {
        std::unique_lock<std::mutex> lk(mu_);
        // admission by SEQUENCE WINDOW, not queue occupancy: a size-based
        // gate can starve the worker holding the lowest unproduced seq
        // while later seqs fill the buffer — the consumer then waits on a
        // batch that can never be admitted (deadlock).  Any seq within
        // queue_depth_ of the drain point may proceed; because seqs are
        // handed out contiguously, the needed batch is always admissible.
        not_full_.wait(lk, [this, seq] {
          return seq < next_seq_ + static_cast<size_t>(queue_depth_)
                 || stop_.load();
        });
        if (stop_.load()) return;
      }
      Batch b;
      if (!plan_) b.data.resize(static_cast<size_t>(batch_) * img_sz);
      b.label.resize(static_cast<size_t>(batch_) * label_width_);
      b.pad = start + batch_ > n ? static_cast<int>(start + batch_ - n) : 0;
      // decode in parallel with the other workers ...
      for (int i = 0; i < batch_; ++i) {
        if (!Decode(start + i, &recs[i],
                    b.label.data() + i * label_width_))
          return;
      }
      // ... then draw this batch's crops and mirrors in sequence order
      // from the one epoch stream, so every thread count gives the
      // batches of a single worker
      {
        std::unique_lock<std::mutex> lk(plan_mu_);
        plan_cv_.wait(lk, [this, seq] {
          return plan_seq_ == seq || stop_.load();
        });
        if (stop_.load()) return;
        for (int i = 0; i < batch_; ++i)
          if (recs[i].ok) Plan(&recs[i]);
        ++plan_seq_;
      }
      plan_cv_.notify_all();
      if (plan_) {
        b.geom.reserve(static_cast<size_t>(batch_) * kPlanFields);
        for (int i = 0; i < batch_; ++i) EmitPlan(recs[i], &b);
      } else {
        for (int i = 0; i < batch_; ++i)
          Emit(recs[i], b.data.data() + i * img_sz);
      }
      {
        std::lock_guard<std::mutex> lk(mu_);
        pending_.emplace(seq, std::move(b));
      }
      not_empty_.notify_all();
    }
  }

  RecordFile rec_;
  std::vector<size_t> order_;
  int batch_, c_, h_, w_, label_width_;
  int shuffle_, rand_crop_, rand_mirror_;
  float scale_;
  float mean_[3] = {0, 0, 0};
  bool has_mean_ = false;
  bool ok_ = false;
  int n_threads_ = 4;
  int queue_depth_;
  int resize_ = 0;  // shorter-edge resize target; 0 = off
  bool plan_ = false;  // plan mode: JPEG headers and draws, no decode
  Batch plan_out_;     // the plan NextPlan took, for TakePlan
  std::mt19937 rng_;
  // the epoch's augmentation stream, drawn batch by batch in sequence
  // order (plan_seq_ is the next batch to draw)
  std::mt19937 plan_rng_;
  size_t plan_seq_ = 0;
  std::mutex plan_mu_;
  std::condition_variable plan_cv_;

  std::vector<std::thread> workers_;
  std::map<size_t, Batch> pending_;  // seq -> batch, drained in order
  size_t next_seq_ = 0;
  std::string error_;                // first decode failure, sticky
  std::mutex mu_;
  std::condition_variable not_empty_, not_full_;
  std::atomic<size_t> cursor_{0};
  std::atomic<bool> stop_{false};
};

}  // namespace mxtpu

extern "C" {

void* mxtpu_loader_create(const char* path, int batch, int c, int h, int w,
                          int label_width, int threads, int shuffle,
                          int rand_crop, int rand_mirror,
                          const float* mean_rgb, float scale, int part_index,
                          int num_parts, int seed, int queue_depth,
                          int resize, int plan) {
  auto* l = new mxtpu::BatchLoader(path, batch, c, h, w, label_width, threads,
                                   shuffle, rand_crop, rand_mirror, mean_rgb,
                                   scale, part_index, num_parts, seed,
                                   queue_depth > 0 ? queue_depth : 4, resize,
                                   plan);
  if (!l->ok()) {
    delete l;
    return nullptr;
  }
  return l;
}

long mxtpu_loader_num_records(void* handle) {
  return static_cast<long>(static_cast<mxtpu::BatchLoader*>(handle)->num_records());
}

int mxtpu_loader_next(void* handle, float* data, float* label, int* pad) {
  return static_cast<mxtpu::BatchLoader*>(handle)->Next(data, label, pad);
}

int mxtpu_loader_next_plan(void* handle, long long* payload_bytes) {
  return static_cast<mxtpu::BatchLoader*>(handle)->NextPlan(payload_bytes);
}

void mxtpu_loader_take_plan(void* handle, unsigned char* payload,
                            long long* geom, float* label, int* pad) {
  static_cast<mxtpu::BatchLoader*>(handle)->TakePlan(payload, geom, label,
                                                     pad);
}

int mxtpu_plan_fields() { return mxtpu::kPlanFields; }

// A JPEG's frame header: 0 with its height, width and components, 1 when
// it cannot be read, 2 for a frame of another coding process (JpegDims).
int mxtpu_jpeg_dims(const unsigned char* buf, long len, int* h, int* w,
                    int* comps) {
  return mxtpu::JpegDims(buf, static_cast<size_t>(len), h, w, comps);
}

// The host decode (libjpeg, RGB): 0 with the pixels in out (h x w x 3
// bytes) when they fit in cap, 1 on a corrupt JPEG, 2 without libjpeg, 3
// when cap is too small (h and w are set).
int mxtpu_jpeg_decode(const unsigned char* buf, long len, unsigned char* out,
                      long cap, int* h, int* w) {
  if (!mxtpu::JpegAvailable()) return 2;
  std::vector<uint8_t> rgb;
  if (!mxtpu::DecodeJPEG(buf, static_cast<size_t>(len), &rgb, h, w)) return 1;
  if (static_cast<long>(rgb.size()) > cap) return 3;
  memcpy(out, rgb.data(), rgb.size());
  return 0;
}

// The host decode's components before upsampling and colour conversion
// (DecodeJPEGPlanes): 0 with Y, then Cb and Cr, in out when they fit in
// cap and info = (h, w, cw, ch, kind); 1 on a corrupt JPEG or a sampling
// other than gray, 4:4:4, 4:2:2, 4:2:0; 2 without libjpeg; 3 when cap is
// too small.
int mxtpu_jpeg_decode_planes(const unsigned char* buf, long len,
                             unsigned char* out, long cap, int* info) {
  if (!mxtpu::JpegAvailable()) return 2;
  std::vector<uint8_t> planes;
  if (!mxtpu::DecodeJPEGPlanes(buf, static_cast<size_t>(len), &planes,
                               &info[0], &info[1], &info[2], &info[3],
                               &info[4]))
    return 1;
  if (static_cast<long>(planes.size()) > cap) return 3;
  memcpy(out, planes.data(), planes.size());
  return 0;
}

int mxtpu_have_jpeg() { return mxtpu::JpegAvailable() ? 1 : 0; }

const char* mxtpu_loader_last_error(void* handle) {
  return static_cast<mxtpu::BatchLoader*>(handle)->last_error();
}

void mxtpu_loader_reset(void* handle) {
  static_cast<mxtpu::BatchLoader*>(handle)->Reset();
}

void mxtpu_loader_free(void* handle) {
  delete static_cast<mxtpu::BatchLoader*>(handle);
}

// ---- recordio writer (im2rec core) ----
void* mxtpu_writer_create(const char* path) {
  auto* w = new mxtpu::RecordWriter(path);
  if (!w->ok()) { delete w; return nullptr; }
  return w;
}

void mxtpu_writer_write_image(void* handle, float label, unsigned long id,
                              const unsigned char* payload, long len) {
  static_cast<mxtpu::RecordWriter*>(handle)->WriteImageRecord(
      label, id, payload, static_cast<size_t>(len));
}

void mxtpu_writer_write_raw(void* handle, const unsigned char* buf, long len) {
  static_cast<mxtpu::RecordWriter*>(handle)->Write(buf, static_cast<size_t>(len));
}

void mxtpu_writer_free(void* handle) {
  delete static_cast<mxtpu::RecordWriter*>(handle);
}

}  // extern "C"
