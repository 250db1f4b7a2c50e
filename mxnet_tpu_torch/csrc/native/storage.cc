// Native pooled storage manager of the PyTorch port: the reference's
// src/storage/ (storage.cc:20-112, pooled_storage_manager.h:23-47).
//
// Division of labour: device memory is owned by PyTorch's CUDA caching
// allocator, so this manager covers the HOST side —
// staging buffers for the native IO pipeline, checkpoint serialization and
// kvstore host reductions — with the reference's exact recycling policy:
// free() returns a block to a size-keyed free list; alloc() reuses the
// smallest cached block with capacity >= requested within the match range
// (reference GraphStorageAllocator's MXNET_EXEC_MATCH_RANGE idea applied to
// the storage pool); an explicit release drains the pool.
//
// Exposed as a C ABI (ctypes; no pybind11 in this image).
#include <cstdint>
#include <cstdlib>
#include <map>
#include <mutex>
#include <new>
#include <unordered_map>

namespace mxtpu {

class PooledStorage {
 public:
  explicit PooledStorage(double match_range) : match_range_(match_range) {}

  ~PooledStorage() { ReleaseAll(); }

  void* Alloc(size_t size) {
    if (size == 0) size = 1;
    {
      std::lock_guard<std::mutex> lk(mu_);
      ++num_allocs_;
      // smallest cached block with capacity in [size, size*match_range_]
      auto it = pool_.lower_bound(size);
      if (it != pool_.end() &&
          static_cast<double>(it->first) <= size * match_range_) {
        void* p = it->second;
        pool_.erase(it);
        ++pool_hits_;
        blocks_[p].in_pool = false;
        pool_bytes_ -= blocks_[p].size;
        used_bytes_ += blocks_[p].size;
        return p;
      }
    }
    void* p = nullptr;
    // 64-byte alignment: matches the reference's aligned CPU storage and is
    // cache-line/DMA friendly for H2D staging.
    if (posix_memalign(&p, 64, size) != 0) return nullptr;
    std::lock_guard<std::mutex> lk(mu_);
    blocks_[p] = {size, false};
    used_bytes_ += size;
    return p;
  }

  void Free(void* p) {
    if (!p) return;
    std::lock_guard<std::mutex> lk(mu_);
    auto it = blocks_.find(p);
    if (it == blocks_.end() || it->second.in_pool) return;  // not ours / double free
    it->second.in_pool = true;
    pool_.emplace(it->second.size, p);
    pool_bytes_ += it->second.size;
    used_bytes_ -= it->second.size;
  }

  // Reference DirectFree: bypass the pool entirely.
  void DirectFree(void* p) {
    if (!p) return;
    std::lock_guard<std::mutex> lk(mu_);
    auto it = blocks_.find(p);
    if (it == blocks_.end()) return;
    if (it->second.in_pool) {
      ErasePoolEntry(it->second.size, p);
      pool_bytes_ -= it->second.size;
    } else {
      used_bytes_ -= it->second.size;
    }
    blocks_.erase(it);
    free(p);
  }

  void ReleaseAll() {
    std::lock_guard<std::mutex> lk(mu_);
    for (auto& kv : pool_) {
      blocks_.erase(kv.second);
      free(kv.second);
    }
    pool_.clear();
    pool_bytes_ = 0;
  }

  long PoolBytes() {
    std::lock_guard<std::mutex> lk(mu_);
    return static_cast<long>(pool_bytes_);
  }
  long UsedBytes() {
    std::lock_guard<std::mutex> lk(mu_);
    return static_cast<long>(used_bytes_);
  }
  long NumAllocs() {
    std::lock_guard<std::mutex> lk(mu_);
    return num_allocs_;
  }
  long PoolHits() {
    std::lock_guard<std::mutex> lk(mu_);
    return pool_hits_;
  }

 private:
  void ErasePoolEntry(size_t size, void* p) {
    auto range = pool_.equal_range(size);
    for (auto it = range.first; it != range.second; ++it)
      if (it->second == p) { pool_.erase(it); return; }
  }

  struct Block {
    size_t size = 0;
    bool in_pool = false;
  };

  std::mutex mu_;
  std::multimap<size_t, void*> pool_;        // capacity -> free block
  std::unordered_map<void*, Block> blocks_;  // every live block we own
  size_t pool_bytes_ = 0;   // bytes sitting in the free pool
  size_t used_bytes_ = 0;   // bytes handed out to callers
  long num_allocs_ = 0;
  long pool_hits_ = 0;
  double match_range_;
};

}  // namespace mxtpu

extern "C" {

void* mxtpu_storage_create(double match_range) {
  // match_range=1 means exact-fit-only reuse; anything below is meaningless.
  return new mxtpu::PooledStorage(match_range >= 1.0 ? match_range : 1.0);
}

void mxtpu_storage_destroy(void* s) {
  delete static_cast<mxtpu::PooledStorage*>(s);
}

void* mxtpu_storage_alloc(void* s, uint64_t size) {
  return static_cast<mxtpu::PooledStorage*>(s)->Alloc(size);
}

void mxtpu_storage_free(void* s, void* p) {
  static_cast<mxtpu::PooledStorage*>(s)->Free(p);
}

void mxtpu_storage_direct_free(void* s, void* p) {
  static_cast<mxtpu::PooledStorage*>(s)->DirectFree(p);
}

void mxtpu_storage_release_all(void* s) {
  static_cast<mxtpu::PooledStorage*>(s)->ReleaseAll();
}

long mxtpu_storage_pool_bytes(void* s) {
  return static_cast<mxtpu::PooledStorage*>(s)->PoolBytes();
}

long mxtpu_storage_used_bytes(void* s) {
  return static_cast<mxtpu::PooledStorage*>(s)->UsedBytes();
}

long mxtpu_storage_num_allocs(void* s) {
  return static_cast<mxtpu::PooledStorage*>(s)->NumAllocs();
}

long mxtpu_storage_pool_hits(void* s) {
  return static_cast<mxtpu::PooledStorage*>(s)->PoolHits();
}

}  // extern "C"
