// Native dependency engine of the PyTorch port: the reference's
// C++ async dataflow scheduler (src/engine/threaded_engine.h:42-189,
// threaded_engine_perdevice.cc:26-183).
//
// Semantics preserved exactly (they are public API surface, SURVEY.md §1):
//   - a Var is a versioned queue of pending operations;
//   - writes to a Var serialize in push order;
//   - reads between two writes run concurrently;
//   - an operation runs only when every const (read) and mutable (write)
//     dependency is satisfied; completion schedules newly-ready ops;
//   - WaitForVar joins the var's queue as a read, i.e. it blocks until every
//     pending WRITE ahead of it completes (reads may still be in flight —
//     same contract as the reference's WaitForVar); WaitForAll drains the
//     engine.
//
// Division of labour in the port: CUDA streams already order *device*
// compute, so this engine schedules the HOST side of the framework —
// python closures dispatched via ctypes trampolines (IO prefetch,
// checkpoint writes, host reductions, closures that queue card work) — on
// a C++ thread pool, the role the reference engine's CPU worker pools
// play.  A closure that queues card work returns before that work ends;
// the Python facade (mxnet_tpu_torch/engine.py) waits for the card after
// the native waits.
//
// Exposed as a C ABI (ctypes).
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <queue>
#include <memory>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace mxtpu {

typedef void (*EngineFn)(void* arg);

// Scheduling hints, reference include/mxnet/engine.h:58-69.
enum FnProperty {
  kNormal = 0,
  kCopyFromDevice = 1,
  kCopyToDevice = 2,
  kPrioritized = 3,
  kAsync = 4,
};

struct OprBlock;

// One entry in a var's pending queue (reference VersionedVarBlock,
// threaded_engine.h:68-80).
struct VarEntry {
  OprBlock* opr = nullptr;
  bool write = false;
};

// Reference ThreadedVar (threaded_engine.h:87-189): pending queue with
// serialized writes, batched reads.  A mutex per var replaces the
// reference's spinlock — host-side ops here are coarse (a python closure),
// so lock cost is irrelevant.
struct Var;
using VarPtr = std::shared_ptr<Var>;

struct Var {
  std::mutex mu;
  std::deque<VarEntry> queue;   // ops not yet dispatched for this var
  int running_reads = 0;        // dispatched-but-incomplete reads
  bool running_write = false;   // a write is dispatched and incomplete
  uint64_t version = 0;         // bumped per completed write
};

// Reference OprBlock (threaded_engine.h:42-65): wait counter decremented as
// dependencies are satisfied; at zero the op is ready to run.
struct OprBlock {
  EngineFn fn = nullptr;
  void* arg = nullptr;
  std::vector<VarPtr> const_vars;
  std::vector<VarPtr> mutable_vars;
  std::atomic<int> wait{0};
  int prop = kNormal;
  int priority = 0;
};

class Engine {
 public:
  explicit Engine(int num_workers, int num_prio_workers) {
    if (num_workers <= 0) num_workers = 4;
    if (num_prio_workers <= 0) num_prio_workers = 2;
    for (int i = 0; i < num_workers; ++i)
      workers_.emplace_back([this] { WorkerLoop(false); });
    for (int i = 0; i < num_prio_workers; ++i)
      workers_.emplace_back([this] { WorkerLoop(true); });
  }

  ~Engine() {
    WaitForAll();
    {
      std::lock_guard<std::mutex> lk(qmu_);
      stop_ = true;
    }
    qcv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  uint64_t NewVar() {
    auto v = std::make_shared<Var>();
    std::lock_guard<std::mutex> lk(vars_mu_);
    uint64_t id = next_var_id_++;
    vars_[id] = std::move(v);
    return id;
  }

  // Reference DeleteVariable: the id stops resolving immediately (new
  // pushes are rejected); ops already pushed still run, and the Var object
  // dies when the last in-flight op's shared_ptr releases it, so completion
  // handlers never touch freed memory.
  void DeleteVar(uint64_t id) {
    std::lock_guard<std::mutex> lk(vars_mu_);
    vars_.erase(id);
  }

  // Returns 0 on success, -1 on duplicate vars (reference CheckDuplicate,
  // threaded_engine.cc:205-237, which aborts; we surface an error instead).
  int Push(EngineFn fn, void* arg, const uint64_t* cvars, int nc,
           const uint64_t* mvars, int nm, int prop, int priority) {
    std::vector<VarPtr> cv, mv;
    cv.reserve(nc);
    mv.reserve(nm);
    for (int i = 0; i < nc; ++i) {
      VarPtr v = Lookup(cvars[i]);
      if (!v) return -1;
      cv.push_back(std::move(v));
    }
    for (int i = 0; i < nm; ++i) {
      VarPtr v = Lookup(mvars[i]);
      if (!v) return -1;
      mv.push_back(std::move(v));
    }
    // Reference CheckDuplicate (threaded_engine.cc:205-237): a var may appear
    // at most once across const+mutable lists combined.
    for (size_t i = 0; i < cv.size(); ++i)
      for (size_t j = i + 1; j < cv.size(); ++j)
        if (cv[i] == cv[j]) return -1;
    for (size_t i = 0; i < mv.size(); ++i)
      for (size_t j = i + 1; j < mv.size(); ++j)
        if (mv[i] == mv[j]) return -1;
    for (const VarPtr& m : mv)
      for (const VarPtr& c : cv)
        if (c == m) return -1;

    OprBlock* op = new OprBlock();
    op->fn = fn;
    op->arg = arg;
    op->const_vars = std::move(cv);
    op->mutable_vars = std::move(mv);
    op->prop = prop;
    op->priority = priority;
    // wait = deps + 1 sentinel so the op can't fire while we're still
    // appending dependencies (reference threaded_engine.cc:255-277).
    op->wait.store(1 + static_cast<int>(op->const_vars.size()) +
                   static_cast<int>(op->mutable_vars.size()));
    pending_.fetch_add(1);

    for (const VarPtr& v : op->const_vars) AppendRead(v.get(), op);
    for (const VarPtr& v : op->mutable_vars) AppendWrite(v.get(), op);
    if (op->wait.fetch_sub(1) == 1) Dispatch(op);
    return 0;
  }

  void WaitForVar(uint64_t id) {
    struct Sig {
      std::mutex mu;
      std::condition_variable cv;
      bool done = false;
    } sig;
    uint64_t v = id;
    int rc = Push(
        [](void* a) {
          Sig* s = static_cast<Sig*>(a);
          std::lock_guard<std::mutex> lk(s->mu);
          s->done = true;
          s->cv.notify_all();
        },
        &sig, &v, 1, nullptr, 0, kNormal, 0);
    if (rc != 0) {
      // Deleted/unknown var: its in-flight ops may still be running and we
      // can no longer queue behind them individually — drain the engine so
      // the caller's completed-write assumption holds.
      WaitForAll();
      return;
    }
    std::unique_lock<std::mutex> lk(sig.mu);
    sig.cv.wait(lk, [&] { return sig.done; });
  }

  void WaitForAll() {
    std::unique_lock<std::mutex> lk(done_mu_);
    done_cv_.wait(lk, [this] { return pending_.load() == 0; });
  }

  long NumPending() const { return pending_.load(); }

 private:
  VarPtr Lookup(uint64_t id) {
    std::lock_guard<std::mutex> lk(vars_mu_);
    auto it = vars_.find(id);
    return it == vars_.end() ? nullptr : it->second;
  }

  // Reference AppendReadDependency (threaded_engine.h:95-130): a read runs
  // immediately unless a write is pending ahead of it.
  void AppendRead(Var* v, OprBlock* op) {
    std::lock_guard<std::mutex> lk(v->mu);
    bool write_ahead = v->running_write;
    for (const VarEntry& e : v->queue)
      if (e.write) { write_ahead = true; break; }
    if (!write_ahead) {
      ++v->running_reads;
      op->wait.fetch_sub(1);
    } else {
      v->queue.push_back({op, false});
    }
  }

  // Reference AppendWriteDependency (threaded_engine.h:132-160): a write
  // waits for every prior op on the var.
  void AppendWrite(Var* v, OprBlock* op) {
    std::lock_guard<std::mutex> lk(v->mu);
    if (!v->running_write && v->running_reads == 0 && v->queue.empty()) {
      v->running_write = true;
      op->wait.fetch_sub(1);
    } else {
      v->queue.push_back({op, true});
    }
  }

  // Reference CompleteReadDependency / CompleteWriteDependency
  // (threaded_engine.h:162-189): pop newly-ready ops off the var queue.
  void CompleteRead(Var* v, std::vector<OprBlock*>* ready) {
    std::lock_guard<std::mutex> lk(v->mu);
    --v->running_reads;
    MaybeSchedule(v, ready);
  }

  void CompleteWrite(Var* v, std::vector<OprBlock*>* ready) {
    std::lock_guard<std::mutex> lk(v->mu);
    v->running_write = false;
    ++v->version;
    MaybeSchedule(v, ready);
  }

  void MaybeSchedule(Var* v, std::vector<OprBlock*>* ready) {
    if (v->running_write || v->running_reads > 0) return;
    // front is a write -> dispatch it alone; front is reads -> dispatch the
    // whole read batch up to the next write.
    while (!v->queue.empty()) {
      VarEntry e = v->queue.front();
      if (e.write) {
        if (v->running_reads == 0) {
          v->queue.pop_front();
          v->running_write = true;
          if (e.opr->wait.fetch_sub(1) == 1) ready->push_back(e.opr);
        }
        break;
      }
      v->queue.pop_front();
      ++v->running_reads;
      if (e.opr->wait.fetch_sub(1) == 1) ready->push_back(e.opr);
    }
  }

  void Dispatch(OprBlock* op) {
    if (op->prop == kAsync) {  // inline, reference PushToExecute async route
      Execute(op);
      return;
    }
    {
      std::lock_guard<std::mutex> lk(qmu_);
      // Only kPrioritized ops use the priority queue (reference: priority
      // hints apply to the CPU priority pool, threaded_engine_perdevice.cc);
      // a kNormal op with a negative priority must NOT jump the FIFO.
      if (op->prop == kPrioritized)
        prio_queue_.push(op);
      else
        fifo_queue_.push_back(op);
    }
    qcv_.notify_one();
  }

  void Execute(OprBlock* op) {
    if (op->fn) op->fn(op->arg);
    std::vector<OprBlock*> ready;
    for (const VarPtr& v : op->const_vars) CompleteRead(v.get(), &ready);
    for (const VarPtr& v : op->mutable_vars) CompleteWrite(v.get(), &ready);
    delete op;  // releases the shared_ptrs; a deleted var dies here
    for (OprBlock* r : ready) Dispatch(r);
    if (pending_.fetch_sub(1) == 1) {
      std::lock_guard<std::mutex> lk(done_mu_);
      done_cv_.notify_all();
    }
  }

  // One loop for both pools; the priority pool just prefers the priority
  // queue (reference runs separate FIFO and priority ConcurrentBlockingQueues
  // per pool, threaded_engine_perdevice.cc:28-32 — both pools here drain
  // both queues so neither can starve).
  void WorkerLoop(bool prefer_prio) {
    for (;;) {
      OprBlock* op = nullptr;
      {
        std::unique_lock<std::mutex> lk(qmu_);
        qcv_.wait(lk, [this] {
          return stop_ || !fifo_queue_.empty() || !prio_queue_.empty();
        });
        if (stop_ && fifo_queue_.empty() && prio_queue_.empty()) return;
        bool take_prio = prefer_prio ? !prio_queue_.empty()
                                     : fifo_queue_.empty();
        if (take_prio) {
          op = prio_queue_.top();
          prio_queue_.pop();
        } else {
          op = fifo_queue_.front();
          fifo_queue_.pop_front();
        }
      }
      Execute(op);
    }
  }

  struct PrioCmp {
    bool operator()(const OprBlock* a, const OprBlock* b) const {
      return a->priority < b->priority;  // max-heap: higher priority first
    }
  };

  std::mutex vars_mu_;
  std::unordered_map<uint64_t, VarPtr> vars_;
  uint64_t next_var_id_ = 1;

  std::mutex qmu_;
  std::condition_variable qcv_;
  std::deque<OprBlock*> fifo_queue_;
  std::priority_queue<OprBlock*, std::vector<OprBlock*>, PrioCmp> prio_queue_;
  bool stop_ = false;

  std::atomic<long> pending_{0};
  std::mutex done_mu_;
  std::condition_variable done_cv_;

  std::vector<std::thread> workers_;
};

}  // namespace mxtpu

extern "C" {

void* mxtpu_engine_create(int num_workers, int num_prio_workers) {
  return new mxtpu::Engine(num_workers, num_prio_workers);
}

void mxtpu_engine_free(void* e) { delete static_cast<mxtpu::Engine*>(e); }

uint64_t mxtpu_engine_new_var(void* e) {
  return static_cast<mxtpu::Engine*>(e)->NewVar();
}

void mxtpu_engine_delete_var(void* e, uint64_t v) {
  static_cast<mxtpu::Engine*>(e)->DeleteVar(v);
}

int mxtpu_engine_push(void* e, mxtpu::EngineFn fn, void* arg,
                      const uint64_t* cvars, int nc, const uint64_t* mvars,
                      int nm, int prop, int priority) {
  return static_cast<mxtpu::Engine*>(e)->Push(fn, arg, cvars, nc, mvars, nm,
                                              prop, priority);
}

void mxtpu_engine_wait_for_var(void* e, uint64_t v) {
  static_cast<mxtpu::Engine*>(e)->WaitForVar(v);
}

void mxtpu_engine_wait_for_all(void* e) {
  static_cast<mxtpu::Engine*>(e)->WaitForAll();
}

long mxtpu_engine_num_pending(void* e) {
  return static_cast<mxtpu::Engine*>(e)->NumPending();
}

}  // extern "C"
