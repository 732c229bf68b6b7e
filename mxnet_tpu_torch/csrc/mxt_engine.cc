// Dependency engine: the native analog of MXNet's
// ThreadedEnginePerDevice (reference: src/engine/threaded_engine.{h,cc},
// include/mxnet/engine.h).  A copy of the JAX package's src/cpp/
// mxt_engine.cc, built by mxnet_tpu_torch/_native at first use.
//
// Semantics reproduced exactly:
//   * ops are pushed with declared read-var and write-var sets;
//   * conflicting ops (any write overlap) execute in program order,
//     non-conflicting ops run in parallel across a worker pool;
//   * reads on the same var are concurrent; a write is exclusive and
//     ordered after every earlier read/write of that var;
//   * WaitForVar blocks until every pushed op touching the var completed;
//     WaitForAll drains the engine.
//
// The device side is scheduled by CUDA streams; this engine schedules
// the HOST side: record IO, decode, prefetch and any user async task
// (exposed to python through ctypes callbacks).
//
// Design notes vs the reference: one global mutex guarding var state (host
// task granularity here is file/decode work, ~ms; the reference needed
// finer locking for ~us GPU op dispatch), FIFO grant queues per var give
// the same serialization the reference gets from its var queues.

#include <condition_variable>
#include <cstdint>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

extern "C" {
typedef void (*mxt_fn)(void *arg);
}

namespace mxt {

struct Opr;

struct VarState {
  // FIFO of ops waiting for this var; bool = wants write access.
  std::deque<std::pair<Opr *, bool>> queue;
  int active_readers = 0;
  bool active_writer = false;
  uint64_t version = 0;  // bumped on every completed write
};

struct Opr {
  std::function<void()> fn;
  std::vector<int64_t> reads, writes;
  int wait = 0;  // var grants still outstanding
};

class Engine {
 public:
  explicit Engine(int nthreads) {
    if (nthreads < 1) nthreads = 1;
    for (int i = 0; i < nthreads; ++i)
      workers_.emplace_back([this] { WorkerLoop(); });
  }

  ~Engine() {
    WaitAll();
    {
      std::unique_lock<std::mutex> lk(mu_);
      shutdown_ = true;
      ready_cv_.notify_all();
    }
    for (auto &t : workers_) t.join();
  }

  int64_t NewVar() {
    std::unique_lock<std::mutex> lk(mu_);
    int64_t id = next_var_++;
    vars_.emplace(id, VarState{});
    return id;
  }

  void Push(std::function<void()> fn, const int64_t *reads, int nr,
            const int64_t *writes, int nw) {
    auto *op = new Opr();
    op->fn = std::move(fn);
    // dedupe; a var both read and written is a write (reference rule)
    std::unordered_set<int64_t> w(writes, writes + nw), r;
    for (int i = 0; i < nr; ++i)
      if (!w.count(reads[i])) r.insert(reads[i]);
    op->reads.assign(r.begin(), r.end());
    op->writes.assign(w.begin(), w.end());

    std::unique_lock<std::mutex> lk(mu_);
    ++outstanding_;
    op->wait = 0;
    for (int64_t v : op->reads)
      if (!TryGrant(v, op, false)) ++op->wait;
    for (int64_t v : op->writes)
      if (!TryGrant(v, op, true)) ++op->wait;
    if (op->wait == 0) Enqueue(op);
  }

  void WaitForVar(int64_t var) {
    // reference semantics: push a read op on the var, block on it
    std::mutex m;
    std::condition_variable cv;
    bool done = false;
    Push(
        [&] {
          std::unique_lock<std::mutex> lk(m);
          done = true;
          cv.notify_all();
        },
        &var, 1, nullptr, 0);
    std::unique_lock<std::mutex> lk(m);
    cv.wait(lk, [&] { return done; });
  }

  void WaitAll() {
    std::unique_lock<std::mutex> lk(mu_);
    drain_cv_.wait(lk, [this] { return outstanding_ == 0; });
  }

  uint64_t Version(int64_t var) {
    std::unique_lock<std::mutex> lk(mu_);
    auto it = vars_.find(var);
    return it == vars_.end() ? 0 : it->second.version;
  }

 private:
  // mu_ held.  Returns true if access granted immediately.
  bool TryGrant(int64_t v, Opr *op, bool write) {
    VarState &st = vars_[v];
    if (write) {
      if (!st.active_writer && st.active_readers == 0 && st.queue.empty()) {
        st.active_writer = true;
        return true;
      }
    } else {
      if (!st.active_writer && st.queue.empty()) {
        ++st.active_readers;
        return true;
      }
    }
    st.queue.emplace_back(op, write);
    return false;
  }

  // mu_ held.
  void Enqueue(Opr *op) {
    ready_.push_back(op);
    ready_cv_.notify_one();
  }

  // mu_ held.  Release op's grant on v, wake queued successors.
  void Release(int64_t v, bool write) {
    VarState &st = vars_[v];
    if (write) {
      st.active_writer = false;
      ++st.version;
    } else {
      --st.active_readers;
    }
    while (!st.queue.empty()) {
      auto [next, nw] = st.queue.front();
      if (nw) {
        if (st.active_writer || st.active_readers > 0) break;
        st.active_writer = true;
      } else {
        if (st.active_writer) break;
        ++st.active_readers;
      }
      st.queue.pop_front();
      if (--next->wait == 0) Enqueue(next);
      if (nw) break;  // writer granted exclusively; stop draining
    }
  }

  void WorkerLoop() {
    for (;;) {
      Opr *op;
      {
        std::unique_lock<std::mutex> lk(mu_);
        ready_cv_.wait(lk, [this] { return shutdown_ || !ready_.empty(); });
        if (shutdown_ && ready_.empty()) return;
        op = ready_.front();
        ready_.pop_front();
      }
      op->fn();
      {
        std::unique_lock<std::mutex> lk(mu_);
        for (int64_t v : op->reads) Release(v, false);
        for (int64_t v : op->writes) Release(v, true);
        if (--outstanding_ == 0) drain_cv_.notify_all();
      }
      delete op;
    }
  }

  std::mutex mu_;
  std::condition_variable ready_cv_, drain_cv_;
  std::deque<Opr *> ready_;
  std::unordered_map<int64_t, VarState> vars_;
  std::vector<std::thread> workers_;
  int64_t next_var_ = 1;
  int outstanding_ = 0;
  bool shutdown_ = false;
};

}  // namespace mxt

extern "C" {

void *MXTEngineCreate(int nthreads) { return new mxt::Engine(nthreads); }

void MXTEngineDestroy(void *h) { delete static_cast<mxt::Engine *>(h); }

int64_t MXTEngineNewVar(void *h) {
  return static_cast<mxt::Engine *>(h)->NewVar();
}

void MXTEnginePush(void *h, mxt_fn fn, void *arg, const int64_t *reads,
                   int nr, const int64_t *writes, int nw) {
  static_cast<mxt::Engine *>(h)->Push([fn, arg] { fn(arg); }, reads, nr,
                                      writes, nw);
}

void MXTEngineWaitForVar(void *h, int64_t var) {
  static_cast<mxt::Engine *>(h)->WaitForVar(var);
}

void MXTEngineWaitAll(void *h) { static_cast<mxt::Engine *>(h)->WaitAll(); }

uint64_t MXTEngineVarVersion(void *h, int64_t var) {
  return static_cast<mxt::Engine *>(h)->Version(var);
}

// internal-use hook for other translation units (prefetcher)
void MXTEnginePushStd(void *h, std::function<void()> *fn,
                      const int64_t *reads, int nr, const int64_t *writes,
                      int nw) {
  static_cast<mxt::Engine *>(h)->Push(std::move(*fn), reads, nr, writes, nw);
  delete fn;
}

}  // extern "C"
