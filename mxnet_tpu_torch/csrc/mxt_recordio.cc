// Native RecordIO reader + pooled buffer allocator + batch prefetcher.
//
// Reference analogs (a copy of the JAX package's src/cpp/mxt_recordio.cc):
//   * RecordIO layout:  3rdparty/dmlc-core/include/dmlc/recordio.h —
//     [kMagic:u32][cflag<<29|len:u32][payload][pad4] per part, multi-part
//     records chained via cflag 1/2/3.  Byte-compatible with the python
//     module (mxnet_tpu_torch/recordio.py) and the reference's im2rec output.
//   * Pooled allocator:  src/storage/pooled_storage_manager.h — power-of-2
//     size-class freelists so steady-state batch reads never hit malloc.
//   * Prefetcher:  src/io/iter_prefetcher.h + dmlc ThreadedIter — batch
//     jobs are pushed to the dependency engine (mxt_engine.cc) with a
//     write-var per slot; completed batches are consumed FIFO.
//
// All file reads use pread(2): no shared seek state, so one reader handle
// serves every engine worker concurrently.

#include <fcntl.h>
#include <unistd.h>

#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <map>
#include <mutex>
#include <string>
#include <vector>

extern "C" void MXTEnginePushStd(void *, std::function<void()> *,
                                 const int64_t *, int, const int64_t *, int);
extern "C" int64_t MXTEngineNewVar(void *);

namespace mxt {

static const uint32_t kMagic = 0xced7230a;

// ---------------------------------------------------------------- pool ----
class BufferPool {
 public:
  static BufferPool &Get() {
    static BufferPool pool;
    return pool;
  }

  void *Alloc(size_t size) {
    int cls = SizeClass(size);
    {
      std::unique_lock<std::mutex> lk(mu_);
      auto &fl = free_[cls];
      if (!fl.empty()) {
        void *p = fl.back();
        fl.pop_back();
        ++hits_;
        return p;
      }
      ++misses_;
    }
    return std::malloc(size_t(1) << cls);
  }

  void Free(void *p, size_t size) {
    int cls = SizeClass(size);
    std::unique_lock<std::mutex> lk(mu_);
    auto &fl = free_[cls];
    if (fl.size() < kMaxPerClass) {
      fl.push_back(p);
      return;
    }
    lk.unlock();
    std::free(p);
  }

  void Stats(int64_t *hits, int64_t *misses) {
    std::unique_lock<std::mutex> lk(mu_);
    *hits = hits_;
    *misses = misses_;
  }

 private:
  static int SizeClass(size_t size) {
    int cls = 6;  // min 64B
    while ((size_t(1) << cls) < size) ++cls;
    return cls;
  }

  static const size_t kMaxPerClass = 16;
  std::mutex mu_;
  std::vector<void *> free_[48];
  int64_t hits_ = 0, misses_ = 0;
};

// -------------------------------------------------------------- reader ----
struct Rec {
  int64_t offset;  // of first part header
  int64_t size;    // total payload bytes (parts joined)
};

class RecordReader {
 public:
  // returns nullptr + error message on failure
  static RecordReader *Open(const char *path, std::string *err) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) {
      *err = "cannot open " + std::string(path);
      return nullptr;
    }
    auto *r = new RecordReader(fd);
    if (!r->BuildIndex(err)) {
      delete r;
      return nullptr;
    }
    return r;
  }

  ~RecordReader() { ::close(fd_); }

  int64_t Count() const { return int64_t(recs_.size()); }

  bool InRange(int64_t i) const {
    return i >= 0 && size_t(i) < recs_.size();
  }

  int64_t Size(int64_t i) const {
    return InRange(i) ? recs_[size_t(i)].size : -1;
  }

  int64_t Offset(int64_t i) const {
    return InRange(i) ? recs_[size_t(i)].offset : -1;
  }

  // read record i into out (caller sizes it via Size); true on success
  bool Read(int64_t i, uint8_t *out) const {
    if (!InRange(i)) return false;
    const Rec &rec = recs_[size_t(i)];
    int64_t off = rec.offset;
    uint8_t *dst = out;
    for (;;) {
      uint32_t hdr[2];
      if (::pread(fd_, hdr, 8, off) != 8) return false;
      if (hdr[0] != kMagic) return false;
      uint32_t cflag = hdr[1] >> 29, len = hdr[1] & ((1u << 29) - 1);
      if (::pread(fd_, dst, len, off + 8) != ssize_t(len)) return false;
      dst += len;
      off += 8 + ((len + 3) & ~3u);
      if (cflag == 0 || cflag == 3) return true;
    }
  }

 private:
  explicit RecordReader(int fd) : fd_(fd) {}

  bool BuildIndex(std::string *err) {
    int64_t fsize = ::lseek(fd_, 0, SEEK_END);
    int64_t off = 0;
    while (off + 8 <= fsize) {
      int64_t start = off, total = 0;
      for (;;) {
        uint32_t hdr[2];
        if (::pread(fd_, hdr, 8, off) != 8) {
          *err = "truncated record header";
          return false;
        }
        if (hdr[0] != kMagic) {
          *err = "bad magic at offset " + std::to_string(off);
          return false;
        }
        uint32_t cflag = hdr[1] >> 29, len = hdr[1] & ((1u << 29) - 1);
        total += len;
        off += 8 + ((len + 3) & ~3u);
        if (cflag == 0 || cflag == 3) break;
        if (off + 8 > fsize) {
          *err = "truncated multi-part record";
          return false;
        }
      }
      recs_.push_back({start, total});
    }
    return true;
  }

  int fd_;
  std::vector<Rec> recs_;
};

// ---------------------------------------------------------- prefetcher ----
// A scheduled batch = one engine op: pread every record of the batch into
// one pooled buffer (concatenated, with an offsets table).  Slot write-vars
// bound how many batches EXECUTE concurrently; completed batches buffer in
// done_ until consumed, so total memory is paced by the CALLER keeping
// scheduled-consumed small (ImageRecordIter schedules capacity+1 ahead) —
// same contract as iter_prefetcher.h's bounded queue with a free-running
// producer.  Consumption is FIFO in schedule order.
struct Batch {
  uint8_t *data = nullptr;
  int64_t *offsets = nullptr;  // n+1 entries
  int64_t n = 0;
  int64_t bytes = 0;
  bool ok = true;
};

class Prefetcher {
 public:
  Prefetcher(RecordReader *reader, void *engine, int capacity)
      : reader_(reader), engine_(engine),
        capacity_(capacity < 1 ? 1 : capacity) {
    for (int i = 0; i < capacity_; ++i)
      slot_vars_.push_back(MXTEngineNewVar(engine_));
  }

  // caller must have drained the engine (wait_all) first
  ~Prefetcher() {
    std::unique_lock<std::mutex> lk(mu_);
    for (auto &kv : done_) FreeBatch(kv.second);
    done_.clear();
  }

  static void FreeBatch(const Batch &b) {
    BufferPool::Get().Free(b.data, size_t(b.bytes ? b.bytes : 1));
    BufferPool::Get().Free(b.offsets, (size_t(b.n) + 1) * sizeof(int64_t));
  }

  void Schedule(const int64_t *indices, int n) {
    std::vector<int64_t> idx(indices, indices + n);
    int64_t slot_var, seq;
    {
      std::unique_lock<std::mutex> lk(mu_);
      slot_var = slot_vars_[size_t(next_slot_++ % capacity_)];
      seq = scheduled_++;
    }
    auto *fn = new std::function<void()>([this, seq,
                                          idx = std::move(idx)] {
      Batch b;
      b.n = int64_t(idx.size());
      int64_t total = 0;
      for (int64_t i : idx) {
        if (!reader_->InRange(i)) { b.ok = false; continue; }
        total += reader_->Size(i);
      }
      b.bytes = total;
      b.data = static_cast<uint8_t *>(BufferPool::Get().Alloc(
          size_t(total) ? size_t(total) : 1));
      b.offsets = static_cast<int64_t *>(
          BufferPool::Get().Alloc((size_t(b.n) + 1) * sizeof(int64_t)));
      int64_t off = 0;
      for (int64_t j = 0; j < b.n; ++j) {
        b.offsets[j] = off;
        if (!reader_->InRange(idx[size_t(j)])) { b.ok = false; continue; }
        if (!reader_->Read(idx[size_t(j)], b.data + off)) b.ok = false;
        off += reader_->Size(idx[size_t(j)]);
      }
      b.offsets[b.n] = off;
      std::unique_lock<std::mutex> lk(mu_);
      done_.emplace(seq, b);
      cv_.notify_all();
    });
    // write-dep on the slot var serializes reuse of the same slot while
    // distinct slots run in parallel across engine workers
    MXTEnginePushStd(engine_, fn, nullptr, 0, &slot_var, 1);
  }

  // blocks; batches come out in SCHEDULE order (reference ThreadedIter
  // contract) regardless of completion order across slots.  Returns false
  // if every scheduled batch was already consumed.
  bool Next(Batch *out) {
    std::unique_lock<std::mutex> lk(mu_);
    if (consumed_ == scheduled_) return false;
    int64_t want = consumed_;
    cv_.wait(lk, [&] { return done_.count(want) != 0; });
    *out = done_[want];
    done_.erase(want);
    ++consumed_;
    return true;
  }

 private:
  RecordReader *reader_;
  void *engine_;
  int capacity_;
  std::vector<int64_t> slot_vars_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::map<int64_t, Batch> done_;
  int64_t next_slot_ = 0, scheduled_ = 0, consumed_ = 0;
};

}  // namespace mxt

// ---------------------------------------------------------------- C ABI ----
extern "C" {

static thread_local std::string mxt_last_error;

const char *MXTGetLastError() { return mxt_last_error.c_str(); }

void *MXTRecordReaderCreate(const char *path) {
  std::string err;
  mxt::RecordReader *r = mxt::RecordReader::Open(path, &err);
  if (!r) mxt_last_error = err;
  return r;
}

void MXTRecordReaderDestroy(void *h) {
  delete static_cast<mxt::RecordReader *>(h);
}

int64_t MXTRecordReaderCount(void *h) {
  return static_cast<mxt::RecordReader *>(h)->Count();
}

int64_t MXTRecordReaderSize(void *h, int64_t i) {
  return static_cast<mxt::RecordReader *>(h)->Size(i);
}

int64_t MXTRecordReaderOffset(void *h, int64_t i) {
  return static_cast<mxt::RecordReader *>(h)->Offset(i);
}

int MXTRecordReaderRead(void *h, int64_t i, uint8_t *out) {
  return static_cast<mxt::RecordReader *>(h)->Read(i, out) ? 0 : -1;
}

void *MXTPrefetcherCreate(void *reader, void *engine, int capacity) {
  return new mxt::Prefetcher(static_cast<mxt::RecordReader *>(reader),
                             engine, capacity);
}

void MXTPrefetcherDestroy(void *h) {
  delete static_cast<mxt::Prefetcher *>(h);
}

void MXTPrefetcherSchedule(void *h, const int64_t *indices, int n) {
  static_cast<mxt::Prefetcher *>(h)->Schedule(indices, n);
}

int MXTPrefetcherNext(void *h, uint8_t **data, int64_t **offsets,
                      int64_t *n, int64_t *bytes) {
  mxt::Batch b;
  if (!static_cast<mxt::Prefetcher *>(h)->Next(&b)) return -1;
  if (!b.ok) {
    mxt::Prefetcher::FreeBatch(b);
    mxt_last_error = "record read failed";
    return -2;
  }
  *data = b.data;
  *offsets = b.offsets;
  *n = b.n;
  *bytes = b.bytes;
  return 0;
}

void MXTBatchFree(uint8_t *data, int64_t *offsets, int64_t n,
                  int64_t bytes) {
  mxt::BufferPool::Get().Free(data, size_t(bytes ? bytes : 1));
  mxt::BufferPool::Get().Free(offsets, (size_t(n) + 1) * sizeof(int64_t));
}

void MXTPoolStats(int64_t *hits, int64_t *misses) {
  mxt::BufferPool::Get().Stats(hits, misses);
}

}  // extern "C"
