// Native host runtime for smc-tpu.
//
// The reference's host runtime is Ray's scheduler/object store plus
// SUNDIALS/numba in the compute path (SURVEY.md §2). In this framework the
// compute path is XLA/Pallas on the TPU; the host-side runtime work that
// remains — artifact IO off the critical path and reference-grade oracle
// kernels — lives here as native code:
//
//  1. Async checkpoint writer: a background thread draining a snapshot
//     queue, so the SMC driver never blocks on disk while streaming
//     per-step (particles, log_lik, gamma, key) snapshots (the reference
//     blocks its driver on np.savetxt every step,
//     SMC_methanation_main.py:422).
//  2. residual_systematic_cpp: the exact sequential Algorithm 2
//     (SMC_Algorithm/algorithm2.png; Micmem_SMC_main.py:146-184) as the
//     golden oracle for the vectorized TPU resampler.
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).
//
// Checkpoint container format ("SMCK"):
//   magic  u32 = 0x534D434B
//   n_arrays u32
//   per array: name_len u32, name bytes, dtype_code u32 (0=f32, 1=f64,
//              2=i32, 3=i64, 4=u32), ndim u32, shape i64*ndim, data bytes
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Array {
  std::string name;
  uint32_t dtype;
  std::vector<int64_t> shape;
  std::vector<uint8_t> data;
};

struct Snapshot {
  std::string path;
  std::vector<Array> arrays;
};

constexpr uint32_t kMagic = 0x534D434Bu;  // "SMCK"

size_t dtype_size(uint32_t code) {
  switch (code) {
    case 0: return 4;  // f32
    case 1: return 8;  // f64
    case 2: return 4;  // i32
    case 3: return 8;  // i64
    case 4: return 4;  // u32
    default: return 0;
  }
}

bool write_snapshot(const Snapshot& s) {
  std::string tmp = s.path + ".tmp";
  FILE* f = std::fopen(tmp.c_str(), "wb");
  if (!f) return false;
  auto put = [&](const void* p, size_t n) {
    return std::fwrite(p, 1, n, f) == n;
  };
  uint32_t n_arrays = static_cast<uint32_t>(s.arrays.size());
  bool ok = put(&kMagic, 4) && put(&n_arrays, 4);
  for (const Array& a : s.arrays) {
    if (!ok) break;
    uint32_t name_len = static_cast<uint32_t>(a.name.size());
    uint32_t ndim = static_cast<uint32_t>(a.shape.size());
    ok = put(&name_len, 4) && put(a.name.data(), name_len) &&
         put(&a.dtype, 4) && put(&ndim, 4) &&
         put(a.shape.data(), 8 * ndim) &&
         put(a.data.data(), a.data.size());
  }
  ok = (std::fclose(f) == 0) && ok;
  if (ok) ok = (std::rename(tmp.c_str(), s.path.c_str()) == 0);
  if (!ok) std::remove(tmp.c_str());
  return ok;
}

class CkptWriter {
 public:
  CkptWriter() : stop_(false), errors_(0), written_(0) {
    thread_ = std::thread([this] { Loop(); });
  }

  ~CkptWriter() { Close(); }

  void Submit(Snapshot&& s) {
    {
      std::lock_guard<std::mutex> g(mu_);
      queue_.push_back(std::move(s));
    }
    cv_.notify_one();
  }

  void Flush() {
    std::unique_lock<std::mutex> g(mu_);
    drained_.wait(g, [this] { return queue_.empty() && !busy_; });
  }

  void Close() {
    {
      std::lock_guard<std::mutex> g(mu_);
      if (stop_) return;
      stop_ = true;
    }
    cv_.notify_one();
    if (thread_.joinable()) thread_.join();
  }

  int64_t errors() const { return errors_.load(); }
  int64_t written() const { return written_.load(); }

 private:
  void Loop() {
    for (;;) {
      Snapshot s;
      {
        std::unique_lock<std::mutex> g(mu_);
        cv_.wait(g, [this] { return stop_ || !queue_.empty(); });
        if (queue_.empty()) {
          if (stop_) return;
          continue;
        }
        s = std::move(queue_.front());
        queue_.pop_front();
        busy_ = true;
      }
      if (write_snapshot(s)) {
        written_.fetch_add(1);
      } else {
        errors_.fetch_add(1);
      }
      {
        std::lock_guard<std::mutex> g(mu_);
        busy_ = false;
      }
      drained_.notify_all();
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable drained_;
  std::deque<Snapshot> queue_;
  bool busy_ = false;
  bool stop_;
  std::atomic<int64_t> errors_;
  std::atomic<int64_t> written_;
  std::thread thread_;
};

// Builder for the in-flight snapshot (single-threaded driver side).
struct Builder {
  Snapshot snap;
};

}  // namespace

extern "C" {

void* ckpt_writer_open() { return new CkptWriter(); }

void* ckpt_begin(const char* path) {
  Builder* b = new Builder();
  b->snap.path = path;
  return b;
}

int ckpt_add_array(void* builder, const char* name, uint32_t dtype_code,
                   uint32_t ndim, const int64_t* shape, const void* data) {
  Builder* b = static_cast<Builder*>(builder);
  size_t esz = dtype_size(dtype_code);
  if (esz == 0) return -1;
  int64_t count = 1;
  for (uint32_t i = 0; i < ndim; ++i) count *= shape[i];
  Array a;
  a.name = name;
  a.dtype = dtype_code;
  a.shape.assign(shape, shape + ndim);
  a.data.resize(static_cast<size_t>(count) * esz);
  std::memcpy(a.data.data(), data, a.data.size());
  b->snap.arrays.push_back(std::move(a));
  return 0;
}

void ckpt_submit(void* writer, void* builder) {
  Builder* b = static_cast<Builder*>(builder);
  static_cast<CkptWriter*>(writer)->Submit(std::move(b->snap));
  delete b;
}

void ckpt_writer_flush(void* writer) {
  static_cast<CkptWriter*>(writer)->Flush();
}

int64_t ckpt_writer_errors(void* writer) {
  return static_cast<CkptWriter*>(writer)->errors();
}

int64_t ckpt_writer_written(void* writer) {
  return static_cast<CkptWriter*>(writer)->written();
}

void ckpt_writer_close(void* writer) {
  CkptWriter* w = static_cast<CkptWriter*>(writer);
  w->Flush();
  w->Close();
  delete w;
}

// Sequential residual-systematic resampling (Algorithm 2), the golden
// oracle: counts[j] = trunc(N*w_j) + systematic extras from one uniform
// draw wrand_unit in [0, 1) scaled by 1/N.
void residual_systematic_cpp(const double* w, int64_t n, double wrand_unit,
                             int32_t* counts) {
  double inv_np = 1.0 / static_cast<double>(n);
  double wrand = wrand_unit * inv_np;
  double sum = 0.0;
  for (int64_t j = 0; j < n; ++j) {
    double scaled = w[j] * static_cast<double>(n);
    int32_t det = static_cast<int32_t>(scaled);  // trunc toward zero, w>=0
    counts[j] = det;
    double resid = w[j] - det * inv_np;
    sum += resid;
    if (sum >= wrand) {
      counts[j] += 1;
      wrand += inv_np;
    }
  }
}

}  // extern "C"
