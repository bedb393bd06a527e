// merlin-tpu native tar-shard streaming loader (the port's copy of the JAX
// package's loader; host code, not a CUDA kernel).
//
// The reference's data path leans on webdataset + torch DataLoader worker
// processes (C-accelerated IO). Hosts feed from this instead: a C++
// thread pool streams tar shards (infinite, seed-shuffled epochs), groups
// members into samples by key (basename up to the first dot), and hands
// serialized samples to Python through a bounded ring queue via ctypes.
//
// Serialized sample layout (little endian):
//   u32 n_fields
//   repeat n_fields: u32 name_len, name bytes, u64 data_len, data bytes
//
// Built at first use by merlin_tpu_torch/data/native_loader.py:
//   c++ -O2 -std=c++17 -fPIC -pthread -shared -> native/build/libmerlin_loader.so

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fstream>
#include <mutex>
#include <map>
#include <random>
#include <set>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Field {
  std::string name;
  std::string data;
};
using Sample = std::vector<Field>;

std::string serialize(const Sample& s) {
  size_t total = 4;
  for (const auto& f : s) total += 4 + f.name.size() + 8 + f.data.size();
  std::string out;
  out.resize(total);
  char* p = out.data();
  auto put_u32 = [&p](uint32_t v) { std::memcpy(p, &v, 4); p += 4; };
  auto put_u64 = [&p](uint64_t v) { std::memcpy(p, &v, 8); p += 8; };
  put_u32(static_cast<uint32_t>(s.size()));
  for (const auto& f : s) {
    put_u32(static_cast<uint32_t>(f.name.size()));
    std::memcpy(p, f.name.data(), f.name.size());
    p += f.name.size();
    put_u64(f.data.size());
    std::memcpy(p, f.data.data(), f.data.size());
    p += f.data.size();
  }
  return out;
}

// --- tar parsing -----------------------------------------------------------

uint64_t parse_octal(const char* s, size_t n) {
  uint64_t v = 0;
  for (size_t i = 0; i < n && s[i]; ++i) {
    if (s[i] < '0' || s[i] > '7') continue;
    v = (v << 3) | static_cast<uint64_t>(s[i] - '0');
  }
  return v;
}

struct TarEntry {
  std::string name;
  std::string data;
  bool is_file;
};

class TarReader {
 public:
  explicit TarReader(const std::string& path) : in_(path, std::ios::binary) {}
  bool ok() const { return in_.good(); }

  bool next(TarEntry* entry) {
    std::string longname;
    while (true) {
      char header[512];
      if (!in_.read(header, 512)) return false;
      bool all_zero = true;
      for (int i = 0; i < 512; ++i)
        if (header[i]) { all_zero = false; break; }
      if (all_zero) return false;  // end-of-archive marker

      uint64_t size = parse_octal(header + 124, 12);
      char type = header[156];
      std::string name(header, strnlen(header, 100));
      // ustar prefix field
      if (std::memcmp(header + 257, "ustar", 5) == 0) {
        std::string prefix(header + 345, strnlen(header + 345, 155));
        if (!prefix.empty()) name = prefix + "/" + name;
      }
      uint64_t padded = (size + 511) & ~511ULL;

      if (type == 'L') {  // GNU long name
        longname.resize(size);
        if (!in_.read(longname.data(), static_cast<std::streamsize>(size)))
          return false;
        // strip trailing NUL
        while (!longname.empty() && longname.back() == '\0')
          longname.pop_back();
        in_.seekg(static_cast<std::streamoff>(padded - size), std::ios::cur);
        continue;
      }
      if (!longname.empty()) {
        name = longname;
        longname.clear();
      }

      entry->name = name;
      entry->is_file = (type == '0' || type == '\0');
      if (entry->is_file) {
        entry->data.resize(size);
        if (size &&
            !in_.read(entry->data.data(), static_cast<std::streamsize>(size)))
          return false;
        in_.seekg(static_cast<std::streamoff>(padded - size), std::ios::cur);
      } else {
        entry->data.clear();
        in_.seekg(static_cast<std::streamoff>(padded), std::ios::cur);
      }
      return true;
    }
  }

 private:
  std::ifstream in_;
};

// --- loader ------------------------------------------------------------------

class Loader {
 public:
  Loader(std::vector<std::string> shards, uint64_t seed, size_t queue_cap,
         int n_threads, uint64_t max_epochs, uint64_t start_index)
      : shards_(std::move(shards)),
        seed_(seed),
        queue_cap_(queue_cap),
        max_epochs_(max_epochs),
        next_shard_(start_index) {
    n_threads = std::max(1, n_threads);
    for (int i = 0; i < n_threads; ++i)
      threads_.emplace_back([this] { worker(); });
  }

  // Resume cursor base: the smallest shard index any worker has claimed
  // but not finished (or the next unclaimed index when idle). Restarting
  // from it replays no finished shard and skips none. Sample granularity
  // comes from the "__shard__" coordinate pushed with every sample: the
  // Python cursor counts consumed samples per shard >= this position and
  // skips exactly that prefix on resume (native_loader.py).
  uint64_t position() {
    std::lock_guard<std::mutex> lk(mu_);
    uint64_t pos = next_shard_;
    if (!in_flight_.empty()) pos = std::min(pos, *in_flight_.begin());
    if (!queued_counts_.empty())
      pos = std::min(pos, queued_counts_.begin()->first);
    return pos;
  }

  ~Loader() { stop(); }

  void stop() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stopping_ = true;
    }
    cv_pop_.notify_all();
    cv_push_.notify_all();
    for (auto& t : threads_)
      if (t.joinable()) t.join();
    threads_.clear();
  }

  // Pops one serialized sample; empty string on shutdown/exhaustion.
  std::string pop() {
    std::unique_lock<std::mutex> lk(mu_);
    cv_pop_.wait(lk, [this] {
      return !queue_.empty() || stopping_ || finished_workers_ == threads_.size();
    });
    if (queue_.empty()) return {};
    QueuedSample out = std::move(queue_.front());
    queue_.pop_front();
    auto it = queued_counts_.find(out.shard);
    if (it != queued_counts_.end() && --it->second == 0)
      queued_counts_.erase(it);
    cv_push_.notify_one();
    return std::move(out.data);
  }

 private:
  // Infinite shard sequence: epoch e = shards shuffled by mt19937(seed+e).
  std::string shard_at(uint64_t index) {
    uint64_t epoch = index / shards_.size();
    uint64_t pos = index % shards_.size();
    std::vector<uint32_t> order(shards_.size());
    for (uint32_t i = 0; i < order.size(); ++i) order[i] = i;
    std::mt19937_64 rng(seed_ + epoch);
    std::shuffle(order.begin(), order.end(), rng);
    return shards_[order[pos]];
  }

  void push(uint64_t shard, Sample&& sample) {
    if (sample.empty()) return;
    // Sample-granular resume coordinate: the global shard index rides
    // with every sample. One worker streams a shard sequentially and the
    // queue is FIFO, so per-shard delivery order is the tar order —
    // skipping the first N delivered samples of a shard reproduces
    // exactly its unconsumed remainder (native_loader.py cursor).
    sample.push_back({"__shard__", std::to_string(shard)});
    std::string ser = serialize(sample);
    std::unique_lock<std::mutex> lk(mu_);
    cv_push_.wait(lk,
                  [this] { return queue_.size() < queue_cap_ || stopping_; });
    if (stopping_) return;
    queue_.push_back(QueuedSample{shard, std::move(ser)});
    ++queued_counts_[shard];
    cv_pop_.notify_one();
  }

  void worker() {
    while (true) {
      uint64_t idx;
      {
        // Claim the index and mark it in-flight under ONE lock hold:
        // position() must never observe next_shard_ advanced past an
        // index that is neither in in_flight_ nor queued (a checkpoint
        // taken in that window would skip the shard on resume).
        std::lock_guard<std::mutex> lk(mu_);
        if (stopping_) break;
        idx = next_shard_;
        if (max_epochs_ && idx >= max_epochs_ * shards_.size()) break;
        ++next_shard_;
        in_flight_.insert(idx);
      }
      struct InFlightGuard {
        Loader* l;
        uint64_t idx;
        ~InFlightGuard() {
          std::lock_guard<std::mutex> lk(l->mu_);
          l->in_flight_.erase(idx);
        }
      } guard{this, idx};
      TarReader reader(shard_at(idx));
      if (!reader.ok()) continue;
      TarEntry entry;
      Sample sample;
      std::string current_key;
      while (reader.next(&entry)) {
        {
          std::lock_guard<std::mutex> lk(mu_);
          if (stopping_) break;
        }
        if (!entry.is_file) continue;
        // basename, split at the FIRST dot: key, field
        size_t slash = entry.name.find_last_of('/');
        std::string base = (slash == std::string::npos)
                               ? entry.name
                               : entry.name.substr(slash + 1);
        size_t dot = base.find('.');
        if (dot == std::string::npos) continue;
        std::string key = base.substr(0, dot);
        std::string field = base.substr(dot + 1);
        std::transform(field.begin(), field.end(), field.begin(), ::tolower);
        if (!current_key.empty() && key != current_key) {
          sample.push_back({"__key__", current_key});
          push(idx, std::move(sample));
          sample = Sample{};
        }
        current_key = key;
        sample.push_back({std::move(field), std::move(entry.data)});
      }
      if (!sample.empty()) {
        sample.push_back({"__key__", current_key});
        push(idx, std::move(sample));
      }
    }
    std::lock_guard<std::mutex> lk(mu_);
    ++finished_workers_;
    cv_pop_.notify_all();
  }

  std::vector<std::string> shards_;
  uint64_t seed_;
  size_t queue_cap_;
  uint64_t max_epochs_;  // 0 = infinite
  std::vector<std::thread> threads_;
  uint64_t next_shard_;           // next unclaimed index (guarded by mu_)
  std::set<uint64_t> in_flight_;  // claimed, not yet finished (guarded by mu_)
  size_t finished_workers_ = 0;

  struct QueuedSample {
    uint64_t shard;
    std::string data;
  };

  std::mutex mu_;
  std::condition_variable cv_pop_, cv_push_;
  std::deque<QueuedSample> queue_;
  std::map<uint64_t, size_t> queued_counts_;  // shard -> queued samples
  bool stopping_ = false;
};

}  // namespace

extern "C" {

void* mtl_open(const char** shard_paths, int n_shards, uint64_t seed,
               int queue_cap, int n_threads, uint64_t max_epochs) {
  std::vector<std::string> shards;
  shards.reserve(n_shards);
  for (int i = 0; i < n_shards; ++i) shards.emplace_back(shard_paths[i]);
  if (shards.empty()) return nullptr;
  return new Loader(std::move(shards), seed,
                    static_cast<size_t>(std::max(1, queue_cap)), n_threads,
                    max_epochs, 0);
}

void* mtl_open_at(const char** shard_paths, int n_shards, uint64_t seed,
                  int queue_cap, int n_threads, uint64_t max_epochs,
                  uint64_t start_index) {
  std::vector<std::string> shards;
  shards.reserve(n_shards);
  for (int i = 0; i < n_shards; ++i) shards.emplace_back(shard_paths[i]);
  if (shards.empty()) return nullptr;
  return new Loader(std::move(shards), seed,
                    static_cast<size_t>(std::max(1, queue_cap)), n_threads,
                    max_epochs, start_index);
}

uint64_t mtl_position(void* handle) {
  return static_cast<Loader*>(handle)->position();
}

// Returns a malloc'd buffer the caller must mtl_free(); *out_len = 0 at end.
char* mtl_next(void* handle, uint64_t* out_len) {
  auto* loader = static_cast<Loader*>(handle);
  std::string s = loader->pop();
  *out_len = s.size();
  if (s.empty()) return nullptr;
  char* buf = static_cast<char*>(std::malloc(s.size()));
  std::memcpy(buf, s.data(), s.size());
  return buf;
}

void mtl_free(char* buf) { std::free(buf); }

void mtl_close(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
