// Threaded record-file data feed: worker threads read fixed-size binary
// records from sharded files, optionally block-shuffle, and emit ready batch
// buffers through a bounded channel.
//
// Host code of the port's input pipeline (paddle_tpu_torch/io/record_feed.py),
// a copy of the reference's feed (csrc/data_feed.cc at the repository root):
// the same reader threads, block shuffle and leftover batching, so the same
// files and seed give the same batches (in the same order with one reader
// thread; with more, the threads' interleaving orders them). Counterpart of
// Paddle's C++ data ingestion (paddle/fluid/framework/data_feed.cc +
// data_set.cc: file-sharded readers pushing into channels, consumed by
// training threads). The consumer copies each batch to the card; keeping the
// read/shuffle/batch path native keeps the Python GIL out of the pipeline.
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include "channel.h"

namespace {

class DataFeed {
 public:
  DataFeed(std::vector<std::string> files, uint64_t record_bytes, uint64_t batch_size,
           int nworkers, uint64_t queue_capacity, bool shuffle, uint64_t seed,
           bool drop_last)
      : files_(std::move(files)),
        record_bytes_(record_bytes),
        batch_size_(batch_size),
        nworkers_(nworkers < 1 ? 1 : nworkers),
        shuffle_(shuffle),
        seed_(seed),
        drop_last_(drop_last),
        channel_(queue_capacity ? queue_capacity : 8) {}

  ~DataFeed() { Shutdown(); }

  void StartEpoch() {
    Shutdown();
    channel_.Reopen();
    stop_.store(false);
    next_file_.store(0);
    done_workers_.store(0);
    // leftover records from all workers are batched by the closer thread so
    // at most one partial batch per epoch escapes (matches drop_last=False
    // python DataLoader semantics, not one partial per file)
    leftovers_.clear();
    epoch_seed_ = seed_++;
    for (int i = 0; i < nworkers_; ++i) {
      workers_.emplace_back([this, i] { WorkerLoop(i); });
    }
  }

  // Returns batch byte size, 0 when the epoch is exhausted.
  uint64_t Next(std::vector<uint8_t>* out) {
    if (channel_.Get(out)) return out->size();
    return 0;
  }

 private:
  void Shutdown() {
    stop_.store(true);
    channel_.Close();
    for (auto& t : workers_)
      if (t.joinable()) t.join();
    workers_.clear();
  }

  void WorkerLoop(int worker_id) {
    std::mt19937_64 rng(epoch_seed_ * 1000003 + worker_id);
    std::vector<uint8_t> batch;
    batch.reserve(batch_size_ * record_bytes_);
    // dynamic file claiming: workers pull the next unread file (the reference
    // assigns file shards to readers; claiming balances skewed file sizes)
    for (;;) {
      size_t fi = next_file_.fetch_add(1);
      if (fi >= files_.size() || stop_.load()) break;
      ReadFile(files_[fi], &batch, &rng);
    }
    // flush complete batches; stash the partial remainder for the closer
    if (!stop_.load() && !batch.empty()) {
      std::lock_guard<std::mutex> lk(leftover_mu_);
      leftovers_.insert(leftovers_.end(), batch.begin(), batch.end());
    }
    if (done_workers_.fetch_add(1) + 1 == nworkers_) {
      // last worker out: emit the combined leftovers then close
      std::vector<uint8_t> tail;
      {
        std::lock_guard<std::mutex> lk(leftover_mu_);
        tail = std::move(leftovers_);
        leftovers_.clear();
      }
      uint64_t bb = batch_size_ * record_bytes_;
      size_t off = 0;
      while (tail.size() - off >= bb) {
        channel_.Put(std::vector<uint8_t>(tail.begin() + off, tail.begin() + off + bb));
        off += bb;
      }
      if (off < tail.size() && !drop_last_) {
        channel_.Put(std::vector<uint8_t>(tail.begin() + off, tail.end()));
      }
      channel_.Close();
    }
  }

  void ReadFile(const std::string& path, std::vector<uint8_t>* batch, std::mt19937_64* rng) {
    std::FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) return;
    // block shuffle: read up to kShuffleBlock records, permute, then batch —
    // bounded-memory approximation of a global shuffle
    const uint64_t kShuffleBlock = std::max<uint64_t>(batch_size_ * 16, 1024);
    std::vector<uint8_t> block;
    block.reserve(kShuffleBlock * record_bytes_);
    std::vector<uint8_t> rec(record_bytes_);
    for (;;) {
      size_t n = std::fread(rec.data(), 1, record_bytes_, f);
      bool eof = n < record_bytes_;
      if (n == record_bytes_) block.insert(block.end(), rec.begin(), rec.end());
      bool block_full = block.size() >= kShuffleBlock * record_bytes_;
      if ((eof || block_full) && !block.empty()) {
        uint64_t nrec = block.size() / record_bytes_;
        std::vector<uint32_t> order(nrec);
        for (uint64_t i = 0; i < nrec; ++i) order[i] = static_cast<uint32_t>(i);
        if (shuffle_) std::shuffle(order.begin(), order.end(), *rng);
        for (uint32_t idx : order) {
          batch->insert(batch->end(), block.begin() + idx * record_bytes_,
                        block.begin() + (idx + 1) * record_bytes_);
          if (batch->size() == batch_size_ * record_bytes_) {
            if (!channel_.Put(std::move(*batch))) {
              std::fclose(f);
              return;
            }
            batch->clear();
          }
        }
        block.clear();
      }
      if (eof || stop_.load()) break;
    }
    std::fclose(f);
  }

  std::vector<std::string> files_;
  uint64_t record_bytes_, batch_size_;
  int nworkers_;
  bool shuffle_;
  uint64_t seed_, epoch_seed_ = 0;
  bool drop_last_;
  pt::ByteChannel channel_;
  std::vector<std::thread> workers_;
  std::atomic<bool> stop_{false};
  std::atomic<size_t> next_file_{0};
  std::atomic<int> done_workers_{0};
  std::mutex leftover_mu_;
  std::vector<uint8_t> leftovers_;
};

}  // namespace

extern "C" {

// files: newline-joined paths.
void* pt_feed_create(const char* files, uint64_t record_bytes, uint64_t batch_size,
                     int nworkers, uint64_t queue_capacity, int shuffle,
                     uint64_t seed, int drop_last) {
  std::vector<std::string> file_list;
  const char* p = files;
  while (p && *p) {
    const char* nl = std::strchr(p, '\n');
    if (nl) {
      if (nl > p) file_list.emplace_back(p, nl - p);
      p = nl + 1;
    } else {
      file_list.emplace_back(p);
      break;
    }
  }
  if (file_list.empty() || record_bytes == 0 || batch_size == 0) return nullptr;
  return new DataFeed(std::move(file_list), record_bytes, batch_size, nworkers,
                      queue_capacity, shuffle != 0, seed, drop_last != 0);
}

void pt_feed_start_epoch(void* f) { static_cast<DataFeed*>(f)->StartEpoch(); }

// Returns batch byte length (caller frees *out via pt_buffer_free), 0 at
// epoch end.
uint64_t pt_feed_next(void* f, void** out) {
  std::vector<uint8_t> buf;
  uint64_t n = static_cast<DataFeed*>(f)->Next(&buf);
  if (n == 0) return 0;
  void* p = std::malloc(n);
  std::memcpy(p, buf.data(), n);
  *out = p;
  return n;
}

void pt_feed_destroy(void* f) { delete static_cast<DataFeed*>(f); }

}  // extern "C"
