// Bounded blocking byte-buffer channel: the concurrency primitive under the
// native data feed (data_feed.cc). A copy of the reference's csrc/channel.h.
//
// Semantics of Paddle's channel as its C++ data ingestion uses it
// (paddle/fluid/framework/channel.h, data_feed.cc, data_set.cc): fixed
// capacity, blocking put/get, close() drains remaining items then reports
// end-of-stream.
#pragma once

#include <condition_variable>
#include <cstdint>
#include <deque>
#include <mutex>
#include <vector>

namespace pt {

class ByteChannel {
 public:
  explicit ByteChannel(size_t capacity) : capacity_(capacity) {}

  // Returns false if the channel is closed.
  bool Put(std::vector<uint8_t>&& buf) {
    std::unique_lock<std::mutex> lk(mu_);
    not_full_.wait(lk, [&] { return closed_ || q_.size() < capacity_; });
    if (closed_) return false;
    q_.push_back(std::move(buf));
    not_empty_.notify_one();
    return true;
  }

  // Returns false when closed AND drained.
  bool Get(std::vector<uint8_t>* out) {
    std::unique_lock<std::mutex> lk(mu_);
    not_empty_.wait(lk, [&] { return closed_ || !q_.empty(); });
    if (q_.empty()) return false;
    *out = std::move(q_.front());
    q_.pop_front();
    not_full_.notify_one();
    return true;
  }

  void Close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    not_empty_.notify_all();
    not_full_.notify_all();
  }

  void Reopen() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = false;
    q_.clear();
  }

  size_t Size() {
    std::lock_guard<std::mutex> lk(mu_);
    return q_.size();
  }

  bool Closed() {
    std::lock_guard<std::mutex> lk(mu_);
    return closed_;
  }

 private:
  size_t capacity_;
  bool closed_ = false;
  std::deque<std::vector<uint8_t>> q_;
  std::mutex mu_;
  std::condition_variable not_empty_, not_full_;
};

}  // namespace pt
