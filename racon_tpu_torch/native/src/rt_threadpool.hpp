// Minimal work-stealing-free thread pool with futures and a per-thread index
// map (so each worker can own a reusable POA aligner, the way the reference
// gives each thread its own spoa engine — racon src/polisher.cpp:
// 176,179-183,497-503). New implementation, parity with the vendored
// thread_pool library's Submit/thread_map surface.
#pragma once

#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <functional>
#include <future>
#include <mutex>
#include <queue>
#include <stdexcept>
#include <thread>
#include <unordered_map>
#include <vector>

namespace rt {

class ThreadPool {
 public:
  explicit ThreadPool(uint32_t num_threads) {
    num_threads = num_threads == 0 ? 1 : num_threads;
    for (uint32_t i = 0; i < num_threads; ++i) {
      workers_.emplace_back([this] { loop(); });
    }
    // thread_map_ is filled after the workers start, but workers only read
    // it from inside a job, and every job is handed over through mutex_:
    // the ctor's writes happen-before submit()'s lock release on the
    // submitting thread, which happens-before the worker's lock acquire.
    // After the ctor the map is never mutated, so lock-free reads in
    // this_thread_index() are safe.
    for (uint32_t i = 0; i < num_threads; ++i) {
      thread_map_[workers_[i].get_id()] = i;
    }
  }

  // Shutdown: the stop flag is set under the queue lock (a worker between
  // its predicate check and cv_.wait can never miss the notify), workers
  // drain whatever is still queued, then exit.
  ~ThreadPool() {
    {
      std::unique_lock<std::mutex> lock(mutex_);
      done_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) {
      w.join();
    }
  }

  template <typename F>
  std::future<void> submit(F&& f) {
    auto task = std::make_shared<std::packaged_task<void()>>(std::forward<F>(f));
    auto fut = task->get_future();
    {
      std::unique_lock<std::mutex> lock(mutex_);
      if (done_) {
        // A task enqueued after shutdown began would be destroyed unrun
        // while its future blocks forever; refuse loudly instead.
        throw std::runtime_error("rt::ThreadPool: submit after shutdown");
      }
      queue_.emplace([task] { (*task)(); });
    }
    cv_.notify_one();
    return fut;
  }

  // Mid-flight cancellation: drop every job no worker has picked up yet.
  // Returns the number dropped. The dropped packaged_tasks are destroyed
  // unrun outside the lock, so their futures throw std::future_error
  // (broken_promise) — callers awaiting cancelled work unblock with an
  // error instead of hanging. Jobs already running are unaffected and the
  // pool stays usable.
  std::size_t cancel_pending() {
    std::queue<std::function<void()>> dropped;
    {
      std::unique_lock<std::mutex> lock(mutex_);
      dropped.swap(queue_);
    }
    return dropped.size();
  }

  uint32_t num_threads() const { return static_cast<uint32_t>(workers_.size()); }

  // Index of the calling thread: workers get 0..n-1; any non-pool caller
  // (e.g. the Python driver finishing device-rejected work) gets the
  // dedicated slot n, so its scratch state never races a worker's.
  uint32_t this_thread_index() const {
    auto it = thread_map_.find(std::this_thread::get_id());
    return it == thread_map_.end() ? static_cast<uint32_t>(workers_.size())
                                   : it->second;
  }

 private:
  void loop() {
    while (true) {
      std::function<void()> job;
      {
        std::unique_lock<std::mutex> lock(mutex_);
        // Explicit wait loop: the stop flag and the queue are re-checked
        // under the lock after every wake-up, so a spurious wake, a
        // cancel_pending() draining the queue between notify and wake, or
        // a shutdown racing a submit can never pop from an empty queue or
        // miss the stop request.
        while (!done_ && queue_.empty()) {
          cv_.wait(lock);
        }
        if (queue_.empty()) {
          return;  // stop requested and no work left to drain
        }
        job = std::move(queue_.front());
        queue_.pop();
      }
      job();
    }
  }

  std::vector<std::thread> workers_;
  std::unordered_map<std::thread::id, uint32_t> thread_map_;
  std::queue<std::function<void()>> queue_;
  std::mutex mutex_;
  std::condition_variable cv_;
  bool done_ = false;
};

}  // namespace rt
