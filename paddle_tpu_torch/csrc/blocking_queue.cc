// Bounded blocking queue of byte slabs for the host side of the data
// feed: the port's copy of paddle_tpu/core_native/blocking_queue.cc, with
// the same C ABI.
//
// It plays the reference's C++ feeding runtime:
//   * LoDTensorBlockingQueue (operators/reader/lod_tensor_blocking_queue.h)
//     — the bounded producer/consumer channel between Python feeders and
//     the device reader;
//   * BufferedReader (operators/reader/buffered_reader.cc) — prefetch
//     ahead of the device.
//
// One generic MPMC queue with condition-variable blocking; callers drop
// the GIL while they wait (ctypes releases it around every call).  The
// slabs are opaque (malloc'd) bytes that Python maps to batches; the copy
// to the card is the DataLoader's (pinned memory, a side stream).  Host
// C++, built by g++ (core_native._build_queue), not nvcc.
//
// C ABI (ctypes-friendly):
//   void* ptq_create(int capacity)
//   int   ptq_push(void* q, const char* data, long n)   // blocks; 0 ok,
//                                                       // -1 closed
//   long  ptq_pop(void* q, char** out)                  // blocks; size or
//                                                       // -1 closed+empty
//   long  ptq_pop_timed(void* q, char** out, long ms)   // -2 timed out
//   void  ptq_free_buf(char* buf)
//   void  ptq_close(void* q)       // wake all; pops drain, pushes fail
//   int   ptq_size(void* q)
//   int   ptq_capacity(void* q)
//   void  ptq_destroy(void* q)

#include <chrono>
#include <condition_variable>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>

namespace {

struct Buf {
  char* data;
  long size;
};

struct Queue {
  std::mutex mu;
  std::condition_variable not_full;
  std::condition_variable not_empty;
  std::deque<Buf> items;
  int capacity;
  bool closed = false;
};

}  // namespace

extern "C" {

void* ptq_create(int capacity) {
  auto* q = new Queue();
  q->capacity = capacity > 0 ? capacity : 1;
  return q;
}

int ptq_push(void* handle, const char* data, long n) {
  auto* q = static_cast<Queue*>(handle);
  char* copy = static_cast<char*>(std::malloc(n > 0 ? n : 1));
  if (copy == nullptr) return -2;
  std::memcpy(copy, data, n);
  std::unique_lock<std::mutex> lock(q->mu);
  q->not_full.wait(lock, [q] {
    return q->closed || static_cast<int>(q->items.size()) < q->capacity;
  });
  if (q->closed) {
    std::free(copy);
    return -1;
  }
  q->items.push_back({copy, n});
  lock.unlock();
  q->not_empty.notify_one();
  return 0;
}

long ptq_pop(void* handle, char** out) {
  auto* q = static_cast<Queue*>(handle);
  std::unique_lock<std::mutex> lock(q->mu);
  q->not_empty.wait(lock, [q] { return q->closed || !q->items.empty(); });
  if (q->items.empty()) {
    *out = nullptr;
    return -1;  // closed and drained
  }
  Buf b = q->items.front();
  q->items.pop_front();
  lock.unlock();
  q->not_full.notify_one();
  *out = b.data;
  return b.size;
}

long ptq_pop_timed(void* handle, char** out, long timeout_ms) {
  // like ptq_pop but bounded: -2 = timed out (queue still open)
  auto* q = static_cast<Queue*>(handle);
  std::unique_lock<std::mutex> lock(q->mu);
  bool ready = q->not_empty.wait_for(
      lock, std::chrono::milliseconds(timeout_ms),
      [q] { return q->closed || !q->items.empty(); });
  if (!ready) {
    *out = nullptr;
    return -2;
  }
  if (q->items.empty()) {
    *out = nullptr;
    return -1;  // closed and drained
  }
  Buf b = q->items.front();
  q->items.pop_front();
  lock.unlock();
  q->not_full.notify_one();
  *out = b.data;
  return b.size;
}

void ptq_free_buf(char* buf) { std::free(buf); }

void ptq_close(void* handle) {
  auto* q = static_cast<Queue*>(handle);
  {
    std::lock_guard<std::mutex> lock(q->mu);
    q->closed = true;
  }
  q->not_full.notify_all();
  q->not_empty.notify_all();
}

int ptq_size(void* handle) {
  auto* q = static_cast<Queue*>(handle);
  std::lock_guard<std::mutex> lock(q->mu);
  return static_cast<int>(q->items.size());
}

int ptq_capacity(void* handle) {
  return static_cast<Queue*>(handle)->capacity;
}

void ptq_destroy(void* handle) {
  auto* q = static_cast<Queue*>(handle);
  {
    std::lock_guard<std::mutex> lock(q->mu);
    for (auto& b : q->items) std::free(b.data);
    q->items.clear();
  }
  delete q;
}

}  // extern "C"
