// Shared-memory byte ring behind the multi-process DataLoader
// (paddle_tpu_torch/io/shm_ring.py): the transport between a worker
// process and the trainer.
//
// One single-producer/single-consumer ring per worker, in a mmap'd POSIX
// shared-memory segment.  Lock-free: the producer owns `head`, the
// consumer owns `tail` (C++ atomics, release/acquire).  The framing (a
// u64 length before each message) and the payload layout live in Python;
// this file only moves bytes: memcpy into and out of the ring, wrapping
// at the end, sleeping with a short adaptive back-off when it is full or
// empty.
//
// Built with the host C++ compiler (g++ -O2 -shared -fPIC, see
// paddle_tpu_torch/_build.py::build_host) and driven through ctypes, which
// releases the GIL for the whole blocking read or write.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

namespace {

struct RingHeader {
  std::atomic<uint64_t> head;      // bytes written (producer cursor)
  std::atomic<uint64_t> tail;      // bytes consumed (consumer cursor)
  std::atomic<uint32_t> closed;    // producer hung up
  uint32_t _pad;
  uint64_t capacity;               // data area size in bytes
};

struct Ring {
  RingHeader* hdr;
  uint8_t* data;
  size_t map_size;
};

void sleep_ns(long ns) {
  struct timespec ts = {0, ns};
  nanosleep(&ts, nullptr);
}

}  // namespace

extern "C" {

// Create (owner=1) or attach (owner=0) a ring of `capacity` data bytes in
// the shm segment `name`. Returns an opaque handle or null.
void* rb_open(const char* name, uint64_t capacity, int owner) {
  size_t map_size = sizeof(RingHeader) + capacity;
  int flags = owner ? (O_CREAT | O_RDWR | O_EXCL) : O_RDWR;
  int fd = shm_open(name, flags, 0600);
  if (fd < 0 && owner && errno == EEXIST) {
    shm_unlink(name);
    fd = shm_open(name, flags, 0600);
  }
  if (fd < 0) return nullptr;
  if (owner && ftruncate(fd, (off_t)map_size) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, map_size, PROT_READ | PROT_WRITE, MAP_SHARED,
                   fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Ring* r = new Ring;
  r->hdr = reinterpret_cast<RingHeader*>(mem);
  r->data = reinterpret_cast<uint8_t*>(mem) + sizeof(RingHeader);
  r->map_size = map_size;
  if (owner) {
    r->hdr->head.store(0, std::memory_order_relaxed);
    r->hdr->tail.store(0, std::memory_order_relaxed);
    r->hdr->closed.store(0, std::memory_order_relaxed);
    r->hdr->capacity = capacity;
  }
  return r;
}

// Blocking write of n bytes; returns n, or -1 if the consumer vanished
// (ring closed from the read side is not tracked: close is producer->
// consumer only, the parent kills workers on teardown).
int64_t rb_write(void* handle, const uint8_t* buf, uint64_t n) {
  Ring* r = reinterpret_cast<Ring*>(handle);
  RingHeader* h = r->hdr;
  const uint64_t cap = h->capacity;
  if (n > cap) return -1;
  uint64_t written = 0;
  long backoff = 1000;  // 1us
  while (written < n) {
    uint64_t head = h->head.load(std::memory_order_relaxed);
    uint64_t tail = h->tail.load(std::memory_order_acquire);
    uint64_t free_bytes = cap - (head - tail);
    if (free_bytes == 0) {
      sleep_ns(backoff);
      if (backoff < 200000) backoff *= 2;  // cap at 200us
      continue;
    }
    backoff = 1000;
    uint64_t chunk = n - written;
    if (chunk > free_bytes) chunk = free_bytes;
    uint64_t pos = head % cap;
    uint64_t until_wrap = cap - pos;
    uint64_t c1 = chunk < until_wrap ? chunk : until_wrap;
    memcpy(r->data + pos, buf + written, c1);
    if (chunk > c1) memcpy(r->data, buf + written + c1, chunk - c1);
    h->head.store(head + chunk, std::memory_order_release);
    written += chunk;
  }
  return (int64_t)n;
}

// Blocking read of exactly n bytes; returns n, 0 on clean EOF (producer
// closed and ring drained), -1 on protocol error.
int64_t rb_read(void* handle, uint8_t* buf, uint64_t n) {
  Ring* r = reinterpret_cast<Ring*>(handle);
  RingHeader* h = r->hdr;
  const uint64_t cap = h->capacity;
  uint64_t got = 0;
  long backoff = 1000;
  while (got < n) {
    uint64_t tail = h->tail.load(std::memory_order_relaxed);
    uint64_t head = h->head.load(std::memory_order_acquire);
    uint64_t avail = head - tail;
    if (avail == 0) {
      if (h->closed.load(std::memory_order_acquire)) {
        // drained and producer gone
        return got == 0 ? 0 : -1;
      }
      sleep_ns(backoff);
      if (backoff < 200000) backoff *= 2;
      continue;
    }
    backoff = 1000;
    uint64_t chunk = n - got;
    if (chunk > avail) chunk = avail;
    uint64_t pos = tail % cap;
    uint64_t until_wrap = cap - pos;
    uint64_t c1 = chunk < until_wrap ? chunk : until_wrap;
    memcpy(buf + got, r->data + pos, c1);
    if (chunk > c1) memcpy(buf + got + c1, r->data, chunk - c1);
    h->tail.store(tail + chunk, std::memory_order_release);
    got += chunk;
  }
  return (int64_t)got;
}

// Like rb_read but gives up after timeout_us of no progress, returning -2.
// Lets the consumer interleave liveness checks on the producer process
// instead of spinning forever on a worker that died without hanging up.
//
// The timeout ONLY fires before any byte is consumed — once mid-message,
// returning -2 would leave the stream desynced on retry, so the wait is
// extended (30x) and expiry is a hard protocol error (-1).
int64_t rb_read_timeout(void* handle, uint8_t* buf, uint64_t n,
                        uint64_t timeout_us) {
  Ring* r = reinterpret_cast<Ring*>(handle);
  RingHeader* h = r->hdr;
  const uint64_t cap = h->capacity;
  uint64_t got = 0;
  long backoff = 1000;
  uint64_t waited_ns = 0;
  const uint64_t limit_ns = timeout_us * 1000ull;
  while (got < n) {
    uint64_t tail = h->tail.load(std::memory_order_relaxed);
    uint64_t head = h->head.load(std::memory_order_acquire);
    uint64_t avail = head - tail;
    if (avail == 0) {
      if (h->closed.load(std::memory_order_acquire)) {
        return got == 0 ? 0 : -1;
      }
      if (got == 0 && waited_ns >= limit_ns) return -2;
      if (got > 0 && waited_ns >= 30 * limit_ns) return -1;
      sleep_ns(backoff);
      waited_ns += (uint64_t)backoff;
      if (backoff < 200000) backoff *= 2;
      continue;
    }
    backoff = 1000;
    waited_ns = 0;  // progress resets the clock
    uint64_t chunk = n - got;
    if (chunk > avail) chunk = avail;
    uint64_t pos = tail % cap;
    uint64_t until_wrap = cap - pos;
    uint64_t c1 = chunk < until_wrap ? chunk : until_wrap;
    memcpy(buf + got, r->data + pos, c1);
    if (chunk > c1) memcpy(buf + got + c1, r->data, chunk - c1);
    h->tail.store(tail + chunk, std::memory_order_release);
    got += chunk;
  }
  return (int64_t)got;
}

// Producer hang-up: consumer sees EOF after draining.
void rb_close_write(void* handle) {
  Ring* r = reinterpret_cast<Ring*>(handle);
  r->hdr->closed.store(1, std::memory_order_release);
}

void rb_detach(void* handle) {
  Ring* r = reinterpret_cast<Ring*>(handle);
  munmap(r->hdr, r->map_size);
  delete r;
}

void rb_unlink(const char* name) { shm_unlink(name); }

}  // extern "C"
