// Frame pump: a lock-guarded ring buffer + dedicated writer thread that
// feeds raw rgb24 frames to a file descriptor (ffmpeg stdin, RTMP pipe,
// file). The render loop must hold a strict 25 FPS cadence; a slow or
// bursty encoder must apply backpressure in C++ (off the Python thread /
// GIL), not stall the loop that dispatches the frames. Counterpart of the subprocess
// plumbing around the reference's readQueueWorkerProcess
// (mq_consume/ConsumeMQByWebRTC.py:87-133), built as a native component the
// way the reference builds its hot paths natively.
//
// Build: g++ -O2 -shared -fPIC -pthread framepump.cpp -o libframepump.so
// API (ctypes, see ../framepump.py): fp_create / fp_push / fp_pending /
// fp_error / fp_close.

#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <poll.h>
#include <unistd.h>

namespace {

struct Pump {
  int fd = -1;
  size_t frame_bytes = 0;
  size_t capacity = 0;          // ring slots
  std::vector<uint8_t> ring;    // capacity * frame_bytes
  // producer/consumer positions are monotonically increasing frame counts
  uint64_t head = 0;            // next slot to fill (producer)
  uint64_t tail = 0;            // next slot to drain (consumer)
  bool stopping = false;
  std::atomic<bool> abort_flag{false};  // close(): give up on a stalled sink
  std::atomic<bool> done{false};        // writer_loop exited
  std::atomic<long> written{0};
  std::atomic<long> bytes_out{0};  // close() watches BYTE progress: a sink
                                   // draining a 6 MB frame slower than the
                                   // patience window is healthy, not wedged
  std::atomic<int> error{0};    // errno of the first failed write
  std::mutex m;
  std::condition_variable nonempty;
  std::condition_variable nonfull;
  std::thread worker;
};

void writer_loop(Pump* p) {
  // Non-blocking writes + poll: a blocking ::write into a full pipe (a
  // stalled encoder) would pin this thread with no abort path — fp_close's
  // join would then hang the whole process. O_NONBLOCK is a property of
  // OUR file description (the pipe's write end); the child's read end is
  // a different description and is unaffected.
  int fl = fcntl(p->fd, F_GETFL, 0);
  if (fl >= 0) fcntl(p->fd, F_SETFL, fl | O_NONBLOCK);
  for (;;) {
    uint64_t t;
    {
      std::unique_lock<std::mutex> lk(p->m);
      p->nonempty.wait(lk, [p] { return p->stopping || p->head != p->tail; });
      if (p->head == p->tail) {  // stopping and drained
        p->done.store(true);
        return;
      }
      t = p->tail;
    }
    const uint8_t* src = p->ring.data() + (t % p->capacity) * p->frame_bytes;
    size_t off = 0;
    int err = 0;
    while (off < p->frame_bytes) {
      if (p->abort_flag.load()) {
        err = EPIPE;  // close() gave up on a stalled sink
        break;
      }
      ssize_t n = ::write(p->fd, src + off, p->frame_bytes - off);
      if (n > 0) {
        off += static_cast<size_t>(n);
        p->bytes_out.fetch_add(n);
        continue;
      }
      if (n < 0 && errno == EINTR) continue;
      if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        struct pollfd pf;
        pf.fd = p->fd;
        pf.events = POLLOUT;
        pf.revents = 0;
        ::poll(&pf, 1, 100);  // bounded wait, then re-check abort_flag
        continue;
      }
      err = errno ? errno : EIO;
      break;
    }
    if (err) {
      p->error.store(err);
      std::lock_guard<std::mutex> lk(p->m);
      p->stopping = true;
      p->tail = p->head;  // drop queue; nothing more can be written
      p->nonfull.notify_all();
      p->done.store(true);
      return;
    }
    {
      std::lock_guard<std::mutex> lk(p->m);
      p->tail = t + 1;
      p->written.fetch_add(1);
      p->nonfull.notify_all();
    }
  }
}

}  // namespace

extern "C" {

void* fp_create(int fd, long frame_bytes, long capacity) {
  if (fd < 0 || frame_bytes <= 0 || capacity <= 0) return nullptr;
  Pump* p = new Pump();
  p->fd = fd;
  p->frame_bytes = static_cast<size_t>(frame_bytes);
  p->capacity = static_cast<size_t>(capacity);
  p->ring.resize(p->frame_bytes * p->capacity);
  p->worker = std::thread(writer_loop, p);
  return p;
}

// Blocks (in C++, GIL released by ctypes) while the ring is full — encoder
// backpressure. Returns 0 on success, the sink's errno once it has failed.
int fp_push(void* h, const uint8_t* data) {
  Pump* p = static_cast<Pump*>(h);
  std::unique_lock<std::mutex> lk(p->m);
  p->nonfull.wait(lk, [p] {
    return p->stopping || (p->head - p->tail) < p->capacity;
  });
  if (p->stopping) return p->error.load() ? p->error.load() : EPIPE;
  uint64_t s = p->head;
  std::memcpy(p->ring.data() + (s % p->capacity) * p->frame_bytes, data,
              p->frame_bytes);
  p->head = s + 1;
  p->nonempty.notify_one();
  return 0;
}

long fp_pending(void* h) {
  Pump* p = static_cast<Pump*>(h);
  std::lock_guard<std::mutex> lk(p->m);
  return static_cast<long>(p->head - p->tail);
}

int fp_error(void* h) { return static_cast<Pump*>(h)->error.load(); }

// Drain remaining frames, stop the worker, return frames written
// (negated errno if the sink failed). Drain patience is PROGRESS-based at
// BYTE granularity: as long as the sink accepts any bytes the queue keeps
// flushing (a 1080p rgb24 frame is ~6 MB — a slow-but-healthy encoder can
// legitimately take >5 s per frame), but 5 s with no byte accepted
// (encoder wedged, RTMP zero-window) aborts so close() is always bounded —
// the old unconditional join could hang the serving process forever.
long fp_close(void* h) {
  Pump* p = static_cast<Pump*>(h);
  {
    std::lock_guard<std::mutex> lk(p->m);
    p->stopping = true;
    p->nonempty.notify_all();
    p->nonfull.notify_all();
  }
  long last = p->bytes_out.load();
  int idle_ms = 0;
  while (!p->done.load() && idle_ms < 5000) {
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
    long w = p->bytes_out.load();
    if (w != last) {
      last = w;
      idle_ms = 0;
    } else {
      idle_ms += 50;
    }
  }
  if (!p->done.load()) p->abort_flag.store(true);
  if (p->worker.joinable()) p->worker.join();
  long out = p->error.load() ? -static_cast<long>(p->error.load())
                             : p->written.load();
  delete p;
  return out;
}

}  // extern "C"
