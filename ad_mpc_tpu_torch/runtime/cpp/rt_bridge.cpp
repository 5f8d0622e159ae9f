// Native host-runtime bridge for the MPC control loop (a copy of the JAX
// package's ad_mpc_tpu/runtime/cpp/rt_bridge.cpp for the PyTorch port).
//
// This is the framework's replacement for the transport/scheduling layer the
// reference gets from ROS1 (TCPROS pub/sub with tcp_nodelay on the
// latency-critical topics, rospy.Rate loops — gp_ad_mpc_node.py:131-152).
// The control loop itself stays in Python; everything latency-critical
// around it — message transport, wait-free handoff between the I/O thread
// and the solve loop, and deadline-tracked periodic scheduling — is native.
//
// Components (all C ABI, consumed via ctypes):
//  - SPSC ring buffer: wait-free single-producer/single-consumer slots for
//    state snapshots handed from the receive thread to the control loop.
//    The "latest wins" pop_latest models a control loop that always wants
//    the freshest state (the reference's callback-overwrites-self.x
//    pattern, made explicit and race-free).
//  - UDP pub/sub: datagram transport for state/control/reference messages
//    between nodes (controller, simulator bridge, reference generator).
//  - Rate timer: absolute-deadline periodic scheduler (clock_nanosleep on
//    CLOCK_MONOTONIC) returning per-tick lateness so the caller can track
//    p50/p99 jitter against the 20 ms control budget.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <ctime>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------- SPSC ring

struct Spsc {
  char* slots;          // n_slots * slot_size bytes
  uint32_t* lens;       // payload length per slot
  size_t slot_size;
  size_t n_slots;
  std::atomic<uint64_t> head;  // next write index (producer)
  std::atomic<uint64_t> tail;  // next read index (consumer)
};

Spsc* spsc_create(size_t slot_size, size_t n_slots) {
  Spsc* q = new Spsc();
  q->slots = static_cast<char*>(std::malloc(slot_size * n_slots));
  q->lens = static_cast<uint32_t*>(std::malloc(sizeof(uint32_t) * n_slots));
  q->slot_size = slot_size;
  q->n_slots = n_slots;
  q->head.store(0, std::memory_order_relaxed);
  q->tail.store(0, std::memory_order_relaxed);
  return q;
}

void spsc_destroy(Spsc* q) {
  std::free(q->slots);
  std::free(q->lens);
  delete q;
}

// 0 on success, -1 if full.
int spsc_push(Spsc* q, const void* data, size_t len) {
  if (len > q->slot_size) return -2;
  uint64_t head = q->head.load(std::memory_order_relaxed);
  uint64_t tail = q->tail.load(std::memory_order_acquire);
  if (head - tail >= q->n_slots) return -1;  // full
  size_t idx = head % q->n_slots;
  std::memcpy(q->slots + idx * q->slot_size, data, len);
  q->lens[idx] = static_cast<uint32_t>(len);
  q->head.store(head + 1, std::memory_order_release);
  return 0;
}

// 0 on success, -1 if empty.
int spsc_pop(Spsc* q, void* out, size_t max_len, uint32_t* len_out) {
  uint64_t tail = q->tail.load(std::memory_order_relaxed);
  uint64_t head = q->head.load(std::memory_order_acquire);
  if (tail == head) return -1;  // empty
  size_t idx = tail % q->n_slots;
  uint32_t len = q->lens[idx];
  if (len > max_len) return -2;
  std::memcpy(out, q->slots + idx * q->slot_size, len);
  *len_out = len;
  q->tail.store(tail + 1, std::memory_order_release);
  return 0;
}

// Pop only the newest entry, discarding older ones ("latest state wins").
// Returns number of discarded entries, or -1 if empty.
int spsc_pop_latest(Spsc* q, void* out, size_t max_len, uint32_t* len_out) {
  uint64_t head = q->head.load(std::memory_order_acquire);
  uint64_t tail = q->tail.load(std::memory_order_relaxed);
  if (tail == head) return -1;
  uint64_t newest = head - 1;
  size_t idx = newest % q->n_slots;
  uint32_t len = q->lens[idx];
  if (len > max_len) return -2;
  std::memcpy(out, q->slots + idx * q->slot_size, len);
  *len_out = len;
  q->tail.store(head, std::memory_order_release);
  return static_cast<int>(newest - tail);
}

int spsc_size(Spsc* q) {
  return static_cast<int>(
      q->head.load(std::memory_order_acquire) -
      q->tail.load(std::memory_order_acquire));
}

// --------------------------------------------------------------- UDP pub/sub

// Returns a connected datagram socket fd, or -1.
int udp_pub_create(const char* host, int port) {
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    close(fd);
    return -1;
  }
  if (connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    close(fd);
    return -1;
  }
  return fd;
}

int udp_send(int fd, const void* data, size_t len) {
  ssize_t n = send(fd, data, len, 0);
  // Pub/sub semantics: nobody listening (ICMP port unreachable on a
  // connected datagram socket) is a dropped message, not an error.
  if (n < 0 && (errno == ECONNREFUSED || errno == EAGAIN)) return 0;
  return static_cast<int>(n);
}

// Bound receive socket with SO_RCVBUF and SO_REUSEADDR.
int udp_sub_create(int port, int rcvbuf) {
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  if (rcvbuf > 0)
    setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
  sockaddr_in addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    close(fd);
    return -1;
  }
  return fd;
}

// Receive with millisecond timeout; returns length, 0 on timeout/empty,
// -1 on error. timeout_ms == 0 polls (non-blocking); < 0 blocks forever.
int udp_recv(int fd, void* buf, size_t max_len, int timeout_ms) {
  int flags = 0;
  if (timeout_ms == 0) {
    flags = MSG_DONTWAIT;
  } else if (timeout_ms > 0) {
    timeval tv;
    tv.tv_sec = timeout_ms / 1000;
    tv.tv_usec = (timeout_ms % 1000) * 1000;
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  }
  ssize_t n = recv(fd, buf, max_len, flags);
  if (n < 0)
    return (errno == EAGAIN || errno == EWOULDBLOCK || errno == ECONNREFUSED)
               ? 0 : -1;
  return static_cast<int>(n);
}

void udp_close(int fd) { close(fd); }

// ---------------------------------------------------------------- rate timer

struct Rate {
  timespec next;
  long period_ns;
};

uint64_t monotonic_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000000000ull + ts.tv_nsec;
}

Rate* rate_create(double hz) {
  Rate* r = new Rate();
  r->period_ns = static_cast<long>(1e9 / hz);
  clock_gettime(CLOCK_MONOTONIC, &r->next);
  return r;
}

static void ts_add(timespec* ts, long ns) {
  ts->tv_nsec += ns;
  while (ts->tv_nsec >= 1000000000l) {
    ts->tv_nsec -= 1000000000l;
    ts->tv_sec += 1;
  }
}

// Sleep until the next absolute deadline. Returns lateness in seconds
// (negative = woke early, should not happen; large positive = overrun).
// On overrun > one period, re-anchors to now to avoid deadline pile-up.
double rate_sleep(Rate* r) {
  ts_add(&r->next, r->period_ns);
  timespec now;
  clock_gettime(CLOCK_MONOTONIC, &now);
  double late = (now.tv_sec - r->next.tv_sec) +
                1e-9 * (now.tv_nsec - r->next.tv_nsec);
  if (late > 1e-9 * r->period_ns) {
    r->next = now;  // overrun: re-anchor
    return late;
  }
  clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &r->next, nullptr);
  clock_gettime(CLOCK_MONOTONIC, &now);
  return (now.tv_sec - r->next.tv_sec) +
         1e-9 * (now.tv_nsec - r->next.tv_nsec);
}

void rate_destroy(Rate* r) { delete r; }

}  // extern "C"
