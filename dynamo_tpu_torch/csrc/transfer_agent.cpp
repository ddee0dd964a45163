// dtpu transfer agent: host-staging KV block transfer over TCP, the port's
// copy of the reference package's native agent (native/transfer/agent.cpp).
//
// The bulk wire for KV pages between hosts: a serving engine gathers the
// pages of a fetch on the card into staging slots of a pinned host arena
// (one page-copy launch, one device-to-host copy; engine/transfer.py), and
// this agent moves the slots' bytes host to host with scatter/gather TCP,
// outside the Python request plane, which carries only the slot numbers.
//
// Model:
//   * an agent owns a listening socket + N connection threads;
//   * Python registers fixed memory regions (arenas) sliced into equal-size
//     blocks; registration is id -> (base, block_bytes, num_blocks);
//   * a fetch request names (region_id, block indices); the agent responds
//     with the concatenated block payload via writev (no staging copy);
//   * the client side (dtpu_fetch) gathers remote blocks into a caller
//     buffer with one connection per call.
//
// Wire protocol (little-endian), byte for byte the reference's, so that a
// port client reads a reference agent and the other way round:
//   request:  u32 magic 0x64747055 ("dtpU"), u64 region_id, u64 n,
//             u64 ids[n]
//   response: u32 status (0 ok), u64 total_bytes, payload
//
// C ABI only, bound with ctypes (transfer/native.py). Host code: built
// with g++ at first use, never with nvcc.

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

#include <atomic>
#include <limits.h>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#ifndef IOV_MAX
#define IOV_MAX 1024
#endif

namespace {

constexpr uint32_t kMagic = 0x64747055u;
constexpr uint64_t kMaxIds = 1u << 20;  // sanity bound on one fetch

struct Region {
  char* base = nullptr;
  uint64_t block_bytes = 0;
  uint64_t num_blocks = 0;
};

struct Agent {
  int listen_fd = -1;
  int port = 0;
  std::atomic<bool> stopping{false};
  std::atomic<int> active_conns{0};
  std::thread acceptor;
  std::mutex mu;  // guards regions + conn_fds
  std::unordered_map<uint64_t, Region> regions;
  std::vector<int> conn_fds;  // open connection sockets (for shutdown)
};

bool read_exact(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) {
      if (r < 0 && (errno == EINTR)) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_exact(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

// writev with full-write semantics over an iovec list.
bool writev_all(int fd, std::vector<iovec>& iov) {
  size_t idx = 0;
  while (idx < iov.size()) {
    int cnt = static_cast<int>(std::min<size_t>(iov.size() - idx, IOV_MAX));
    ssize_t r = ::writev(fd, &iov[idx], cnt);
    if (r < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    size_t done = static_cast<size_t>(r);
    while (idx < iov.size() && done >= iov[idx].iov_len) {
      done -= iov[idx].iov_len;
      ++idx;
    }
    if (idx < iov.size() && done > 0) {
      iov[idx].iov_base = static_cast<char*>(iov[idx].iov_base) + done;
      iov[idx].iov_len -= done;
    }
  }
  return true;
}

void fail(int fd) {
  uint32_t status = 1;
  uint64_t zero = 0;
  (void)write_exact(fd, &status, 4);
  (void)write_exact(fd, &zero, 8);
}

void serve_conn(Agent* a, int fd) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  // detached thread: registration in conn_fds lets dtpu_agent_free unblock
  // a recv() stuck on a dead/partitioned client via shutdown(fd)
  for (;;) {
    uint32_t magic = 0;
    if (!read_exact(fd, &magic, 4) || magic != kMagic) break;
    uint64_t region_id = 0, n = 0;
    if (!read_exact(fd, &region_id, 8) || !read_exact(fd, &n, 8)) break;
    if (n == 0 || n > kMaxIds) {
      fail(fd);
      break;
    }
    std::vector<uint64_t> ids(n);
    if (!read_exact(fd, ids.data(), n * 8)) break;

    Region reg;
    {
      std::lock_guard<std::mutex> lk(a->mu);
      auto it = a->regions.find(region_id);
      if (it == a->regions.end()) {
        fail(fd);
        continue;
      }
      reg = it->second;
    }
    bool ok = true;
    for (uint64_t id : ids) {
      if (id >= reg.num_blocks) {
        ok = false;
        break;
      }
    }
    if (!ok) {
      fail(fd);
      continue;
    }
    uint32_t status = 0;
    uint64_t total = n * reg.block_bytes;
    std::vector<iovec> iov;
    iov.reserve(n + 2);
    iov.push_back({&status, 4});
    iov.push_back({&total, 8});
    for (uint64_t id : ids) {
      iov.push_back({reg.base + id * reg.block_bytes,
                     static_cast<size_t>(reg.block_bytes)});
    }
    if (!writev_all(fd, iov)) break;
  }
  // deregister BEFORE close: the kernel reuses fd numbers immediately, so
  // closing first could make this erase remove a newly-accepted connection's
  // entry and leave it invisible to dtpu_agent_free's shutdown sweep
  {
    std::lock_guard<std::mutex> lk(a->mu);
    for (auto it = a->conn_fds.begin(); it != a->conn_fds.end(); ++it) {
      if (*it == fd) {
        a->conn_fds.erase(it);
        break;
      }
    }
  }
  ::close(fd);
  a->active_conns.fetch_sub(1);
}

void accept_loop(Agent* a) {
  for (;;) {
    int fd = ::accept(a->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (a->stopping.load()) return;
      if (errno == EINTR) continue;
      return;
    }
    if (a->stopping.load()) {
      ::close(fd);
      return;
    }
    {
      std::lock_guard<std::mutex> lk(a->mu);
      a->conn_fds.push_back(fd);
    }
    a->active_conns.fetch_add(1);
    std::thread(serve_conn, a, fd).detach();
  }
}

int connect_to(const char* host, int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    ::close(fd);
    return -1;
  }
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    ::close(fd);
    return -1;
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return fd;
}

}  // namespace

extern "C" {

// Returns an agent handle listening on bind_host:port (port 0 = ephemeral),
// or nullptr on failure.
void* dtpu_agent_new(const char* bind_host, int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, bind_host, &addr.sin_addr) != 1) {
    ::close(fd);
    return nullptr;
  }
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      ::listen(fd, 64) != 0) {
    ::close(fd);
    return nullptr;
  }
  socklen_t len = sizeof(addr);
  ::getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &len);

  Agent* a = new Agent();
  a->listen_fd = fd;
  a->port = ntohs(addr.sin_port);
  a->acceptor = std::thread(accept_loop, a);
  return a;
}

int dtpu_agent_port(void* agent) {
  return agent ? static_cast<Agent*>(agent)->port : -1;
}

// Register (or replace) a memory region. The caller owns the memory and must
// keep it alive until dtpu_agent_free / re-registration.
int dtpu_agent_register(void* agent, uint64_t region_id, void* base,
                        uint64_t block_bytes, uint64_t num_blocks) {
  if (!agent || !base || block_bytes == 0) return -1;
  Agent* a = static_cast<Agent*>(agent);
  std::lock_guard<std::mutex> lk(a->mu);
  a->regions[region_id] =
      Region{static_cast<char*>(base), block_bytes, num_blocks};
  return 0;
}

int dtpu_agent_unregister(void* agent, uint64_t region_id) {
  if (!agent) return -1;
  Agent* a = static_cast<Agent*>(agent);
  std::lock_guard<std::mutex> lk(a->mu);
  return a->regions.erase(region_id) ? 0 : -1;
}

// Returns 0 when the agent was fully torn down, 1 when connection threads
// failed to drain and the Agent was intentionally leaked. A leaked agent's
// threads may still read registered regions: the CALLER MUST keep every
// registered buffer alive for the process lifetime on rc=1 (the Python
// wrapper parks them in a graveyard) — freeing them would be a use-after-free
// in the leaked writev path.
int dtpu_agent_free(void* agent) {
  if (!agent) return 0;
  Agent* a = static_cast<Agent*>(agent);
  a->stopping.store(true);
  ::shutdown(a->listen_fd, SHUT_RDWR);
  ::close(a->listen_fd);
  if (a->acceptor.joinable()) a->acceptor.join();
  // unblock any conn thread stuck in recv() on a dead client, then wait
  // (bounded) for the detached threads to drain before freeing
  {
    std::lock_guard<std::mutex> lk(a->mu);
    for (int fd : a->conn_fds) ::shutdown(fd, SHUT_RDWR);
  }
  for (int spins = 0; a->active_conns.load() > 0 && spins < 5000; ++spins) {
    ::usleep(1000);
  }
  if (a->active_conns.load() > 0) return 1;  // leak rather than free under a race
  delete a;
  return 0;
}

// Blocking gather of n blocks from a remote agent into dst (must hold
// n * block_bytes as advertised by the serving region). Returns bytes
// received, or a negative errno-style code.
long long dtpu_fetch(const char* host, int port, uint64_t region_id,
                     const uint64_t* block_ids, uint64_t n, void* dst,
                     uint64_t dst_bytes) {
  if (!host || !block_ids || !dst || n == 0) return -22;  // EINVAL
  int fd = connect_to(host, port);
  if (fd < 0) return -111;  // ECONNREFUSED
  long long result = -5;    // EIO
  do {
    std::vector<char> req(4 + 8 + 8 + n * 8);
    std::memcpy(req.data(), &kMagic, 4);
    std::memcpy(req.data() + 4, &region_id, 8);
    std::memcpy(req.data() + 12, &n, 8);
    std::memcpy(req.data() + 20, block_ids, n * 8);
    if (!write_exact(fd, req.data(), req.size())) break;
    uint32_t status = 0;
    uint64_t total = 0;
    if (!read_exact(fd, &status, 4) || !read_exact(fd, &total, 8)) break;
    if (status != 0) {
      result = -2;  // ENOENT: bad region / ids
      break;
    }
    if (total > dst_bytes) {
      result = -27;  // EFBIG
      break;
    }
    if (!read_exact(fd, dst, total)) break;
    result = static_cast<long long>(total);
  } while (false);
  ::close(fd);
  return result;
}

}  // extern "C"
