// miniredis — a minimal single-threaded epoll RESP2 server covering exactly
// the command surface RedisRequestQueue speaks (request_queue.py:183-268):
// RPUSH/LPOP/BLPOP/LLEN/LINDEX for the request list, GET/SET/SETEX/DEL with
// expiry for result keys, plus PING/SELECT/CLIENT/EXPIRE/EXISTS/TTL/FLUSHALL
// so stock clients (redis-py or utils/resp.py) connect cleanly, and INFO
// (used_memory/maxmemory) for observability. Memory is BOUNDED: see the
// accounting block below (MINIREDIS_MAX_BYTES).
//
// Purpose: the reference's multi-replica mode assumes a Redis deployment
// (reference main.py:35-49); this gives the split-role serving topology
// (ROLE=api fronts + ROLE=engine consumer) a dependency-free queue hop that
// lives OUTSIDE the serving process's GIL. Single-threaded event loop: every
// command is O(1)-ish on in-memory structures, so one core sustains far more
// ops than the serving tier generates.
//
// Build: native/build.sh  →  miniredis binary next to this file.
// Run:   miniredis [port]   (default 6379, binds 127.0.0.1 only)
//
// Not a general Redis: no RESP3, no AUTH, no persistence, no cluster. HELLO
// answers -ERR so redis-py negotiates down to RESP2.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <deque>
#include <string>
#include <unordered_map>
#include <vector>

using Clock = std::chrono::steady_clock;
using Ms = std::chrono::milliseconds;

static double now_s() {
  return std::chrono::duration<double>(Clock::now().time_since_epoch()).count();
}

struct StringVal {
  std::string data;
  double expires_at = 0.0;  // 0 = no expiry
};

struct Conn {
  int fd;
  std::string in;    // unparsed inbound bytes
  std::string out;   // pending outbound bytes
  bool blocked = false;
  std::string blocked_key;
  double block_deadline = 0.0;  // 0 = forever
};

struct Waiter {
  int fd;
  double deadline;  // 0 = forever
};

static std::unordered_map<std::string, StringVal> g_strings;
static std::unordered_map<std::string, std::deque<std::string>> g_lists;
static std::unordered_map<std::string, std::deque<Waiter>> g_waiters;  // FIFO
static std::unordered_map<int, Conn> g_conns;
static int g_epfd = -1;

// ---------------------------------------------------------------------------
// bounded memory: approximate byte accounting over strings + list items.
// MINIREDIS_MAX_BYTES env (default 1 GiB, 0 = unlimited). Writes that would
// exceed the cap first trigger an expired-key sweep, then get Redis's -OOM
// ("noeviction" semantics — the queue producer sees backpressure, never a
// silently growing server). Expired-but-unclaimed SETEX results are also
// reaped by a periodic sweep (lazy expiry alone would leak them until read).
// ---------------------------------------------------------------------------

static size_t g_mem = 0;
static size_t g_max_mem = (size_t)1 << 30;
static double g_last_sweep = 0.0;

static size_t sv_bytes(const std::string &key, const std::string &val) {
  return key.size() + val.size() + 64;  // entry overhead approximation
}
static size_t item_bytes(const std::string &val) { return val.size() + 32; }

static void sweep_expired() {
  double now = now_s();
  for (auto it = g_strings.begin(); it != g_strings.end();) {
    if (it->second.expires_at > 0 && it->second.expires_at <= now) {
      g_mem -= sv_bytes(it->first, it->second.data);
      it = g_strings.erase(it);
    } else {
      ++it;
    }
  }
  g_last_sweep = now;
}

// would adding `incoming` bytes exceed the cap (after trying a sweep)?
static bool mem_reject(size_t incoming) {
  if (g_max_mem == 0 || g_mem + incoming <= g_max_mem) return false;
  sweep_expired();
  return g_mem + incoming > g_max_mem;
}

// ---------------------------------------------------------------------------
// RESP encoding
// ---------------------------------------------------------------------------

static void reply_simple(Conn &c, const char *s) {
  c.out += '+'; c.out += s; c.out += "\r\n";
}
static void reply_error(Conn &c, const std::string &msg) {
  c.out += "-ERR " + msg + "\r\n";
}
static void reply_oom(Conn &c) {
  // matches Redis's noeviction wire format ("-OOM ...", no ERR prefix) so
  // redis-py raises its OutOfMemoryError subclass, not a generic error
  c.out += "-OOM command not allowed when used memory > 'maxmemory'\r\n";
}
static void reply_int(Conn &c, long long v) {
  c.out += ':' + std::to_string(v) + "\r\n";
}
static void reply_bulk(Conn &c, const std::string &s) {
  c.out += '$' + std::to_string(s.size()) + "\r\n" + s + "\r\n";
}
static void reply_null_bulk(Conn &c) { c.out += "$-1\r\n"; }
static void reply_null_array(Conn &c) { c.out += "*-1\r\n"; }
static void reply_array_hdr(Conn &c, size_t n) {
  c.out += '*' + std::to_string(n) + "\r\n";
}

// ---------------------------------------------------------------------------
// helpers
// ---------------------------------------------------------------------------

static void want_write(Conn &c) {
  epoll_event ev{};
  ev.events = EPOLLIN | (c.out.empty() ? 0 : EPOLLOUT);
  ev.data.fd = c.fd;
  epoll_ctl(g_epfd, EPOLL_CTL_MOD, c.fd, &ev);
}

static StringVal *get_string(const std::string &key) {
  auto it = g_strings.find(key);
  if (it == g_strings.end()) return nullptr;
  if (it->second.expires_at > 0 && it->second.expires_at <= now_s()) {
    g_mem -= sv_bytes(it->first, it->second.data);
    g_strings.erase(it);
    return nullptr;
  }
  return &it->second;
}

static void unblock_drop(int fd) {
  // remove fd from any waiter queue (on close or after serving)
  for (auto &kv : g_waiters) {
    auto &dq = kv.second;
    for (auto it = dq.begin(); it != dq.end();) {
      if (it->fd == fd) it = dq.erase(it); else ++it;
    }
  }
}

// serve blocked BLPOP clients of `key` while items remain (FIFO fairness)
static void drain_waiters(const std::string &key) {
  auto wit = g_waiters.find(key);
  if (wit == g_waiters.end()) return;
  auto lit = g_lists.find(key);
  while (lit != g_lists.end() && !lit->second.empty() && !wit->second.empty()) {
    Waiter w = wit->second.front();
    wit->second.pop_front();
    auto cit = g_conns.find(w.fd);
    if (cit == g_conns.end() || !cit->second.blocked) continue;  // stale
    Conn &c = cit->second;
    std::string val = lit->second.front();
    lit->second.pop_front();
    g_mem -= item_bytes(val);
    reply_array_hdr(c, 2);
    reply_bulk(c, key);
    reply_bulk(c, val);
    c.blocked = false;
    want_write(c);
  }
  if (lit != g_lists.end() && lit->second.empty()) g_lists.erase(lit);
  if (wit->second.empty()) g_waiters.erase(wit);
}

static std::string upper(std::string s) {
  for (auto &ch : s) ch = (char)toupper((unsigned char)ch);
  return s;
}

// ---------------------------------------------------------------------------
// command dispatch
// ---------------------------------------------------------------------------

static void run_command(Conn &c, std::vector<std::string> &args) {
  std::string cmd = upper(args[0]);
  size_t n = args.size();

  if (cmd == "PING") { reply_simple(c, "PONG"); return; }
  if (cmd == "SELECT" || cmd == "CLIENT" || cmd == "RESET") {
    reply_simple(c, "OK"); return;  // accepted no-ops for client handshakes
  }
  if (cmd == "HELLO") { reply_error(c, "unknown command 'HELLO'"); return; }
  if (cmd == "ECHO" && n == 2) { reply_bulk(c, args[1]); return; }
  if (cmd == "FLUSHALL" || cmd == "FLUSHDB") {
    g_strings.clear(); g_lists.clear(); g_mem = 0; reply_simple(c, "OK"); return;
  }
  if (cmd == "INFO") {
    std::string s = "# Memory\r\nused_memory:" + std::to_string(g_mem) +
                    "\r\nmaxmemory:" + std::to_string(g_max_mem) + "\r\n";
    reply_bulk(c, s);
    return;
  }

  if (cmd == "RPUSH" || cmd == "LPUSH") {
    if (n < 3) { reply_error(c, "wrong number of arguments"); return; }
    size_t incoming = 0;
    for (size_t i = 2; i < n; i++) incoming += item_bytes(args[i]);
    if (mem_reject(incoming)) {
      reply_oom(c);
      return;
    }
    auto &dq = g_lists[args[1]];
    for (size_t i = 2; i < n; i++) {
      if (cmd == "RPUSH") dq.push_back(args[i]);
      else dq.push_front(args[i]);
    }
    g_mem += incoming;
    reply_int(c, (long long)dq.size());
    drain_waiters(args[1]);
    return;
  }
  if (cmd == "LPOP" || cmd == "RPOP") {
    if (n != 2) { reply_error(c, "wrong number of arguments"); return; }
    auto it = g_lists.find(args[1]);
    if (it == g_lists.end() || it->second.empty()) { reply_null_bulk(c); return; }
    std::string v;
    if (cmd == "LPOP") { v = it->second.front(); it->second.pop_front(); }
    else { v = it->second.back(); it->second.pop_back(); }
    g_mem -= item_bytes(v);
    if (it->second.empty()) g_lists.erase(it);
    reply_bulk(c, v);
    return;
  }
  if (cmd == "BLPOP") {
    if (n != 3) { reply_error(c, "wrong number of arguments"); return; }
    auto it = g_lists.find(args[1]);
    if (it != g_lists.end() && !it->second.empty()) {
      std::string v = it->second.front();
      it->second.pop_front();
      g_mem -= item_bytes(v);
      if (it->second.empty()) g_lists.erase(it);
      reply_array_hdr(c, 2);
      reply_bulk(c, args[1]);
      reply_bulk(c, v);
      return;
    }
    double timeout = atof(args[2].c_str());
    c.blocked = true;
    c.blocked_key = args[1];
    c.block_deadline = timeout > 0 ? now_s() + timeout : 0.0;
    g_waiters[args[1]].push_back({c.fd, c.block_deadline});
    return;  // reply deferred
  }
  if (cmd == "LLEN") {
    auto it = g_lists.find(args[1]);
    reply_int(c, it == g_lists.end() ? 0 : (long long)it->second.size());
    return;
  }
  if (cmd == "LINDEX") {
    if (n != 3) { reply_error(c, "wrong number of arguments"); return; }
    auto it = g_lists.find(args[1]);
    long long i = atoll(args[2].c_str());
    if (it == g_lists.end()) { reply_null_bulk(c); return; }
    auto &dq = it->second;
    if (i < 0) i += (long long)dq.size();
    if (i < 0 || i >= (long long)dq.size()) { reply_null_bulk(c); return; }
    reply_bulk(c, dq[(size_t)i]);
    return;
  }

  if (cmd == "SET" || cmd == "SETEX") {
    if ((cmd == "SET" && n < 3) || (cmd == "SETEX" && n != 4)) {
      reply_error(c, "wrong number of arguments");
      return;
    }
    StringVal v;
    if (cmd == "SET") {
      v = {args[2], 0.0};
      for (size_t i = 3; i + 1 < n; i += 2) {
        std::string o = upper(args[i]);
        if (o == "EX") v.expires_at = now_s() + atof(args[i + 1].c_str());
        else if (o == "PX") v.expires_at = now_s() + atof(args[i + 1].c_str()) / 1e3;
      }
    } else {
      v = {args[3], now_s() + atof(args[2].c_str())};
    }
    auto old = g_strings.find(args[1]);
    size_t old_b = old == g_strings.end() ? 0 : sv_bytes(old->first, old->second.data);
    size_t new_b = sv_bytes(args[1], v.data);
    if (new_b > old_b && mem_reject(new_b - old_b)) {
      reply_oom(c);
      return;
    }
    g_mem += new_b - old_b;
    g_strings[args[1]] = std::move(v);
    reply_simple(c, "OK");
    return;
  }
  if (cmd == "GET") {
    StringVal *v = get_string(args[1]);
    if (!v) { reply_null_bulk(c); return; }
    reply_bulk(c, v->data);
    return;
  }
  if (cmd == "DEL" || cmd == "UNLINK") {
    long long cnt = 0;
    for (size_t i = 1; i < n; i++) {
      StringVal *sv = get_string(args[i]);
      if (sv) {
        cnt++;
        g_mem -= sv_bytes(args[i], sv->data);
        g_strings.erase(args[i]);
      }
      auto it = g_lists.find(args[i]);
      if (it != g_lists.end()) {
        cnt++;
        for (auto &v : it->second) g_mem -= item_bytes(v);
        g_lists.erase(it);
      }
    }
    reply_int(c, cnt);
    return;
  }
  if (cmd == "EXISTS") {
    long long cnt = 0;
    for (size_t i = 1; i < n; i++)
      cnt += (get_string(args[i]) != nullptr) || g_lists.count(args[i]);
    reply_int(c, cnt);
    return;
  }
  if (cmd == "EXPIRE") {
    if (n != 3) { reply_error(c, "wrong number of arguments"); return; }
    StringVal *v = get_string(args[1]);
    if (!v) { reply_int(c, 0); return; }
    v->expires_at = now_s() + atof(args[2].c_str());
    reply_int(c, 1);
    return;
  }
  if (cmd == "TTL") {
    StringVal *v = get_string(args[1]);
    if (!v) { reply_int(c, -2); return; }
    if (v->expires_at == 0) { reply_int(c, -1); return; }
    reply_int(c, (long long)(v->expires_at - now_s()));
    return;
  }
  reply_error(c, "unknown command '" + args[0] + "'");
}

// ---------------------------------------------------------------------------
// RESP2 request parsing: arrays of bulk strings ("*N\r\n$len\r\n...\r\n")
// ---------------------------------------------------------------------------

// returns: 1 = parsed one command into args, 0 = need more bytes, -1 = fatal
static int parse_one(std::string &in, std::vector<std::string> &args) {
  if (in.empty()) return 0;
  if (in[0] != '*') {
    // inline command (e.g. "PING\r\n" from nc) — split on spaces
    size_t eol = in.find("\r\n");
    if (eol == std::string::npos) return in.size() > 64 * 1024 ? -1 : 0;
    std::string line = in.substr(0, eol);
    in.erase(0, eol + 2);
    size_t pos = 0;
    while (pos < line.size()) {
      size_t sp = line.find(' ', pos);
      if (sp == std::string::npos) sp = line.size();
      if (sp > pos) args.push_back(line.substr(pos, sp - pos));
      pos = sp + 1;
    }
    return args.empty() ? 0 : 1;
  }
  size_t pos = 1;
  size_t eol = in.find("\r\n", pos);
  if (eol == std::string::npos) return 0;
  long long nargs = atoll(in.c_str() + pos);
  if (nargs <= 0 || nargs > 1024 * 1024) return -1;
  pos = eol + 2;
  std::vector<std::string> out;
  out.reserve((size_t)nargs);
  for (long long i = 0; i < nargs; i++) {
    if (pos >= in.size() || in[pos] != '$') return pos >= in.size() ? 0 : -1;
    eol = in.find("\r\n", pos + 1);
    if (eol == std::string::npos) return 0;
    long long len = atoll(in.c_str() + pos + 1);
    if (len < 0 || len > 512 * 1024 * 1024) return -1;
    size_t start = eol + 2;
    if (in.size() < start + (size_t)len + 2) return 0;
    out.emplace_back(in, start, (size_t)len);
    pos = start + (size_t)len + 2;
  }
  in.erase(0, pos);
  args = std::move(out);
  return 1;
}

static void close_conn(int fd) {
  unblock_drop(fd);
  epoll_ctl(g_epfd, EPOLL_CTL_DEL, fd, nullptr);
  close(fd);
  g_conns.erase(fd);
}

int main(int argc, char **argv) {
  int port = argc > 1 ? atoi(argv[1]) : 6379;
  signal(SIGPIPE, SIG_IGN);
  if (const char *mm = getenv("MINIREDIS_MAX_BYTES")) {
    g_max_mem = (size_t)strtoull(mm, nullptr, 10);
  }

  int lfd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  int one = 1;
  setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons((uint16_t)port);
  if (bind(lfd, (sockaddr *)&addr, sizeof(addr)) != 0) {
    perror("bind");
    return 1;
  }
  listen(lfd, 512);

  g_epfd = epoll_create1(0);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.fd = lfd;
  epoll_ctl(g_epfd, EPOLL_CTL_ADD, lfd, &ev);
  fprintf(stderr, "miniredis listening on 127.0.0.1:%d\n", port);
  fflush(stderr);

  std::vector<epoll_event> events(256);
  for (;;) {
    // wake early enough to expire the nearest BLPOP deadline
    int timeout_ms = 1000;
    double now = now_s();
    for (auto &kv : g_waiters)
      for (auto &w : kv.second)
        if (w.deadline > 0) {
          int ms = (int)((w.deadline - now) * 1000) + 1;
          if (ms < timeout_ms) timeout_ms = ms < 0 ? 0 : ms;
        }

    int nev = epoll_wait(g_epfd, events.data(), (int)events.size(), timeout_ms);
    now = now_s();

    // periodic reap of expired-but-unclaimed result keys (lazy expiry alone
    // would hold them in memory for the whole process lifetime)
    if (now - g_last_sweep > 2.0) sweep_expired();

    // time out expired BLPOP waiters with a null array
    for (auto wit = g_waiters.begin(); wit != g_waiters.end();) {
      auto &dq = wit->second;
      for (auto it = dq.begin(); it != dq.end();) {
        if (it->deadline > 0 && it->deadline <= now) {
          auto cit = g_conns.find(it->fd);
          if (cit != g_conns.end() && cit->second.blocked) {
            reply_null_array(cit->second);
            cit->second.blocked = false;
            want_write(cit->second);
          }
          it = dq.erase(it);
        } else {
          ++it;
        }
      }
      wit = dq.empty() ? g_waiters.erase(wit) : std::next(wit);
    }

    for (int i = 0; i < nev; i++) {
      int fd = events[i].data.fd;
      if (fd == lfd) {
        for (;;) {
          int cfd = accept4(lfd, nullptr, nullptr, SOCK_NONBLOCK);
          if (cfd < 0) break;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          epoll_event cev{};
          cev.events = EPOLLIN;
          cev.data.fd = cfd;
          epoll_ctl(g_epfd, EPOLL_CTL_ADD, cfd, &cev);
          g_conns[cfd] = Conn{cfd};
        }
        continue;
      }
      auto cit = g_conns.find(fd);
      if (cit == g_conns.end()) continue;
      Conn &c = cit->second;

      if (events[i].events & (EPOLLHUP | EPOLLERR)) { close_conn(fd); continue; }

      if (events[i].events & EPOLLIN) {
        char buf[64 * 1024];
        bool dead = false;
        for (;;) {
          ssize_t r = read(fd, buf, sizeof(buf));
          if (r > 0) { c.in.append(buf, (size_t)r); continue; }
          if (r == 0) { dead = true; }
          else if (errno != EAGAIN && errno != EWOULDBLOCK) { dead = true; }
          break;
        }
        if (dead) { close_conn(fd); continue; }
        // a blocked client sends nothing until its reply; parse otherwise
        while (!c.blocked) {
          std::vector<std::string> args;
          int st = parse_one(c.in, args);
          if (st == 0) break;
          if (st < 0) { dead = true; break; }
          if (!args.empty()) run_command(c, args);
        }
        if (dead) { close_conn(fd); continue; }
        want_write(c);
      }

      if (events[i].events & EPOLLOUT) {
        while (!c.out.empty()) {
          ssize_t w = write(fd, c.out.data(), c.out.size());
          if (w > 0) { c.out.erase(0, (size_t)w); continue; }
          if (errno != EAGAIN && errno != EWOULDBLOCK) { close_conn(fd); fd = -1; }
          break;
        }
        if (fd >= 0) want_write(c);
      }
    }
  }
}
