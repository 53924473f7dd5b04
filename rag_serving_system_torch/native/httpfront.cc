// httpfront — an in-process native HTTP front for the serving process.
//
// Why: the round-3 ladder attribution (PERFORMANCE.md "native-client ladder")
// measured the single-process HTTP+queue handling at ~35% of the shared core:
// in-process the engine sustains ~795 req/s while the aiohttp surface serves
// ~505. Every byte of that gap is Python work under the GIL — HTTP parsing,
// pydantic validation, JSON encode/decode, asyncio scheduling — stealing time
// from the dispatch thread. This file moves the whole per-request byte path
// into a C++ epoll thread that never takes the GIL:
//
//   accept → HTTP parse → JSON body parse → pending ring  (epoll thread)
//   pending ring → ONE ctypes drain call per wakeup        (Python thread)
//   finalize → ONE ctypes complete call per result         (Python thread)
//   result → waiter wakeup → socket write                  (epoll thread)
//
// Python touches each request exactly twice (drain-parse + enqueue, and the
// store_result redirect), both measured in single-digit microseconds; the
// connection handling, timeout bookkeeping, and response writes happen here.
//
// Routes served (same shapes as api/endpoints.py, which keeps serving
// /stats and /metrics on its own port):
//   POST /rag[?wait=N]        → complete-in-exchange when the result lands
//                               within N s, else {"status":"processing"}
//   GET  /rag/result/ID[?timeout=N] → long-poll the result store
//   GET  /health              → {"status":"healthy"}
//
// The reference serves its API from uvicorn/FastAPI (reference main.py:72-76,
// api/endpoints.py:14-75); this is the TPU repo's native equivalent of that
// front tier, embedded in the serving process so the in-memory queue (no
// Redis hop) stays usable.
//
// Build: native/build.sh → libhttpfront.so (loaded via ctypes, no Python.h).
// Threading: one epoll thread owns all connection/waiter/result state.
// Python-facing queues (pending requests out, completions in) are the only
// shared structures, guarded by one mutex each; completions wake the epoll
// loop through an eventfd.

#include <arpa/inet.h>
#include <errno.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

using Clock = std::chrono::steady_clock;

static double now_s() {
  return std::chrono::duration<double>(Clock::now().time_since_epoch()).count();
}

// ---------------------------------------------------------------------------
// minimal JSON: top-level-object scanner (string-aware, depth-tracking), so a
// "k" inside the query VALUE can never be mistaken for the "k" KEY.
// ---------------------------------------------------------------------------

// Parse a JSON string starting at s[i] == '"'. Appends decoded bytes to out.
// Returns index one past the closing quote, or npos on malformed input.
static size_t json_parse_string(const std::string &s, size_t i, std::string *out) {
  if (i >= s.size() || s[i] != '"') return std::string::npos;
  i++;
  while (i < s.size()) {
    unsigned char ch = (unsigned char)s[i];
    if (ch == '"') return i + 1;
    if (ch == '\\') {
      if (i + 1 >= s.size()) return std::string::npos;
      char e = s[i + 1];
      i += 2;
      if (!out) continue;
      switch (e) {
        case '"': *out += '"'; break;
        case '\\': *out += '\\'; break;
        case '/': *out += '/'; break;
        case 'b': *out += '\b'; break;
        case 'f': *out += '\f'; break;
        case 'n': *out += '\n'; break;
        case 'r': *out += '\r'; break;
        case 't': *out += '\t'; break;
        case 'u': {
          if (i + 4 > s.size()) return std::string::npos;
          unsigned cp = 0;
          for (int j = 0; j < 4; j++) {
            char h = s[i + j];
            cp <<= 4;
            if (h >= '0' && h <= '9') cp |= (unsigned)(h - '0');
            else if (h >= 'a' && h <= 'f') cp |= (unsigned)(h - 'a' + 10);
            else if (h >= 'A' && h <= 'F') cp |= (unsigned)(h - 'A' + 10);
            else return std::string::npos;
          }
          i += 4;
          // surrogate pair → one code point
          if (cp >= 0xD800 && cp <= 0xDBFF && i + 6 <= s.size() &&
              s[i] == '\\' && s[i + 1] == 'u') {
            unsigned lo = 0;
            bool ok = true;
            for (int j = 0; j < 4; j++) {
              char h = s[i + 2 + j];
              lo <<= 4;
              if (h >= '0' && h <= '9') lo |= (unsigned)(h - '0');
              else if (h >= 'a' && h <= 'f') lo |= (unsigned)(h - 'a' + 10);
              else if (h >= 'A' && h <= 'F') lo |= (unsigned)(h - 'A' + 10);
              else { ok = false; break; }
            }
            if (ok && lo >= 0xDC00 && lo <= 0xDFFF) {
              cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
              i += 6;
            }
          }
          // UTF-8 encode
          if (cp < 0x80) *out += (char)cp;
          else if (cp < 0x800) {
            *out += (char)(0xC0 | (cp >> 6));
            *out += (char)(0x80 | (cp & 0x3F));
          } else if (cp < 0x10000) {
            *out += (char)(0xE0 | (cp >> 12));
            *out += (char)(0x80 | ((cp >> 6) & 0x3F));
            *out += (char)(0x80 | (cp & 0x3F));
          } else {
            *out += (char)(0xF0 | (cp >> 18));
            *out += (char)(0x80 | ((cp >> 12) & 0x3F));
            *out += (char)(0x80 | ((cp >> 6) & 0x3F));
            *out += (char)(0x80 | (cp & 0x3F));
          }
          break;
        }
        default: return std::string::npos;  // invalid escape
      }
      continue;
    }
    if (out) *out += (char)ch;
    i++;
  }
  return std::string::npos;  // unterminated
}

static size_t skip_ws(const std::string &s, size_t i) {
  while (i < s.size() && (s[i] == ' ' || s[i] == '\t' || s[i] == '\n' || s[i] == '\r')) i++;
  return i;
}

// Skip one JSON value (any type) starting at i; returns one past its end.
static size_t json_skip_value(const std::string &s, size_t i) {
  i = skip_ws(s, i);
  if (i >= s.size()) return std::string::npos;
  char c = s[i];
  if (c == '"') return json_parse_string(s, i, nullptr);
  if (c == '{' || c == '[') {
    int depth = 0;
    while (i < s.size()) {
      char ch = s[i];
      if (ch == '"') {
        i = json_parse_string(s, i, nullptr);
        if (i == std::string::npos) return std::string::npos;
        continue;
      }
      if (ch == '{' || ch == '[') depth++;
      else if (ch == '}' || ch == ']') {
        depth--;
        if (depth == 0) return i + 1;
      }
      i++;
    }
    return std::string::npos;
  }
  // number / true / false / null
  size_t start = i;
  while (i < s.size() && s[i] != ',' && s[i] != '}' && s[i] != ']' &&
         s[i] != ' ' && s[i] != '\t' && s[i] != '\n' && s[i] != '\r') i++;
  return i == start ? std::string::npos : i;
}

// Extract top-level "query" (string, required), "k" (int, optional) and
// "max_new_tokens" (int, optional; 0 = unset → engine default). Returns
// true iff body is a JSON object with a string "query" field and, when the
// int fields are present, integers 1..1024 (pydantic bounds,
// api/models.py:10).
static bool parse_rag_body(const std::string &body, std::string *query,
                           long *k, long *mnt, bool *query_seen) {
  *k = 2;
  *mnt = 0;
  *query_seen = false;
  size_t i = skip_ws(body, 0);
  if (i >= body.size() || body[i] != '{') return false;
  i = skip_ws(body, i + 1);
  if (i < body.size() && body[i] == '}') return true;  // empty object
  for (;;) {
    std::string key;
    i = skip_ws(body, i);
    i = json_parse_string(body, i, &key);
    if (i == std::string::npos) return false;
    i = skip_ws(body, i);
    if (i >= body.size() || body[i] != ':') return false;
    i = skip_ws(body, i + 1);
    if (key == "query") {
      if (i >= body.size() || body[i] != '"') return false;  // must be string
      query->clear();
      i = json_parse_string(body, i, query);
      if (i == std::string::npos) return false;
      *query_seen = true;
    } else if (key == "k" || key == "max_new_tokens") {
      size_t end = json_skip_value(body, i);
      if (end == std::string::npos) return false;
      // "max_new_tokens": null means unset (pydantic default) — skip it
      if (key == "max_new_tokens" && end == i + 4 &&
          body.compare(i, 4, "null") == 0) {
        i = end;
      } else {
        char *stop = nullptr;
        long v = strtol(body.c_str() + i, &stop, 10);
        if (stop == body.c_str() + i) return false;     // not a number
        // reject floats ("2.5") — pydantic would too
        for (const char *p = stop; p < body.c_str() + end; p++)
          if (*p != ' ' && *p != '\t' && *p != '\n' && *p != '\r')
            return false;
        if (v < 1 || v > 1024) return false;
        *(key == "k" ? k : mnt) = v;
        i = end;
      }
    } else {
      i = json_skip_value(body, i);
      if (i == std::string::npos) return false;
    }
    i = skip_ws(body, i);
    if (i >= body.size()) return false;
    if (body[i] == ',') { i++; continue; }
    if (body[i] == '}') return true;
    return false;
  }
}

// ---------------------------------------------------------------------------
// global server state
// ---------------------------------------------------------------------------

struct Conn {
  int fd = -1;
  std::string in;
  std::string out;
  bool waiting = false;       // parked on a result (no pipelining meanwhile)
  bool close_after = false;   // Connection: close
  bool expect_continue = false;  // Expect: 100-continue pending interim reply
  double last_active = 0;     // keepalive bookkeeping (idle sweep)
  // parsed-request scratch
  size_t need_body = 0;       // body bytes still missing (0 = parsing headers)
  std::string method, path, query_string, body;
};

// aiohttp gets keepalive timeouts and flow control for free; the native front
// enforces its own: idle connections are reaped, and per-connection buffers
// are bounded so a client that pipelines without reading responses (c.out) or
// streams bytes at a parked waiter (c.in) cannot grow memory without limit.
static constexpr double kIdleTimeout = 120.0;   // s without socket activity
static constexpr size_t kMaxConnBuf = 8 * 1024 * 1024;  // per direction

struct Waiter {
  int fd;
  uint64_t conn_gen;   // guards against fd reuse after close
  double deadline;
  bool is_post;        // POST ?wait= (reply carries request_id) vs GET poll
  std::string request_id;
};

struct PendingReq {   // epoll thread → Python drain
  std::string id;
  long k;
  long mnt;            // per-request max_new_tokens (0 = engine default)
  std::string query;
};

struct Completion {   // Python → epoll thread
  std::string id;
  std::string json;   // serialized result payload
};

struct StoredResult {
  std::string json;
  double stored_at;
};

namespace {
// heap-allocated so the global destructor can never hit std::terminate on a
// still-joinable thread at process exit (the interpreter may exit without
// calling httpfront_stop; leaking one thread object there is harmless)
std::thread *g_thread = nullptr;
std::atomic<bool> g_running{false};
int g_epfd = -1, g_lfd = -1, g_evfd = -1;
int g_port = 0;
int g_max_inflight = 0;
double g_result_ttl = 3600.0;

std::unordered_map<int, Conn> g_conns;
std::unordered_map<int, uint64_t> g_conn_gen;
uint64_t g_gen_counter = 0;
std::unordered_map<std::string, std::vector<Waiter>> g_waiters;  // id → waiters
std::unordered_map<std::string, StoredResult> g_results;
uint64_t g_id_counter = 0;
char g_id_tag[9] = {0};
int g_completes_since_sweep = 0;

std::mutex g_pending_mu;
std::condition_variable g_pending_cv;
std::deque<PendingReq> g_pending;

std::mutex g_done_mu;
std::deque<Completion> g_done;

std::atomic<long long> g_stat_accepted{0};   // requests accepted into queue
std::atomic<long long> g_stat_rejected{0};   // 503 backpressure
std::atomic<long long> g_stat_completed{0};  // results delivered to a client
std::atomic<long long> g_stat_bad{0};        // 4xx responses
std::atomic<long long> g_inflight{0};        // accepted − completed(stored)
}  // namespace

// ---------------------------------------------------------------------------
// HTTP responses
// ---------------------------------------------------------------------------

static void respond(Conn &c, int status, const char *reason,
                    const std::string &body) {
  char hdr[160];
  int n = snprintf(hdr, sizeof hdr,
                   "HTTP/1.1 %d %s\r\nContent-Type: application/json\r\n"
                   "Content-Length: %zu\r\n%s\r\n",
                   status, reason, body.size(),
                   c.close_after ? "Connection: close\r\n" : "");
  c.out.append(hdr, (size_t)n);
  c.out += body;
}

static void want_write(Conn &c) {
  epoll_event ev{};
  ev.events = EPOLLIN | (c.out.empty() ? 0 : EPOLLOUT);
  ev.data.fd = c.fd;
  epoll_ctl(g_epfd, EPOLL_CTL_MOD, c.fd, &ev);
}

static void close_conn(int fd) {
  epoll_ctl(g_epfd, EPOLL_CTL_DEL, fd, nullptr);
  close(fd);
  g_conns.erase(fd);
  g_conn_gen.erase(fd);
  // waiters referencing this fd are invalidated by generation mismatch
}

// consume-once result fetch
static bool take_result(const std::string &id, std::string *json) {
  auto it = g_results.find(id);
  if (it == g_results.end()) return false;
  *json = std::move(it->second.json);
  g_results.erase(it);
  return true;
}

static void reply_complete_post(Conn &c, const std::string &id,
                                const std::string &result_json) {
  std::string body = "{\"request_id\": \"" + id +
                     "\", \"status\": \"complete\", \"result\": " +
                     result_json + "}";
  respond(c, 200, "OK", body);
  g_stat_completed.fetch_add(1, std::memory_order_relaxed);
}

static void reply_complete_get(Conn &c, const std::string &result_json) {
  std::string body = "{\"status\": \"complete\", \"result\": " + result_json + "}";
  respond(c, 200, "OK", body);
  g_stat_completed.fetch_add(1, std::memory_order_relaxed);
}

static void reply_processing(Conn &c, const std::string &id, bool is_post) {
  if (is_post)
    respond(c, 200, "OK",
            "{\"request_id\": \"" + id + "\", \"status\": \"processing\"}");
  else
    respond(c, 200, "OK", "{\"status\": \"processing\"}");
}

// ---------------------------------------------------------------------------
// request routing (runs on the epoll thread)
// ---------------------------------------------------------------------------

static double query_param(const std::string &qs, const char *name, double dflt) {
  size_t pos = 0;
  size_t nlen = strlen(name);
  while (pos < qs.size()) {
    size_t amp = qs.find('&', pos);
    if (amp == std::string::npos) amp = qs.size();
    if (amp - pos > nlen && qs.compare(pos, nlen, name) == 0 &&
        qs[pos + nlen] == '=') {
      return atof(qs.c_str() + pos + nlen + 1);
    }
    pos = amp + 1;
  }
  return dflt;
}

static void handle_request(Conn &c) {
  if (c.method == "GET" && c.path == "/health") {
    respond(c, 200, "OK", "{\"status\": \"healthy\"}");
    return;
  }
  if (c.method == "POST" && c.path == "/rag") {
    std::string query;
    long k = 2, mnt = 0;
    bool query_seen = false;
    if (!parse_rag_body(c.body, &query, &k, &mnt, &query_seen) ||
        !query_seen || query.size() > 100000) {
      g_stat_bad.fetch_add(1, std::memory_order_relaxed);
      respond(c, 422, "Unprocessable Entity",
              "{\"detail\": \"invalid request body\"}");
      return;
    }
    if (g_max_inflight > 0 &&
        g_inflight.load(std::memory_order_relaxed) >= g_max_inflight) {
      g_stat_rejected.fetch_add(1, std::memory_order_relaxed);
      respond(c, 503, "Service Unavailable",
              "{\"detail\": \"queue full\", \"status\": \"rejected\"}");
      return;
    }
    char idbuf[40];
    snprintf(idbuf, sizeof idbuf, "nf-%s-%012llx", g_id_tag,
             (unsigned long long)g_id_counter++);
    std::string id(idbuf);
    g_inflight.fetch_add(1, std::memory_order_relaxed);
    g_stat_accepted.fetch_add(1, std::memory_order_relaxed);
    {
      std::lock_guard<std::mutex> lk(g_pending_mu);
      g_pending.push_back({id, k, mnt, std::move(query)});
    }
    g_pending_cv.notify_one();
    double wait = query_param(c.query_string, "wait", 0.0);
    if (wait > 30.0) wait = 30.0;
    if (wait > 0) {
      c.waiting = true;
      g_waiters[id].push_back({c.fd, g_conn_gen[c.fd], now_s() + wait, true, id});
      return;  // reply deferred until completion or deadline
    }
    reply_processing(c, id, true);
    return;
  }
  if (c.method == "GET" && c.path.rfind("/rag/result/", 0) == 0) {
    std::string id = c.path.substr(strlen("/rag/result/"));
    std::string result_json;
    if (take_result(id, &result_json)) {
      reply_complete_get(c, result_json);
      return;
    }
    double timeout = query_param(c.query_string, "timeout", 0.0);
    if (timeout > 30.0) timeout = 30.0;
    if (timeout > 0) {
      c.waiting = true;
      g_waiters[id].push_back({c.fd, g_conn_gen[c.fd], now_s() + timeout, false, id});
      return;
    }
    reply_processing(c, id, false);
    return;
  }
  g_stat_bad.fetch_add(1, std::memory_order_relaxed);
  respond(c, 404, "Not Found", "{\"detail\": \"not found\"}");
}

static bool parse_and_dispatch(Conn &c);

// a released waiter may have pipelined bytes buffered behind the parked
// request — re-run the parser or they stall until the next EPOLLIN (which a
// client waiting on its pipelined response never sends)
static void redispatch(int fd) {
  auto cit = g_conns.find(fd);
  if (cit == g_conns.end() || cit->second.waiting) return;
  if (!parse_and_dispatch(cit->second)) { close_conn(fd); return; }
  want_write(cit->second);
}

// deliver completions queued by httpfront_complete (epoll thread)
static void drain_completions() {
  std::deque<Completion> done;
  {
    std::lock_guard<std::mutex> lk(g_done_mu);
    done.swap(g_done);
  }
  double now = now_s();
  for (auto &comp : done) {
    g_inflight.fetch_sub(1, std::memory_order_relaxed);
    // first live waiter gets the result (consume-once)
    auto wit = g_waiters.find(comp.id);
    bool delivered = false;
    std::vector<int> released;
    if (wit != g_waiters.end()) {
      for (auto &w : wit->second) {
        auto cit = g_conns.find(w.fd);
        if (cit == g_conns.end()) continue;
        auto git = g_conn_gen.find(w.fd);
        if (git == g_conn_gen.end() || git->second != w.conn_gen) continue;
        Conn &c = cit->second;
        if (!c.waiting) continue;
        if (!delivered) {  // first live waiter wins (consume-once)
          if (w.is_post) reply_complete_post(c, comp.id, comp.json);
          else reply_complete_get(c, comp.json);
          delivered = true;
        } else {  // the result is consumed — answer the rest now
          reply_processing(c, w.request_id, w.is_post);
        }
        c.waiting = false;
        released.push_back(w.fd);
      }
      g_waiters.erase(wit);  // before redispatch: it may insert new waiters
    }
    for (int fd : released) redispatch(fd);
    if (!delivered) g_results[comp.id] = {std::move(comp.json), now};
    if (++g_completes_since_sweep >= 4096) {
      g_completes_since_sweep = 0;
      double cutoff = now - g_result_ttl;
      for (auto it = g_results.begin(); it != g_results.end();)
        it = it->second.stored_at < cutoff ? g_results.erase(it) : std::next(it);
    }
  }
}

// answer waiters whose deadline passed ("processing"); prune stale entries
static void expire_waiters(double now) {
  std::vector<int> released;
  for (auto wit = g_waiters.begin(); wit != g_waiters.end();) {
    auto &vec = wit->second;
    for (auto it = vec.begin(); it != vec.end();) {
      auto cit = g_conns.find(it->fd);
      auto git = g_conn_gen.find(it->fd);
      bool stale = cit == g_conns.end() || git == g_conn_gen.end() ||
                   git->second != it->conn_gen || !cit->second.waiting;
      if (stale) { it = vec.erase(it); continue; }
      if (it->deadline <= now) {
        Conn &c = cit->second;
        reply_processing(c, it->request_id, it->is_post);
        c.waiting = false;
        released.push_back(it->fd);
        it = vec.erase(it);
        continue;
      }
      ++it;
    }
    wit = vec.empty() ? g_waiters.erase(wit) : std::next(wit);
  }
  // outside the map iteration: redispatch may register NEW waiters
  for (int fd : released) redispatch(fd);
}

// parse as many complete HTTP requests as the buffer holds
static bool parse_and_dispatch(Conn &c) {  // false = fatal, close conn
  while (!c.waiting) {
    if (c.need_body == 0) {
      size_t hdr_end = c.in.find("\r\n\r\n");
      if (hdr_end == std::string::npos)
        return c.in.size() <= 64 * 1024;  // oversized headers → drop
      // request line
      size_t eol = c.in.find("\r\n");
      std::string line = c.in.substr(0, eol);
      size_t sp1 = line.find(' ');
      size_t sp2 = line.find(' ', sp1 + 1);
      if (sp1 == std::string::npos || sp2 == std::string::npos) return false;
      c.method = line.substr(0, sp1);
      std::string target = line.substr(sp1 + 1, sp2 - sp1 - 1);
      size_t qm = target.find('?');
      c.path = qm == std::string::npos ? target : target.substr(0, qm);
      c.query_string = qm == std::string::npos ? "" : target.substr(qm + 1);
      // headers: Content-Length + Connection
      size_t content_length = 0;
      c.close_after = false;
      size_t pos = eol + 2;
      while (pos < hdr_end) {
        size_t le = c.in.find("\r\n", pos);
        std::string h = c.in.substr(pos, le - pos);
        pos = le + 2;
        size_t colon = h.find(':');
        if (colon == std::string::npos) continue;
        std::string name = h.substr(0, colon);
        for (auto &ch : name) ch = (char)tolower((unsigned char)ch);
        size_t v = colon + 1;
        while (v < h.size() && h[v] == ' ') v++;
        if (name == "content-length")
          content_length = (size_t)atoll(h.c_str() + v);
        else if (name == "connection") {
          std::string val = h.substr(v);
          for (auto &ch : val) ch = (char)tolower((unsigned char)ch);
          if (val.find("close") != std::string::npos) c.close_after = true;
        } else if (name == "transfer-encoding") {
          return false;  // chunked unsupported
        } else if (name == "expect") {
          std::string val = h.substr(v);
          for (auto &ch : val) ch = (char)tolower((unsigned char)ch);
          if (val.find("100-continue") != std::string::npos)
            c.expect_continue = true;
        }
      }
      if (content_length > 1024 * 1024) return false;  // body cap
      c.in.erase(0, hdr_end + 4);
      c.need_body = content_length + 1;  // +1 sentinel: "headers parsed"
    }
    size_t body_len = c.need_body - 1;
    if (c.in.size() < body_len) {
      // client is holding the body for our interim reply (curl does this for
      // bodies >1KB and stalls ~1s without it) — send 100 Continue once
      if (c.expect_continue) {
        c.out += "HTTP/1.1 100 Continue\r\n\r\n";
        c.expect_continue = false;
      }
      return true;  // wait for more bytes
    }
    c.expect_continue = false;  // body already (fully) here — no interim reply
    c.body.assign(c.in, 0, body_len);
    c.in.erase(0, body_len);
    c.need_body = 0;
    handle_request(c);
    if (c.close_after && !c.waiting) break;
  }
  return true;
}

// ---------------------------------------------------------------------------
// event loop
// ---------------------------------------------------------------------------

static void event_loop() {
  std::vector<epoll_event> events(256);
  while (g_running.load(std::memory_order_relaxed)) {
    int timeout_ms = 1000;
    double now = now_s();
    // O(waiters) minimum scan per wakeup — measured fine at the 1600-rps
    // scale this host reaches; a deadline heap is the upgrade path if
    // parked-waiter counts ever dominate a profile
    for (auto &kv : g_waiters)
      for (auto &w : kv.second) {
        int ms = (int)((w.deadline - now) * 1000) + 1;
        if (ms < timeout_ms) timeout_ms = ms < 0 ? 0 : ms;
      }
    int nev = epoll_wait(g_epfd, events.data(), (int)events.size(), timeout_ms);
    for (int i = 0; i < nev; i++) {
      int fd = events[i].data.fd;
      if (fd == g_evfd) {
        uint64_t junk;
        while (read(g_evfd, &junk, sizeof junk) > 0) {}
        continue;
      }
      if (fd == g_lfd) {
        for (;;) {
          int cfd = accept4(g_lfd, nullptr, nullptr, SOCK_NONBLOCK);
          if (cfd < 0) break;
          int one = 1;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
          epoll_event cev{};
          cev.events = EPOLLIN;
          cev.data.fd = cfd;
          epoll_ctl(g_epfd, EPOLL_CTL_ADD, cfd, &cev);
          g_conns[cfd] = Conn{};
          g_conns[cfd].fd = cfd;
          g_conns[cfd].last_active = now_s();
          g_conn_gen[cfd] = ++g_gen_counter;
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
          ssize_t r = read(fd, buf, sizeof buf);
          if (r > 0) { c.in.append(buf, (size_t)r); c.last_active = now_s(); continue; }
          if (r == 0) dead = true;
          else if (errno != EAGAIN && errno != EWOULDBLOCK) dead = true;
          break;
        }
        // bound c.in: a parked ?wait connection can keep streaming pipelined
        // bytes the parser won't consume until release — cut it off instead
        // of buffering without limit
        if (c.in.size() > kMaxConnBuf) dead = true;
        // a parked waiter with a dead socket must be closed even though we
        // can't write to it; its waiter entry is pruned by generation check
        if (dead || !parse_and_dispatch(c)) { close_conn(fd); continue; }
        if (c.out.size() > kMaxConnBuf) { close_conn(fd); continue; }
        want_write(c);
      }
      if (events[i].events & EPOLLOUT) {
        while (!c.out.empty()) {
          ssize_t w = write(fd, c.out.data(), c.out.size());
          if (w > 0) { c.out.erase(0, (size_t)w); c.last_active = now_s(); continue; }
          if (errno != EAGAIN && errno != EWOULDBLOCK) { close_conn(fd); fd = -1; }
          break;
        }
        if (fd >= 0) {
          if (c.out.empty() && c.close_after && !c.waiting) { close_conn(fd); continue; }
          want_write(c);
        }
      }
    }
    // AFTER the event sweep (which clears the eventfd): a completion pushed
    // between an earlier drain and the eventfd read would otherwise have its
    // wakeup consumed and sit undelivered for up to the idle timeout
    drain_completions();
    double after = now_s();
    expire_waiters(after);
    // idle/keepalive sweep (alongside expire_waiters, as a low-rate scan):
    // reap half-open dead connections and clients that went silent. Parked
    // waiters are exempt — their own ≤30 s deadline releases them first,
    // which refreshes last_active via the response write.
    static double last_idle_sweep = 0;
    if (after - last_idle_sweep >= 5.0) {
      last_idle_sweep = after;
      std::vector<int> stale;
      for (auto &kv : g_conns) {
        const Conn &c = kv.second;
        if (!c.waiting && after - c.last_active > kIdleTimeout)
          stale.push_back(kv.first);
      }
      for (int fd : stale) close_conn(fd);
    }
  }
  // shutdown: close client connections; the listener/eventfd/epoll fds are
  // closed by httpfront_stop AFTER joining this thread (closing them here
  // races the stop/complete threads' eventfd writes against fd reuse)
  for (auto &kv : g_conns) close(kv.first);
  g_conns.clear();
  g_conn_gen.clear();
  g_waiters.clear();
  g_results.clear();
  {
    std::lock_guard<std::mutex> lk(g_done_mu);
    g_done.clear();
  }
}

// ---------------------------------------------------------------------------
// C ABI (ctypes)
// ---------------------------------------------------------------------------

extern "C" {

// Start the front. port=0 picks a free port. Returns the bound port, or -1.
int httpfront_start(int port, int max_inflight) {
  if (g_running.load()) return -1;  // single instance per process
  signal(SIGPIPE, SIG_IGN);
  g_lfd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (g_lfd < 0) return -1;
  int one = 1;
  setsockopt(g_lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons((uint16_t)port);
  if (bind(g_lfd, (sockaddr *)&addr, sizeof addr) != 0 ||
      listen(g_lfd, 1024) != 0) {
    close(g_lfd);
    g_lfd = -1;
    return -1;
  }
  socklen_t alen = sizeof addr;
  getsockname(g_lfd, (sockaddr *)&addr, &alen);
  g_port = ntohs(addr.sin_port);
  g_max_inflight = max_inflight;
  g_evfd = eventfd(0, EFD_NONBLOCK);
  g_epfd = epoll_create1(0);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.fd = g_lfd;
  epoll_ctl(g_epfd, EPOLL_CTL_ADD, g_lfd, &ev);
  ev.data.fd = g_evfd;
  epoll_ctl(g_epfd, EPOLL_CTL_ADD, g_evfd, &ev);
  // per-start id tag so restarted fronts can't collide in a shared result
  // store (ids also reach Python, which treats the "nf-" prefix as ours)
  unsigned seed = (unsigned)(getpid() ^ (unsigned)(now_s() * 1e6));
  snprintf(g_id_tag, sizeof g_id_tag, "%08x", seed);
  g_id_counter = 0;
  g_inflight.store(0);
  // a restarted front must not report the previous instance's cumulative
  // counters next to a zeroed inflight — /stats would be internally
  // inconsistent across restarts
  g_stat_accepted.store(0);
  g_stat_completed.store(0);
  g_stat_rejected.store(0);
  g_stat_bad.store(0);
  g_running.store(true);
  g_thread = new std::thread(event_loop);
  return g_port;
}

void httpfront_stop() {
  if (!g_running.exchange(false)) return;
  uint64_t one = 1;
  (void)!write(g_evfd, &one, sizeof one);
  g_pending_cv.notify_all();
  if (g_thread != nullptr) {
    if (g_thread->joinable()) g_thread->join();
    delete g_thread;
    g_thread = nullptr;
  }
  {
    // g_done_mu also guards httpfront_complete's eventfd write, so no
    // completer can race the close with a write into a reused fd number
    std::lock_guard<std::mutex> lk(g_done_mu);
    close(g_lfd);
    close(g_evfd);
    close(g_epfd);
    g_lfd = g_evfd = g_epfd = -1;
  }
  std::lock_guard<std::mutex> lk(g_pending_mu);
  g_pending.clear();
}

// Pull accepted requests. Packs records into buf:
//   u16 id_len | u32 k | u32 max_new_tokens (0 = default) | u32 query_len |
//   id bytes | query bytes
// Blocks up to timeout_ms when none are pending. Returns bytes written
// (0 = timeout, -1 = stopped).
int httpfront_drain(char *buf, int cap, int timeout_ms) {
  std::unique_lock<std::mutex> lk(g_pending_mu);
  if (g_pending.empty()) {
    g_pending_cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                          [] { return !g_pending.empty() || !g_running.load(); });
  }
  if (!g_running.load() && g_pending.empty()) return -1;
  int off = 0;
  while (!g_pending.empty()) {
    PendingReq &r = g_pending.front();
    int need = 14 + (int)r.id.size() + (int)r.query.size();
    if (off + need > cap) break;
    uint16_t idl = (uint16_t)r.id.size();
    uint32_t k32 = (uint32_t)r.k;
    uint32_t m32 = (uint32_t)r.mnt;
    uint32_t ql = (uint32_t)r.query.size();
    memcpy(buf + off, &idl, 2);
    memcpy(buf + off + 2, &k32, 4);
    memcpy(buf + off + 6, &m32, 4);
    memcpy(buf + off + 10, &ql, 4);
    memcpy(buf + off + 14, r.id.data(), idl);
    memcpy(buf + off + 14 + idl, r.query.data(), ql);
    off += need;
    g_pending.pop_front();
  }
  return off;
}

// Deliver a completed result (thread-safe; called from Python finalize).
void httpfront_complete(const char *id, int id_len, const char *json,
                        int json_len) {
  std::lock_guard<std::mutex> lk(g_done_mu);
  if (!g_running.load() || g_evfd < 0) return;
  g_done.push_back({std::string(id, (size_t)id_len),
                    std::string(json, (size_t)json_len)});
  uint64_t one = 1;
  (void)!write(g_evfd, &one, sizeof one);
}

// Drain-record wire-format version. native/__init__.py checks this on load
// and rebuilds a stale library so the ctypes struct layout can never desync:
//   v2 = u16 id_len | u32 k | u32 max_new_tokens | u32 query_len | bytes
int httpfront_abi_version(void) { return 2; }

// Write this front's id prefix ("nf-<tag>-") into buf; returns its length.
// Ids minted by OTHER processes/restarts carry a different tag — results for
// those must not be parked in this front's local store.
int httpfront_id_prefix(char *buf, int cap) {
  int n = snprintf(buf, (size_t)cap, "nf-%s-", g_id_tag);
  return n < cap ? n : -1;
}

// out[0..4] = accepted, completed, rejected, bad_requests, inflight
void httpfront_stats(long long *out) {
  out[0] = g_stat_accepted.load(std::memory_order_relaxed);
  out[1] = g_stat_completed.load(std::memory_order_relaxed);
  out[2] = g_stat_rejected.load(std::memory_order_relaxed);
  out[3] = g_stat_bad.load(std::memory_order_relaxed);
  out[4] = g_inflight.load(std::memory_order_relaxed);
}

}  // extern "C"
