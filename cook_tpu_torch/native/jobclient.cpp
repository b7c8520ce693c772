// Typed native job client over the REST API.
//
// The reference ships a ~4,900-LoC typed Java client
// (jobclient/java/.../JobClient.java:97-827: builder, submit/query/abort,
// listener polling). No JVM exists in this image, so the typed
// second-client role is filled in C++: a self-contained library (POSIX
// sockets HTTP/1.1 + minimal JSON) exposing a typed cook::JobClient and
// a C ABI for ctypes/FFI users. Wire format matches rest/api.py:
// POST /jobs, GET /jobs/:uuid, DELETE /jobs?uuid=..., POST /retry,
// auth via X-Cook-User (AuthConfig scheme "header") or HTTP basic.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -pthread (native/__init__.py).
#include <arpa/inet.h>
#include <netdb.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <cctype>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <stdexcept>
#include <string>
#include <chrono>
#include <thread>
#include <vector>

namespace cook {

// ---------------------------------------------------------------------------
// Minimal JSON value: parse + dump (recursive descent; enough for the
// job wire format — objects, arrays, strings, numbers, bools, null).
// ---------------------------------------------------------------------------
struct Json {
  enum Type { NUL, BOOL, NUM, STR, ARR, OBJ } type = NUL;
  bool b = false;
  double num = 0;
  std::string str;
  std::vector<Json> arr;
  std::vector<std::pair<std::string, Json>> obj;  // insertion-ordered

  static Json null() { return Json{}; }
  static Json boolean(bool v) { Json j; j.type = BOOL; j.b = v; return j; }
  static Json number(double v) { Json j; j.type = NUM; j.num = v; return j; }
  static Json string(std::string v) {
    Json j; j.type = STR; j.str = std::move(v); return j;
  }
  static Json array() { Json j; j.type = ARR; return j; }
  static Json object() { Json j; j.type = OBJ; return j; }

  Json& set(const std::string& k, Json v) {
    for (auto& kv : obj)
      if (kv.first == k) { kv.second = std::move(v); return *this; }
    obj.emplace_back(k, std::move(v));
    return *this;
  }
  const Json* get(const std::string& k) const {
    for (auto& kv : obj)
      if (kv.first == k) return &kv.second;
    return nullptr;
  }
  double get_num(const std::string& k, double dflt = 0) const {
    const Json* j = get(k);
    return j && j->type == NUM ? j->num : dflt;
  }
  std::string get_str(const std::string& k,
                      const std::string& dflt = "") const {
    const Json* j = get(k);
    return j && j->type == STR ? j->str : dflt;
  }

  static void escape(const std::string& s, std::string* out) {
    out->push_back('"');
    for (unsigned char c : s) {
      switch (c) {
        case '"': *out += "\\\""; break;
        case '\\': *out += "\\\\"; break;
        case '\n': *out += "\\n"; break;
        case '\r': *out += "\\r"; break;
        case '\t': *out += "\\t"; break;
        default:
          if (c < 0x20) {
            char buf[8];
            std::snprintf(buf, sizeof buf, "\\u%04x", c);
            *out += buf;
          } else {
            out->push_back(static_cast<char>(c));
          }
      }
    }
    out->push_back('"');
  }

  void dump(std::string* out) const {
    switch (type) {
      case NUL: *out += "null"; break;
      case BOOL: *out += b ? "true" : "false"; break;
      case NUM: {
        if (num == 0 && std::signbit(num)) {
          *out += "-0.0";  // the integer fast path would drop the sign
        } else if (num == static_cast<long long>(num) &&
            std::fabs(num) < 9.0e15) {
          char buf[32];
          std::snprintf(buf, sizeof buf, "%lld",
                        static_cast<long long>(num));
          *out += buf;
        } else {
          char buf[32];
          std::snprintf(buf, sizeof buf, "%.17g", num);
          *out += buf;
        }
        break;
      }
      case STR: escape(str, out); break;
      case ARR: {
        out->push_back('[');
        for (size_t i = 0; i < arr.size(); ++i) {
          if (i) out->push_back(',');
          arr[i].dump(out);
        }
        out->push_back(']');
        break;
      }
      case OBJ: {
        out->push_back('{');
        for (size_t i = 0; i < obj.size(); ++i) {
          if (i) out->push_back(',');
          escape(obj[i].first, out);
          out->push_back(':');
          obj[i].second.dump(out);
        }
        out->push_back('}');
        break;
      }
    }
  }
  std::string dump() const {
    std::string out;
    dump(&out);
    return out;
  }
};

class JsonParser {
 public:
  explicit JsonParser(const std::string& s) : s_(s) {}
  Json parse() {
    Json v = value();
    ws();
    if (pos_ != s_.size()) fail("trailing characters");
    return v;
  }

 private:
  const std::string& s_;
  size_t pos_ = 0;
  int depth_ = 0;
  // recursion guard: value() recurses per nesting level, so untrusted
  // input like 100k '[' would otherwise overflow the native stack and
  // crash the embedding process (this parser is an exported fuzz
  // surface via cook_json_roundtrip and parses server responses)
  static constexpr int kMaxDepth = 512;

  struct DepthGuard {
    JsonParser* p;
    explicit DepthGuard(JsonParser* parser) : p(parser) {
      if (++p->depth_ > kMaxDepth) p->fail("too deeply nested");
    }
    ~DepthGuard() { --p->depth_; }
  };

  [[noreturn]] void fail(const char* msg) {
    throw std::runtime_error(std::string("json: ") + msg + " at offset " +
                             std::to_string(pos_));
  }
  void ws() {
    while (pos_ < s_.size() && std::isspace(static_cast<unsigned char>(s_[pos_])))
      ++pos_;
  }
  char peek() {
    if (pos_ >= s_.size()) fail("unexpected end");
    return s_[pos_];
  }
  bool lit(const char* w) {
    size_t n = std::strlen(w);
    if (s_.compare(pos_, n, w) == 0) { pos_ += n; return true; }
    return false;
  }
  Json value() {
    DepthGuard guard(this);
    ws();
    char c = peek();
    if (c == '{') return object();
    if (c == '[') return array();
    if (c == '"') return Json::string(string_lit());
    if (c == 't') { if (!lit("true")) fail("bad literal"); return Json::boolean(true); }
    if (c == 'f') { if (!lit("false")) fail("bad literal"); return Json::boolean(false); }
    if (c == 'n') { if (!lit("null")) fail("bad literal"); return Json::null(); }
    return number();
  }
  Json number() {
    size_t start = pos_;
    if (peek() == '-') ++pos_;
    while (pos_ < s_.size() &&
           (std::isdigit(static_cast<unsigned char>(s_[pos_])) ||
            s_[pos_] == '.' || s_[pos_] == 'e' || s_[pos_] == 'E' ||
            s_[pos_] == '+' || s_[pos_] == '-'))
      ++pos_;
    if (pos_ == start) fail("bad number");
    return Json::number(std::stod(s_.substr(start, pos_ - start)));
  }
  unsigned hex4() {
    if (pos_ + 4 > s_.size()) fail("bad \\u escape");
    unsigned cp = 0;
    for (int i = 0; i < 4; ++i) {
      char h = s_[pos_++];
      cp <<= 4;
      if (h >= '0' && h <= '9') cp |= h - '0';
      else if (h >= 'a' && h <= 'f') cp |= h - 'a' + 10;
      else if (h >= 'A' && h <= 'F') cp |= h - 'A' + 10;
      else fail("bad hex digit");
    }
    return cp;
  }
  std::string string_lit() {
    if (peek() != '"') fail("expected string");
    ++pos_;
    std::string out;
    while (true) {
      if (pos_ >= s_.size()) fail("unterminated string");
      char c = s_[pos_++];
      if (c == '"') break;
      if (c == '\\') {
        if (pos_ >= s_.size()) fail("bad escape");
        char e = s_[pos_++];
        switch (e) {
          case '"': out.push_back('"'); break;
          case '\\': out.push_back('\\'); break;
          case '/': out.push_back('/'); break;
          case 'b': out.push_back('\b'); break;
          case 'f': out.push_back('\f'); break;
          case 'n': out.push_back('\n'); break;
          case 'r': out.push_back('\r'); break;
          case 't': out.push_back('\t'); break;
          case 'u': {
            unsigned cp = hex4();
            // combine UTF-16 surrogate pairs (json.dumps with
            // ensure_ascii emits astral chars as \uD8xx\uDCxx pairs);
            // a lone/mismatched surrogate folds to U+FFFD. A high
            // surrogate followed by another high surrogate emits FFFD
            // and re-tries pairing with the second one, so a stray
            // \uD800 before a valid pair keeps the pair intact.
            while (cp >= 0xD800 && cp <= 0xDBFF) {
              if (pos_ + 6 <= s_.size() && s_[pos_] == '\\' &&
                  s_[pos_ + 1] == 'u') {
                pos_ += 2;
                unsigned lo = hex4();
                if (lo >= 0xDC00 && lo <= 0xDFFF) {
                  cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
                } else {
                  out += "\xEF\xBF\xBD";  // U+FFFD for the lone high half
                  cp = lo;  // may itself be a high surrogate: loop
                }
              } else {
                cp = 0xFFFD;
              }
            }
            if (cp >= 0xDC00 && cp <= 0xDFFF) {
              cp = 0xFFFD;  // stray low surrogate
            }
            if (cp < 0x80) {
              out.push_back(static_cast<char>(cp));
            } else if (cp < 0x800) {
              out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
              out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
            } else if (cp < 0x10000) {
              out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
              out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
              out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
            } else {
              out.push_back(static_cast<char>(0xF0 | (cp >> 18)));
              out.push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
              out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
              out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
            }
            break;
          }
          default: fail("bad escape");
        }
      } else {
        out.push_back(c);
      }
    }
    return out;
  }
  Json object() {
    Json o = Json::object();
    ++pos_;  // '{'
    ws();
    if (peek() == '}') { ++pos_; return o; }
    while (true) {
      ws();
      std::string k = string_lit();
      ws();
      if (peek() != ':') fail("expected ':'");
      ++pos_;
      o.obj.emplace_back(std::move(k), value());
      ws();
      char c = peek();
      if (c == ',') { ++pos_; continue; }
      if (c == '}') { ++pos_; return o; }
      fail("expected ',' or '}'");
    }
  }
  Json array() {
    Json a = Json::array();
    ++pos_;  // '['
    ws();
    if (peek() == ']') { ++pos_; return a; }
    while (true) {
      a.arr.push_back(value());
      ws();
      char c = peek();
      if (c == ',') { ++pos_; continue; }
      if (c == ']') { ++pos_; return a; }
      fail("expected ',' or ']'");
    }
  }
};

// ---------------------------------------------------------------------------
// HTTP/1.1 over a POSIX socket (one request per connection; the server
// side is a ThreadingHTTPServer, so connection reuse buys nothing).
// ---------------------------------------------------------------------------
struct HttpResponse {
  int status = 0;
  std::string body;
};

class Transport {
 public:
  Transport(std::string host, int port, int timeout_ms)
      : host_(std::move(host)), port_(port), timeout_ms_(timeout_ms) {}

  HttpResponse request(const std::string& method, const std::string& path,
                       const std::map<std::string, std::string>& headers,
                       const std::string& body) {
    int fd = connect_();
    try {
      std::string req = method + " " + path + " HTTP/1.1\r\n";
      req += "Host: " + host_ + ":" + std::to_string(port_) + "\r\n";
      req += "Connection: close\r\n";
      for (auto& kv : headers) req += kv.first + ": " + kv.second + "\r\n";
      if (!body.empty() || method == "POST" || method == "PUT") {
        req += "Content-Type: application/json\r\n";
        req += "Content-Length: " + std::to_string(body.size()) + "\r\n";
      }
      req += "\r\n";
      req += body;
      send_all(fd, req);
      HttpResponse resp = read_response(fd);
      ::close(fd);
      return resp;
    } catch (...) {
      ::close(fd);
      throw;
    }
  }

 private:
  std::string host_;
  int port_;
  int timeout_ms_;

  int connect_() {
    struct addrinfo hints {};
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    struct addrinfo* res = nullptr;
    std::string port = std::to_string(port_);
    int rc = ::getaddrinfo(host_.c_str(), port.c_str(), &hints, &res);
    if (rc != 0)
      throw std::runtime_error(std::string("resolve ") + host_ + ": " +
                               gai_strerror(rc));
    int fd = -1;
    for (struct addrinfo* ai = res; ai; ai = ai->ai_next) {
      fd = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
      if (fd < 0) continue;
      struct timeval tv {timeout_ms_ / 1000, (timeout_ms_ % 1000) * 1000};
      ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
      ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof tv);
      if (::connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
      ::close(fd);
      fd = -1;
    }
    ::freeaddrinfo(res);
    if (fd < 0)
      throw std::runtime_error("connect " + host_ + ":" + port + " failed");
    return fd;
  }

  static void send_all(int fd, const std::string& data) {
    size_t off = 0;
    while (off < data.size()) {
      ssize_t n = ::send(fd, data.data() + off, data.size() - off, 0);
      if (n <= 0) throw std::runtime_error("send failed");
      off += static_cast<size_t>(n);
    }
  }

  static HttpResponse read_response(int fd) {
    std::string raw;
    char buf[8192];
    while (true) {
      ssize_t n = ::recv(fd, buf, sizeof buf, 0);
      if (n < 0) throw std::runtime_error("recv failed/timeout");
      if (n == 0) break;
      raw.append(buf, static_cast<size_t>(n));
    }
    size_t hdr_end = raw.find("\r\n\r\n");
    if (hdr_end == std::string::npos)
      throw std::runtime_error("malformed http response");
    std::string head = raw.substr(0, hdr_end);
    std::string body = raw.substr(hdr_end + 4);
    HttpResponse resp;
    if (std::sscanf(head.c_str(), "HTTP/%*s %d", &resp.status) != 1)
      throw std::runtime_error("malformed status line");
    // chunked transfer decoding (Connection: close makes it rare, but
    // be correct if the server chooses it)
    std::string lower;
    for (char c : head) lower.push_back(static_cast<char>(std::tolower(
        static_cast<unsigned char>(c))));
    if (lower.find("transfer-encoding: chunked") != std::string::npos) {
      std::string out;
      size_t p = 0;
      while (p < body.size()) {
        size_t eol = body.find("\r\n", p);
        if (eol == std::string::npos) break;
        long len = std::strtol(body.substr(p, eol - p).c_str(), nullptr, 16);
        if (len <= 0) break;
        out += body.substr(eol + 2, static_cast<size_t>(len));
        p = eol + 2 + static_cast<size_t>(len) + 2;
      }
      body = out;
    }
    resp.body = std::move(body);
    return resp;
  }
};

// ---------------------------------------------------------------------------
// Typed model + client (the JobClient.java role)
// ---------------------------------------------------------------------------
struct Instance {
  std::string task_id;
  std::string status;        // unknown | running | success | failed
  std::string hostname;
  int exit_code = 0;
  bool has_exit_code = false;
  bool preempted = false;
  std::string reason_string;
};

struct Job {
  std::string uuid;
  std::string name;
  std::string command;
  std::string user;
  std::string status;        // waiting | running | completed
  std::string state;         // waiting | running | success | failed
  std::string pool;
  double mem = 0, cpus = 0, gpus = 0;
  int priority = 0;
  int max_retries = 0;
  std::vector<Instance> instances;

  bool completed() const { return status == "completed"; }
  bool success() const { return state == "success"; }

  static Job from_json(const Json& j) {
    Job job;
    job.uuid = j.get_str("uuid");
    job.name = j.get_str("name");
    job.command = j.get_str("command");
    job.user = j.get_str("user");
    job.status = j.get_str("status");
    job.state = j.get_str("state");
    job.pool = j.get_str("pool");
    job.mem = j.get_num("mem");
    job.cpus = j.get_num("cpus");
    job.gpus = j.get_num("gpus");
    job.priority = static_cast<int>(j.get_num("priority"));
    job.max_retries = static_cast<int>(j.get_num("max_retries"));
    if (const Json* insts = j.get("instances")) {
      for (const Json& ij : insts->arr) {
        Instance in;
        in.task_id = ij.get_str("task_id");
        in.status = ij.get_str("status");
        in.hostname = ij.get_str("hostname");
        if (const Json* ec = ij.get("exit_code")) {
          if (ec->type == Json::NUM) {
            in.exit_code = static_cast<int>(ec->num);
            in.has_exit_code = true;
          }
        }
        if (const Json* p = ij.get("preempted")) in.preempted = p->b;
        in.reason_string = ij.get_str("reason_string");
        job.instances.push_back(std::move(in));
      }
    }
    return job;
  }
};

struct JobSpec {
  std::string command;
  double mem = 128.0;
  double cpus = 1.0;
  double gpus = 0.0;
  std::string name;
  std::string pool;
  int priority = -1;          // <0 -> server default
  int max_retries = 1;
  std::map<std::string, std::string> env;
  std::map<std::string, std::string> labels;

  Json to_json() const {
    Json j = Json::object();
    j.set("command", Json::string(command));
    j.set("mem", Json::number(mem));
    j.set("cpus", Json::number(cpus));
    j.set("gpus", Json::number(gpus));
    j.set("max_retries", Json::number(max_retries));
    if (!name.empty()) j.set("name", Json::string(name));
    if (priority >= 0) j.set("priority", Json::number(priority));
    if (!env.empty()) {
      Json e = Json::object();
      for (auto& kv : env) e.set(kv.first, Json::string(kv.second));
      j.set("env", std::move(e));
    }
    if (!labels.empty()) {
      Json l = Json::object();
      for (auto& kv : labels) l.set(kv.first, Json::string(kv.second));
      j.set("labels", std::move(l));
    }
    return j;
  }
};

class ApiError : public std::runtime_error {
 public:
  ApiError(int status, const std::string& body)
      : std::runtime_error("HTTP " + std::to_string(status) + ": " + body),
        status(status) {}
  int status;
};

class JobClient {
 public:
  JobClient(std::string host, int port, std::string user,
            int timeout_ms = 30000)
      : transport_(std::move(host), port, timeout_ms),
        user_(std::move(user)) {}

  std::vector<std::string> submit(const std::vector<JobSpec>& specs,
                                  const std::string& pool = "") {
    Json body = Json::object();
    Json jobs = Json::array();
    for (const JobSpec& s : specs) jobs.arr.push_back(s.to_json());
    body.set("jobs", std::move(jobs));
    if (!pool.empty()) body.set("pool", Json::string(pool));
    Json resp = call("POST", "/jobs", body.dump());
    std::vector<std::string> uuids;
    if (const Json* out = resp.get("jobs"))
      for (const Json& u : out->arr) uuids.push_back(u.str);
    return uuids;
  }

  std::string submit(const JobSpec& spec) {
    return submit(std::vector<JobSpec>{spec}).at(0);
  }

  Job query(const std::string& uuid) {
    return Job::from_json(call("GET", "/jobs/" + uuid, ""));
  }

  void abort(const std::vector<std::string>& uuids) {
    std::string path = "/jobs?";
    for (size_t i = 0; i < uuids.size(); ++i) {
      if (i) path += "&";
      path += "uuid=" + uuids[i];
    }
    call("DELETE", path, "", /*allow_empty=*/true);
  }

  void retry(const std::string& uuid, int retries) {
    Json body = Json::object();
    body.set("job", Json::string(uuid));
    body.set("retries", Json::number(retries));
    call("POST", "/retry", body.dump(), /*allow_empty=*/true);
  }

  // Listener-polling equivalent (JobClient.java status-update loop).
  // Returns the exact JSON of the poll that showed completion (no
  // re-read race with a concurrent retry).
  Json wait_for_job_json(const std::string& uuid, int timeout_ms,
                         int poll_ms = 1000) {
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms);
    while (true) {
      Json j = call("GET", "/jobs/" + uuid, "");
      if (j.get_str("status") == "completed") return j;
      if (std::chrono::steady_clock::now() >= deadline)
        throw std::runtime_error("timeout waiting for " + uuid);
      std::this_thread::sleep_for(std::chrono::milliseconds(poll_ms));
    }
  }

  Job wait_for_job(const std::string& uuid, int timeout_ms,
                   int poll_ms = 1000) {
    return Job::from_json(wait_for_job_json(uuid, timeout_ms, poll_ms));
  }

  Json call(const std::string& method, const std::string& path,
            const std::string& body, bool allow_empty = false) {
    std::map<std::string, std::string> headers{{"X-Cook-User", user_}};
    HttpResponse resp = transport_.request(method, path, headers, body);
    if (resp.status >= 400) throw ApiError(resp.status, resp.body);
    if (resp.body.empty()) {
      if (allow_empty) return Json::null();
      throw std::runtime_error("empty response body");
    }
    return JsonParser(resp.body).parse();
  }

 private:
  Transport transport_;
  std::string user_;
};

}  // namespace cook

// ---------------------------------------------------------------------------
// C ABI for ctypes / FFI consumers
// ---------------------------------------------------------------------------
extern "C" {

struct CookHandle {
  std::unique_ptr<cook::JobClient> client;
  std::string last_error;
};

static char* dup_str(const std::string& s) {
  char* out = static_cast<char*>(std::malloc(s.size() + 1));
  std::memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

// Parse + re-dump a JSON document (test/fuzz surface for the parser);
// returns malloc'd JSON or NULL on parse error.
char* cook_json_roundtrip(const char* in) {
  if (!in) return nullptr;
  try {
    return dup_str(cook::JsonParser(in).parse().dump());
  } catch (const std::exception&) {
    return nullptr;
  }
}

void* cook_client_new(const char* host, int port, const char* user,
                      int timeout_ms) {
  auto* h = new CookHandle;
  h->client = std::make_unique<cook::JobClient>(host, port, user,
                                                timeout_ms);
  return h;
}

void cook_client_free(void* handle) {
  delete static_cast<CookHandle*>(handle);
}

const char* cook_last_error(void* handle) {
  return static_cast<CookHandle*>(handle)->last_error.c_str();
}

void cook_free_str(char* s) { std::free(s); }

// Submit a raw job-spec JSON object; returns malloc'd uuid or NULL.
char* cook_submit_json(void* handle, const char* spec_json,
                       const char* pool) {
  auto* h = static_cast<CookHandle*>(handle);
  try {
    cook::Json spec = cook::JsonParser(spec_json).parse();
    cook::Json body = cook::Json::object();
    cook::Json jobs = cook::Json::array();
    jobs.arr.push_back(std::move(spec));
    body.set("jobs", std::move(jobs));
    if (pool && *pool) body.set("pool", cook::Json::string(pool));
    cook::Json resp = h->client->call("POST", "/jobs", body.dump());
    const cook::Json* out = resp.get("jobs");
    if (!out || out->arr.empty())
      throw std::runtime_error("no uuid in response");
    return dup_str(out->arr[0].str);
  } catch (const std::exception& e) {
    h->last_error = e.what();
    return nullptr;
  }
}

// Typed-field submission (mirrors JobSpec): returns malloc'd uuid.
char* cook_submit(void* handle, const char* command, double mem,
                  double cpus, double gpus, int max_retries,
                  const char* name, const char* pool) {
  auto* h = static_cast<CookHandle*>(handle);
  try {
    cook::JobSpec spec;
    spec.command = command;
    spec.mem = mem;
    spec.cpus = cpus;
    spec.gpus = gpus;
    spec.max_retries = max_retries;
    if (name && *name) spec.name = name;
    return dup_str(h->client->submit(std::vector<cook::JobSpec>{spec},
                                     pool ? pool : "").at(0));
  } catch (const std::exception& e) {
    h->last_error = e.what();
    return nullptr;
  }
}

// Returns the full job JSON (malloc'd) or NULL.
char* cook_query_json(void* handle, const char* uuid) {
  auto* h = static_cast<CookHandle*>(handle);
  try {
    cook::Json j = h->client->call("GET", std::string("/jobs/") + uuid, "");
    return dup_str(j.dump());
  } catch (const std::exception& e) {
    h->last_error = e.what();
    return nullptr;
  }
}

// Returns "status state" (e.g. "completed success"), malloc'd, or NULL.
char* cook_job_state(void* handle, const char* uuid) {
  auto* h = static_cast<CookHandle*>(handle);
  try {
    cook::Job job = h->client->query(uuid);
    return dup_str(job.status + " " + job.state);
  } catch (const std::exception& e) {
    h->last_error = e.what();
    return nullptr;
  }
}

int cook_kill(void* handle, const char* uuid) {
  auto* h = static_cast<CookHandle*>(handle);
  try {
    h->client->abort({uuid});
    return 0;
  } catch (const std::exception& e) {
    h->last_error = e.what();
    return -1;
  }
}

int cook_retry(void* handle, const char* uuid, int retries) {
  auto* h = static_cast<CookHandle*>(handle);
  try {
    h->client->retry(uuid, retries);
    return 0;
  } catch (const std::exception& e) {
    h->last_error = e.what();
    return -1;
  }
}

// Blocks until completion; returns final job JSON (malloc'd) or NULL.
char* cook_wait_for_job(void* handle, const char* uuid, int timeout_ms,
                        int poll_ms) {
  auto* h = static_cast<CookHandle*>(handle);
  try {
    return dup_str(
        h->client->wait_for_job_json(uuid, timeout_ms, poll_ms).dump());
  } catch (const std::exception& e) {
    h->last_error = e.what();
    return nullptr;
  }
}

}  // extern "C"
