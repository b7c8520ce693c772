// Durable append-only event log — the native write path of the job
// store (cook_tpu/state/store.py).
//
// Role in the framework: every store transaction appends one JSON line
// here; a restarted leader replays snapshot + tail to rebuild all
// in-memory state.  This is the equivalent of the reference's Datomic
// transactor durability layer (reference: scheduler/src/cook/datomic.clj,
// bin/start-datomic.sh — an external JVM process there; a native
// in-process writer here).
//
// Design: group commit.  Appends go to an in-memory buffer under a
// mutex; a background thread drains the buffer with one write(2) and
// one fdatasync(2) per batch, so N concurrent appenders pay ~1/N of an
// fsync each.  A failed write(2) (ENOSPC, EIO, ...) re-queues the
// unwritten remainder at the FRONT of the buffer and retries with
// backoff — the durable watermark only ever advances over bytes that
// are actually on disk, in order.  el_sync() is the explicit durability
// barrier: it blocks (bounded by timeout_ms) until every line appended
// before the call is on disk.
//
// C ABI (consumed by ctypes in cook_tpu/native/eventlog.py):
//   el_open(path)              -> handle (>0) or 0 on error; counts existing lines
//   el_append(h, s, len)       -> sequence number of the appended line, -1 on error
//   el_lines(h)                -> total lines (existing + appended)
//   el_sync(h, timeout_ms)     -> 0 durable; 1 timed out; -1 bad handle
//   el_close(h)                -> flush what it can, close; 0 ok
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Log {
  int fd = -1;
  std::mutex mu;
  std::condition_variable cv_work;   // signals the syncer there is data
  std::condition_variable cv_done;   // signals waiters the watermark moved
  std::string buf;                   // pending bytes, oldest first
  int64_t buffered = 0;              // lines currently in buf
  int64_t appended = 0;              // lines handed to el_append, ever
  int64_t durable = 0;               // lines fdatasync'd
  int64_t existing = 0;              // lines present when opened
  bool stop = false;
  bool backoff = false;              // last write failed; wait before retry
  std::thread syncer;

  void run() {
    std::unique_lock<std::mutex> lk(mu);
    while (true) {
      if (backoff)
        cv_work.wait_for(lk, std::chrono::milliseconds(50));
      else
        cv_work.wait(lk, [&] { return stop || !buf.empty(); });
      if (buf.empty()) {
        if (stop) break;
        continue;
      }
      std::string batch;
      batch.swap(buf);
      int64_t batch_lines = buffered;
      buffered = 0;
      lk.unlock();

      size_t written = 0;
      while (written < batch.size()) {
        ssize_t n = ::write(fd, batch.data() + written,
                            batch.size() - written);
        if (n <= 0) {
          if (n < 0 && errno == EINTR) continue;
          break;
        }
        written += (size_t)n;
      }
      bool complete = written == batch.size();
      if (written > 0) ::fdatasync(fd);
      int64_t lines_done = 0;
      // count fully-written lines; a partially written line stays queued
      size_t keep_from = written;
      for (size_t i = 0; i < written; i++)
        if (batch[i] == '\n') lines_done++;
      // re-queue from the start of the first incomplete line
      if (!complete) {
        keep_from = 0;
        int64_t seen = 0;
        for (size_t i = 0; i < batch.size(); i++) {
          if (seen == lines_done) { keep_from = i; break; }
          if (batch[i] == '\n') seen++;
        }
        // written bytes past the last full newline were persisted but the
        // line is incomplete: rewind the file to the end of the last full
        // line so the retry does not duplicate the partial prefix.
        if (written > keep_from)
          if (::ftruncate(fd, ::lseek(fd, 0, SEEK_END) -
                                  (off_t)(written - keep_from)) == 0)
            ::lseek(fd, 0, SEEK_END);
      }

      lk.lock();
      durable += lines_done;
      if (!complete) {
        buf.insert(0, batch.substr(keep_from));
        buffered += batch_lines - lines_done;
        backoff = true;
      } else {
        backoff = false;
      }
      cv_done.notify_all();
      // closing on a sick disk: flush is best-effort, don't spin forever
      if (stop && backoff) break;
    }
  }
};

std::mutex g_mu;
std::map<int64_t, std::shared_ptr<Log>> g_logs;
int64_t g_next = 1;

std::shared_ptr<Log> get(int64_t h) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_logs.find(h);
  return it == g_logs.end() ? nullptr : it->second;
}

int64_t count_lines(int fd) {
  int64_t n = 0;
  char chunk[1 << 16];
  ::lseek(fd, 0, SEEK_SET);
  ssize_t r;
  while ((r = ::read(fd, chunk, sizeof chunk)) > 0)
    for (ssize_t i = 0; i < r; i++) n += (chunk[i] == '\n');
  ::lseek(fd, 0, SEEK_END);
  return n;
}

}  // namespace

extern "C" {

int64_t el_open(const char* path) {
  int fd = ::open(path, O_RDWR | O_CREAT | O_APPEND, 0644);
  if (fd < 0) return 0;
  auto log = std::make_shared<Log>();
  log->fd = fd;
  log->existing = count_lines(fd);
  Log* raw = log.get();
  log->syncer = std::thread([raw] { raw->run(); });
  std::lock_guard<std::mutex> lk(g_mu);
  int64_t h = g_next++;
  g_logs[h] = log;
  return h;
}

int64_t el_append(int64_t h, const char* s, int64_t len) {
  auto log = get(h);
  if (!log) return -1;
  std::lock_guard<std::mutex> lk(log->mu);
  log->buf.append(s, (size_t)len);
  log->buf.push_back('\n');
  log->buffered++;
  log->appended++;
  log->cv_work.notify_one();
  return log->existing + log->appended;
}

int64_t el_append_batch(int64_t h, const char* s, int64_t len,
                        int64_t nlines) {
  // s is nlines pre-terminated records ('\n' after every record,
  // including the last): one mutex acquisition and one buffer splice
  // for the whole batch, so bulk transactions stop paying a lock
  // round-trip per line. The syncer's durable-watermark accounting
  // counts '\n' bytes, so it needs no changes.
  auto log = get(h);
  if (!log || nlines <= 0) return -1;
  std::lock_guard<std::mutex> lk(log->mu);
  log->buf.append(s, (size_t)len);
  log->buffered += nlines;
  log->appended += nlines;
  log->cv_work.notify_one();
  return log->existing + log->appended;
}

int64_t el_append_segments(int64_t h, const char** segs,
                           const int64_t* lens, int64_t nsegs,
                           int64_t nlines) {
  // Scatter-gather variant of el_append_batch: segs[i] (lens[i] bytes
  // each) concatenate to nlines pre-terminated records.  The store's
  // zero-copy encoders hand over the constant key fragments and the
  // variable uuid/value fragments as separate segments, so Python never
  // pays a join — the single reserve+append splice here is the only
  // copy between the transaction and the syncer's write(2).
  auto log = get(h);
  if (!log || nlines <= 0 || nsegs <= 0) return -1;
  size_t total = 0;
  for (int64_t i = 0; i < nsegs; i++) total += (size_t)lens[i];
  std::lock_guard<std::mutex> lk(log->mu);
  log->buf.reserve(log->buf.size() + total);
  for (int64_t i = 0; i < nsegs; i++)
    log->buf.append(segs[i], (size_t)lens[i]);
  log->buffered += nlines;
  log->appended += nlines;
  log->cv_work.notify_one();
  return log->existing + log->appended;
}

int64_t el_lines(int64_t h) {
  auto log = get(h);
  if (!log) return -1;
  std::lock_guard<std::mutex> lk(log->mu);
  return log->existing + log->appended;
}

int el_sync(int64_t h, int64_t timeout_ms) {
  auto log = get(h);
  if (!log) return -1;
  std::unique_lock<std::mutex> lk(log->mu);
  int64_t want = log->appended;
  bool ok = log->cv_done.wait_for(
      lk, std::chrono::milliseconds(timeout_ms),
      [&] { return log->durable >= want || log->stop; });
  (void)ok;
  return log->durable >= want ? 0 : 1;
}

int el_close(int64_t h) {
  std::shared_ptr<Log> log;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_logs.find(h);
    if (it == g_logs.end()) return -1;
    log = it->second;
    g_logs.erase(it);
  }
  {
    std::lock_guard<std::mutex> lk(log->mu);
    log->stop = true;
    log->cv_work.notify_one();
    log->cv_done.notify_all();
  }
  log->syncer.join();
  ::fdatasync(log->fd);
  ::close(log->fd);
  {
    // wake any el_sync stragglers still holding the shared_ptr
    std::lock_guard<std::mutex> lk(log->mu);
    log->cv_done.notify_all();
  }
  return 0;
}

}  // extern "C"
