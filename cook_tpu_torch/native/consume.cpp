// consume.cpp — native consume-side fast path for the per-cycle host
// work between device readback and the launch/status transactions.
//
// Three hot folds that the Python consume/dispatch loop paid per item
// (the 7k-vs-67k single-leader gap): hand-built status-line assembly
// (state/store.py update_instances_bulk), CKS1 spec-frame splicing
// (backends/specwire.py frame_segments), and the per-host resource
// totals behind the offer/_used bookkeeping (backends/agent.py).
// Every entry point is a pure function over caller-owned buffers —
// no handles, no threads, no global state — and every one has a
// byte-identical pure-Python fallback in native/consumefold.py.
//
// C ABI (all integers little-endian host order; buffers returned by
// cf_status_lines / cf_concat are malloc'd and must be released with
// cf_free):
//
//   cf_status_lines(n, task_ids, task_lens, frags, frag_lens,
//                   reasons, preempted, exits,
//                   head, head_len, tail, tail_len, &out_len)
//       -> buffer of n status lines, each
//          head | task_id | frag | reason-or-"null"
//               | ","p":true/false,"e":" | exit-or-"null" | tail
//          (reason/exit use INT64_MIN as the "null" sentinel)
//   cf_concat(n, segs, seg_lens, header, header_len, &out_len)
//       -> header followed by the n segments, spliced once
//   cf_usage_totals(n, mem, cpus, gpus, out3)
//       -> left-to-right IEEE sums (same order as the Python loop,
//          so the folded _used aggregate is bit-identical)
//   cf_free(p)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

constexpr int64_t kNullSentinel = INT64_MIN;

const char kNull[] = "null";
const char kPTrue[] = ",\"p\":true,\"e\":";
const char kPFalse[] = ",\"p\":false,\"e\":";

// Longest decimal int64 is 20 chars ("-9223372036854775808").
inline size_t int_width(int64_t v, char* buf) {
    return (size_t)snprintf(buf, 24, "%lld", (long long)v);
}

}  // namespace

extern "C" {

char* cf_status_lines(int64_t n,
                      const char** task_ids, const int32_t* task_lens,
                      const char** frags, const int32_t* frag_lens,
                      const int64_t* reasons, const uint8_t* preempted,
                      const int64_t* exits,
                      const char* head, int32_t head_len,
                      const char* tail, int32_t tail_len,
                      int64_t* out_len) {
    if (n < 0) return nullptr;
    // sizing pass: exact per-row width, so the assembly pass is one
    // allocation + straight memcpy with no growth checks
    char numbuf[24];
    size_t total = 0;
    for (int64_t i = 0; i < n; ++i) {
        total += (size_t)head_len + (size_t)task_lens[i]
               + (size_t)frag_lens[i] + (size_t)tail_len;
        total += reasons[i] == kNullSentinel
               ? sizeof(kNull) - 1 : int_width(reasons[i], numbuf);
        total += preempted[i] ? sizeof(kPTrue) - 1 : sizeof(kPFalse) - 1;
        total += exits[i] == kNullSentinel
               ? sizeof(kNull) - 1 : int_width(exits[i], numbuf);
    }
    // each number is formatted into numbuf and copied: snprintf in
    // place could be told 24 bytes where fewer remain, which glibc's
    // _FORTIFY_SOURCE=3 checks (and aborts on) against the allocation
    // (+1: never a zero-byte allocation)
    char* out = (char*)malloc(total + 1);
    if (out == nullptr) return nullptr;
    char* p = out;
    for (int64_t i = 0; i < n; ++i) {
        memcpy(p, head, (size_t)head_len);          p += head_len;
        memcpy(p, task_ids[i], (size_t)task_lens[i]); p += task_lens[i];
        memcpy(p, frags[i], (size_t)frag_lens[i]);  p += frag_lens[i];
        if (reasons[i] == kNullSentinel) {
            memcpy(p, kNull, sizeof(kNull) - 1);    p += sizeof(kNull) - 1;
        } else {
            size_t w = int_width(reasons[i], numbuf);
            memcpy(p, numbuf, w);                   p += w;
        }
        if (preempted[i]) {
            memcpy(p, kPTrue, sizeof(kPTrue) - 1);  p += sizeof(kPTrue) - 1;
        } else {
            memcpy(p, kPFalse, sizeof(kPFalse) - 1); p += sizeof(kPFalse) - 1;
        }
        if (exits[i] == kNullSentinel) {
            memcpy(p, kNull, sizeof(kNull) - 1);    p += sizeof(kNull) - 1;
        } else {
            size_t w = int_width(exits[i], numbuf);
            memcpy(p, numbuf, w);                   p += w;
        }
        memcpy(p, tail, (size_t)tail_len);          p += tail_len;
    }
    *out_len = (int64_t)(p - out);
    return out;
}

char* cf_concat(int64_t n, const char** segs, const int64_t* seg_lens,
                const char* header, int64_t header_len,
                int64_t* out_len) {
    if (n < 0 || header_len < 0) return nullptr;
    size_t total = (size_t)header_len;
    for (int64_t i = 0; i < n; ++i) total += (size_t)seg_lens[i];
    char* out = (char*)malloc(total ? total : 1);
    if (out == nullptr) return nullptr;
    char* p = out;
    memcpy(p, header, (size_t)header_len);
    p += header_len;
    for (int64_t i = 0; i < n; ++i) {
        memcpy(p, segs[i], (size_t)seg_lens[i]);
        p += seg_lens[i];
    }
    *out_len = (int64_t)total;
    return out;
}

void cf_usage_totals(int64_t n, const double* mem, const double* cpus,
                     const double* gpus, double* out3) {
    double m = 0.0, c = 0.0, g = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        m += mem[i];
        c += cpus[i];
        g += gpus[i];
    }
    out3[0] = m;
    out3[1] = c;
    out3[2] = g;
}

void cf_free(char* p) {
    free(p);
}

}  // extern "C"
