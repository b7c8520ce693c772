// Host-side match driver: the resident job/offer book.
//
// The native piece of the match path (SURVEY.md §7.8): between cycles it
// owns the per-job placement state (prior hosts for the novel-host
// constraint, attribute-EQUALS constraints) and per-cycle it ingests the
// offer set and fills the dense forbidden[P, H] mask the TPU kernels
// consume — the O(P x H) work the reference does inside Fenzo's
// ConstraintEvaluator callbacks (constraints.clj:57-311), done here as
// tight array loops instead of per-(job, host) Java/Python calls.
//
// All strings are interned to int64 ids on the Python side; this layer
// never sees text. Exposed as a C ABI for ctypes (no pybind11 in the
// image). Single-writer per book (the coordinator cycle); no locking.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Job {
    int64_t uuid = -1;                     // interned job uuid (-1 = free)
    std::vector<int64_t> prior_hosts;      // novel-host exclusions
    std::vector<std::pair<int64_t, int64_t>> constraints;  // (attr, val)
    std::vector<int64_t> tmp_hosts;        // per-cycle exclusions (group)
    std::vector<std::pair<int64_t, int64_t>> tmp_constraints;
};

struct Book {
    std::vector<Job> jobs;
    std::vector<int64_t> free_slots;
    std::unordered_map<int64_t, int32_t> uuid_to_slot;

    // per-cycle host state
    std::vector<int64_t> host_names;
    std::unordered_map<int64_t, int32_t> host_idx;
    // attr id -> dense value column (len H, -1 = attr absent)
    std::unordered_map<int64_t, std::vector<int64_t>> attr_cols;
    // reservations: host -> owning job uuid
    std::vector<uint8_t> reserved;
    std::vector<int64_t> reserved_owner;
};

Book* B(int64_t h) { return reinterpret_cast<Book*>(h); }

}  // namespace

extern "C" {

int64_t mb_create() { return reinterpret_cast<int64_t>(new Book()); }

void mb_destroy(int64_t h) { delete B(h); }

// ---- persistent job state -------------------------------------------
int32_t mb_add_job(int64_t h, int64_t uuid) {
    Book* b = B(h);
    auto it = b->uuid_to_slot.find(uuid);
    if (it != b->uuid_to_slot.end()) return it->second;
    int32_t slot;
    if (!b->free_slots.empty()) {
        slot = static_cast<int32_t>(b->free_slots.back());
        b->free_slots.pop_back();
        b->jobs[slot] = Job();
    } else {
        slot = static_cast<int32_t>(b->jobs.size());
        b->jobs.emplace_back();
    }
    b->jobs[slot].uuid = uuid;
    b->uuid_to_slot[uuid] = slot;
    return slot;
}

void mb_remove_job(int64_t h, int64_t uuid) {
    Book* b = B(h);
    auto it = b->uuid_to_slot.find(uuid);
    if (it == b->uuid_to_slot.end()) return;
    b->jobs[it->second].uuid = -1;
    b->free_slots.push_back(it->second);
    b->uuid_to_slot.erase(it);
}

void mb_job_prior_host(int64_t h, int32_t slot, int64_t host_name) {
    B(h)->jobs[slot].prior_hosts.push_back(host_name);
}

void mb_job_constraint(int64_t h, int32_t slot, int64_t attr, int64_t val) {
    B(h)->jobs[slot].constraints.emplace_back(attr, val);
}

int64_t mb_num_jobs(int64_t h) {
    return static_cast<int64_t>(B(h)->uuid_to_slot.size());
}

// ---- per-cycle state ------------------------------------------------
void mb_begin_cycle(int64_t h) {
    Book* b = B(h);
    b->host_names.clear();
    b->host_idx.clear();
    b->attr_cols.clear();
    b->reserved.clear();
    b->reserved_owner.clear();
    for (auto& j : b->jobs) {
        j.tmp_hosts.clear();
        j.tmp_constraints.clear();
    }
}

void mb_set_hosts(int64_t h, const int64_t* names, int64_t n) {
    Book* b = B(h);
    b->host_names.assign(names, names + n);
    b->host_idx.clear();
    b->host_idx.reserve(n);
    for (int64_t i = 0; i < n; i++) b->host_idx[names[i]] = (int32_t)i;
    b->reserved.assign(n, 0);
    b->reserved_owner.assign(n, -1);
}

// one (attr, value) pair of one host; builds the dense column lazily.
// Out-of-range host indices are dropped — this ABI is exposed to
// evolving Python callers and must fail safe, not corrupt the heap.
void mb_host_attr(int64_t h, int32_t host, int64_t attr, int64_t val) {
    Book* b = B(h);
    if (host < 0 || host >= (int64_t)b->host_names.size()) return;
    auto& col = b->attr_cols[attr];
    if (col.empty()) col.assign(b->host_names.size(), -1);
    col[host] = val;
}

// batched form: parallel arrays of (host index, attr id, value id)
void mb_set_host_attrs(int64_t h, const int32_t* hosts,
                       const int64_t* attrs, const int64_t* vals,
                       int64_t n) {
    Book* b = B(h);
    const int64_t H = static_cast<int64_t>(b->host_names.size());
    for (int64_t i = 0; i < n; i++) {
        if (hosts[i] < 0 || hosts[i] >= H) continue;
        auto& col = b->attr_cols[attrs[i]];
        if (col.empty()) col.assign(b->host_names.size(), -1);
        col[hosts[i]] = vals[i];
    }
}

void mb_reserve(int64_t h, int64_t host_name, int64_t owner_uuid) {
    Book* b = B(h);
    auto it = b->host_idx.find(host_name);
    if (it == b->host_idx.end()) return;
    b->reserved[it->second] = 1;
    b->reserved_owner[it->second] = owner_uuid;
}

void mb_job_tmp_exclude(int64_t h, int32_t slot, int64_t host_name) {
    B(h)->jobs[slot].tmp_hosts.push_back(host_name);
}

void mb_job_tmp_constraint(int64_t h, int32_t slot, int64_t attr,
                           int64_t val) {
    B(h)->jobs[slot].tmp_constraints.emplace_back(attr, val);
}

// ---- the hot call ---------------------------------------------------
namespace {

// Fill rows [p0, p1) of out[P * H].
void fill_rows(Book* b, const int32_t* slots, int64_t p0, int64_t p1,
               uint8_t* out) {
    const int64_t H = static_cast<int64_t>(b->host_names.size());
    const bool any_reserved = !b->reserved.empty();
    for (int64_t p = p0; p < p1; p++) {
        uint8_t* row = out + p * H;
        std::memset(row, 0, H);
        const Job& j = b->jobs[slots[p]];
        for (int64_t name : j.prior_hosts) {
            auto it = b->host_idx.find(name);
            if (it != b->host_idx.end()) row[it->second] = 1;
        }
        for (int64_t name : j.tmp_hosts) {
            auto it = b->host_idx.find(name);
            if (it != b->host_idx.end()) row[it->second] = 1;
        }
        for (const auto& [attr, val] : j.constraints) {
            auto it = b->attr_cols.find(attr);
            if (it == b->attr_cols.end()) {
                std::memset(row, 1, H);   // attr absent everywhere
                continue;
            }
            const int64_t* col = it->second.data();
            for (int64_t i = 0; i < H; i++) row[i] |= (col[i] != val);
        }
        for (const auto& [attr, val] : j.tmp_constraints) {
            auto it = b->attr_cols.find(attr);
            if (it == b->attr_cols.end()) {
                std::memset(row, 1, H);
                continue;
            }
            const int64_t* col = it->second.data();
            for (int64_t i = 0; i < H; i++) row[i] |= (col[i] != val);
        }
        if (any_reserved) {
            const uint8_t* res = b->reserved.data();
            const int64_t* owner = b->reserved_owner.data();
            const int64_t uuid = j.uuid;
            for (int64_t i = 0; i < H; i++)
                row[i] |= (res[i] & (owner[i] != uuid));
        }
    }
}

}  // namespace

// Fill out[P * H] (row-major uint8, 1 = forbidden) for the given job
// slots in queue order. Rows are independent; large masks are split
// across threads.
void mb_fill_forbidden(int64_t h, const int32_t* slots, int64_t P,
                       uint8_t* out) {
    Book* b = B(h);
    const int64_t H = static_cast<int64_t>(b->host_names.size());
    const int64_t cells = P * H;
    int64_t n_threads = 1;
    if (cells >= 1 << 21) {   // ~2M cells: threading pays for itself
        n_threads = static_cast<int64_t>(
            std::min<size_t>(8, std::thread::hardware_concurrency()));
        n_threads = std::max<int64_t>(1, std::min(n_threads, P));
    }
    if (n_threads == 1) {
        fill_rows(b, slots, 0, P, out);
        return;
    }
    std::vector<std::thread> ts;
    const int64_t chunk = (P + n_threads - 1) / n_threads;
    for (int64_t t = 0; t < n_threads; t++) {
        const int64_t p0 = t * chunk;
        const int64_t p1 = std::min(P, p0 + chunk);
        if (p0 >= p1) break;
        ts.emplace_back(fill_rows, b, slots, p0, p1, out);
    }
    for (auto& t : ts) t.join();
}

}  // extern "C"
