// Runtime core of the serving engine: the paged KV cache's page allocator and
// the continuous-batching admission scheduler, behind a C ABI that
// ``flashattention_tpu_torch/runtime/native.py`` binds by ctypes.
//
// Counterpart of ``flashattention_tpu/csrc/fa_runtime.cc``: the same
// ``extern "C"`` names and semantics.  Host code only (no CUDA): page
// bookkeeping and admission stay off the device, beside the kernels of
// ``csrc/*.cu``.  Built with ``g++ -O2 -std=c++17 -fPIC -shared`` at first
// use (``runtime/native.py``).

#include <cstdint>
#include <deque>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

// LIFO free list: the most recently freed page is handed out first.
struct Allocator {
  std::vector<int32_t> free_pages;
  std::mutex mu;
};

struct Request {
  int64_t id;
  int32_t prompt_len;
  int32_t max_new_tokens;
  int32_t page_size;
  // Pages its prompt needs now, and at worst (prompt + every new token).
  int32_t pages_now() const { return (prompt_len + page_size - 1) / page_size; }
  int32_t pages_max() const {
    return (prompt_len + max_new_tokens + page_size - 1) / page_size;
  }
};

struct Scheduler {
  std::deque<Request> waiting;  // FCFS
  std::unordered_map<int64_t, Request> running;
  int32_t max_batch = 0;
  int32_t page_size = 0;
  bool reserve_worst_case = false;
  std::mutex mu;
};

}  // namespace

extern "C" {

// ── Page allocator ─────────────────────────────────────────────────────────

void* fa_alloc_create(int32_t num_pages) {
  auto* a = new Allocator();
  a->free_pages.reserve(num_pages);
  // Pushed in reverse, so that pages 0, 1, 2, ... come out first.
  for (int32_t i = num_pages - 1; i >= 0; --i) a->free_pages.push_back(i);
  return a;
}

void fa_alloc_destroy(void* h) { delete static_cast<Allocator*>(h); }

int32_t fa_alloc_num_free(void* h) {
  auto* a = static_cast<Allocator*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  return static_cast<int32_t>(a->free_pages.size());
}

// n pages into out[0, n): 0, or -1 when fewer are free (nothing taken).
int32_t fa_alloc_pages(void* h, int32_t n, int32_t* out) {
  auto* a = static_cast<Allocator*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  if (static_cast<int32_t>(a->free_pages.size()) < n) return -1;
  for (int32_t i = 0; i < n; ++i) {
    out[i] = a->free_pages.back();
    a->free_pages.pop_back();
  }
  return 0;
}

void fa_alloc_free_pages(void* h, const int32_t* pages, int32_t n) {
  auto* a = static_cast<Allocator*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  for (int32_t i = 0; i < n; ++i) a->free_pages.push_back(pages[i]);
}

// ── Admission scheduler ────────────────────────────────────────────────────
//
// FCFS: the head of the queue is admitted while a batch slot is free and the
// page budget covers its prompt (reserve_worst_case = 0: decode may preempt
// later) or its whole span (reserve_worst_case = 1: no preemption).

void* fa_sched_create(int32_t max_batch, int32_t page_size, int32_t reserve_worst_case) {
  auto* s = new Scheduler();
  s->max_batch = max_batch;
  s->page_size = page_size;
  s->reserve_worst_case = reserve_worst_case != 0;
  return s;
}

void fa_sched_destroy(void* h) { delete static_cast<Scheduler*>(h); }

void fa_sched_add_request(void* h, int64_t id, int32_t prompt_len, int32_t max_new_tokens) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  s->waiting.push_back(Request{id, prompt_len, max_new_tokens, s->page_size});
}

int32_t fa_sched_num_waiting(void* h) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return static_cast<int32_t>(s->waiting.size());
}

int32_t fa_sched_num_running(void* h) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return static_cast<int32_t>(s->running.size());
}

// Admits up to max_out waiting requests into out_ids and returns how many.
// free_pages is the allocator's free count; the caller allocates the pages
// afterwards, so the scheduler never touches the allocator.
int32_t fa_sched_admit(void* h, int32_t free_pages, int64_t* out_ids, int32_t max_out) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  int32_t admitted = 0;
  int32_t budget = free_pages;
  if (s->reserve_worst_case) {
    // A running request's decode headroom (its span's pages less the prompt
    // pages already allocated) stays reserved across admit() calls.
    for (const auto& kv : s->running) budget -= kv.second.pages_max() - kv.second.pages_now();
  }
  while (!s->waiting.empty() && admitted < max_out &&
         static_cast<int32_t>(s->running.size()) < s->max_batch) {
    const Request& r = s->waiting.front();
    int32_t need = s->reserve_worst_case ? r.pages_max() : r.pages_now();
    if (need > budget) break;  // strict FCFS: nothing overtakes the head
    budget -= need;
    out_ids[admitted++] = r.id;
    s->running.emplace(r.id, r);
    s->waiting.pop_front();
  }
  return admitted;
}

void fa_sched_finish(void* h, int64_t id) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  s->running.erase(id);
}

// Drops a request from the running set or the queue: 1 if found, else 0.
// Freeing a running request's pages is the caller's job.
int32_t fa_sched_cancel(void* h, int64_t id) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  if (s->running.erase(id) > 0) return 1;
  for (auto it = s->waiting.begin(); it != s->waiting.end(); ++it) {
    if (it->id == id) {
      s->waiting.erase(it);
      return 1;
    }
  }
  return 0;
}

}  // extern "C"
