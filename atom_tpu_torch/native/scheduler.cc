// Native serving runtime: KV page allocator + FCFS continuous-batch scheduler.
//
// The port's own copy of the JAX package's host scheduler: the device path
// is PyTorch around CUDA kernels; this is the host side of the serving
// engine.  At large batch sizes and sub-millisecond step times the Python
// bookkeeping (page lists, table assembly, per-slot scans) becomes a
// per-step host tax; this C++ core does all of it in O(batch) with zero
// allocation on the step path, writing the page table / seq-len arrays
// directly into caller-provided (numpy) buffers.
//
// Exposed as a C ABI consumed via ctypes (built with g++ at first use by
// atom_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Seq {
  int32_t request_id = -1;   // -1: slot free
  int32_t remaining = 0;     // output tokens still to generate
  int32_t seqlen = 0;        // tokens INCLUDING any just-reserved decode token
  bool held = false;         // admitted but still prefilling (chunked):
                             // excluded from decode_step until activated
  std::vector<int32_t> pages;
};

struct Scheduler {
  int32_t batch_size;
  int32_t page_size;
  int32_t max_pages_per_seq;
  std::vector<int32_t> free_pages;  // stack; page 0 reserved as sink
  std::vector<Seq> slots;

  int32_t pages_for(int32_t tokens) const {
    return (tokens + page_size - 1) / page_size;
  }
};

}  // namespace

extern "C" {

// Create a scheduler: n_pages includes the reserved sink page 0.
void* atom_sched_create(int32_t batch_size, int32_t n_pages,
                        int32_t page_size, int32_t max_pages_per_seq) {
  auto* s = new Scheduler();
  s->batch_size = batch_size;
  s->page_size = page_size;
  s->max_pages_per_seq = max_pages_per_seq;
  s->slots.resize(batch_size);
  s->free_pages.reserve(n_pages - 1);
  for (int32_t p = n_pages - 1; p >= 1; --p) s->free_pages.push_back(p);
  for (auto& slot : s->slots) slot.pages.reserve(max_pages_per_seq);
  return s;
}

void atom_sched_destroy(void* h) { delete static_cast<Scheduler*>(h); }

int32_t atom_sched_free_pages(void* h) {
  return static_cast<int32_t>(static_cast<Scheduler*>(h)->free_pages.size());
}

// Admit a request into a free slot.  Allocates pages for the prompt.
// Returns the slot index, or -1 (no slot) / -2 (not enough pages) /
// -3 (prompt + output would exceed max_pages_per_seq — the table-row
// buffers are sized to max_pages_per_seq, so admitting would overflow
// them later).
int32_t atom_sched_admit(void* h, int32_t request_id, int32_t prompt_len,
                         int32_t output_len) {
  auto* s = static_cast<Scheduler*>(h);
  int32_t slot = -1;
  for (int32_t i = 0; i < s->batch_size; ++i) {
    if (s->slots[i].request_id < 0) { slot = i; break; }
  }
  if (slot < 0) return -1;
  // Permanent unservability (-3) is checked before transient pool pressure
  // (-2): a request that can never fit max_pages_per_seq must fail fast and
  // deterministically, not masquerade as "pool busy" while pages are scarce.
  if (s->pages_for(prompt_len + output_len) > s->max_pages_per_seq) return -3;
  const int32_t need = s->pages_for(prompt_len);
  if (need > static_cast<int32_t>(s->free_pages.size())) return -2;
  Seq& q = s->slots[slot];
  q.request_id = request_id;
  q.remaining = output_len;
  q.seqlen = prompt_len;
  q.held = false;
  q.pages.clear();
  for (int32_t i = 0; i < need; ++i) {
    q.pages.push_back(s->free_pages.back());
    s->free_pages.pop_back();
  }
  return slot;
}

// Admit into a HELD slot: pages allocated, but the sequence does not decode
// until atom_sched_activate — used while a chunked prefill streams the
// prompt through mixed steps.
int32_t atom_sched_admit_hold(void* h, int32_t request_id, int32_t prompt_len,
                              int32_t output_len) {
  const int32_t slot = atom_sched_admit(h, request_id, prompt_len, output_len);
  if (slot >= 0) static_cast<Scheduler*>(h)->slots[slot].held = true;
  return slot;
}

// Start decoding a held slot with ``remaining`` tokens still to produce
// (the prefill itself already emitted the first token).
void atom_sched_activate(void* h, int32_t slot, int32_t remaining) {
  Seq& q = static_cast<Scheduler*>(h)->slots[slot];
  q.held = false;
  q.remaining = remaining;
}

// Free a slot and its pages immediately (cancelled / single-token outputs).
void atom_sched_release(void* h, int32_t slot) {
  auto* s = static_cast<Scheduler*>(h);
  Seq& q = s->slots[slot];
  if (q.request_id < 0) return;
  for (int32_t p : q.pages) s->free_pages.push_back(p);
  q.pages.clear();
  q.request_id = -1;
  q.seqlen = 0;
  q.held = false;
}

// Fill this slot's page-table row (padded with 0) — for the prefill call.
void atom_sched_table_row(void* h, int32_t slot, int32_t* row_out) {
  auto* s = static_cast<Scheduler*>(h);
  const Seq& q = s->slots[slot];
  std::memset(row_out, 0, sizeof(int32_t) * s->max_pages_per_seq);
  std::memcpy(row_out, q.pages.data(), sizeof(int32_t) * q.pages.size());
}

// One decode step over the whole workset: extends every active sequence by
// one token (allocating pages on boundary crossings), writes the batch page
// table [batch, max_pages] and seq_lens [batch] into the caller's buffers,
// and retires sequences whose output is complete (freeing their pages).
//
// finished_out receives the request ids retired THIS step; returns their
// count.  Returns -2 if the pool ran out of pages (state unchanged for the
// failing slot; caller should drain or grow the pool).
int32_t atom_sched_decode_step(void* h, int32_t* table_out, int32_t* lens_out,
                               int32_t* finished_out) {
  auto* s = static_cast<Scheduler*>(h);
  const int32_t mp = s->max_pages_per_seq;
  int32_t n_finished = 0;
  // pass 1: extend
  for (int32_t i = 0; i < s->batch_size; ++i) {
    Seq& q = s->slots[i];
    if (q.request_id < 0 || q.held) continue;
    q.seqlen += 1;
    if (q.seqlen > static_cast<int32_t>(q.pages.size()) * s->page_size) {
      if (s->free_pages.empty()) return -2;
      // Never outgrow the caller's [batch, max_pages_per_seq] buffers
      // (atom_sched_admit bounds prompt+output, so this only trips on
      // misuse; -3 instead of silent memory corruption).
      if (static_cast<int32_t>(q.pages.size()) >= s->max_pages_per_seq)
        return -3;
      q.pages.push_back(s->free_pages.back());
      s->free_pages.pop_back();
    }
  }
  // pass 2: emit table + lens
  std::memset(table_out, 0, sizeof(int32_t) * s->batch_size * mp);
  for (int32_t i = 0; i < s->batch_size; ++i) {
    const Seq& q = s->slots[i];
    lens_out[i] = (q.request_id < 0 || q.held) ? 0 : q.seqlen;
    if (q.request_id < 0 || q.held) continue;
    std::memcpy(table_out + i * mp, q.pages.data(),
                sizeof(int32_t) * q.pages.size());
  }
  // pass 3: retire
  for (int32_t i = 0; i < s->batch_size; ++i) {
    Seq& q = s->slots[i];
    if (q.request_id < 0 || q.held) continue;
    if (--q.remaining <= 0) {
      finished_out[n_finished++] = q.request_id;
      for (int32_t p : q.pages) s->free_pages.push_back(p);
      q.pages.clear();
      q.request_id = -1;
      q.seqlen = 0;
    }
  }
  return n_finished;
}

int32_t atom_sched_active(void* h) {
  auto* s = static_cast<Scheduler*>(h);
  int32_t n = 0;
  for (const auto& q : s->slots) n += (q.request_id >= 0);
  return n;
}

int32_t atom_sched_seqlen(void* h, int32_t slot) {
  return static_cast<Scheduler*>(h)->slots[slot].seqlen;
}

}  // extern "C"
