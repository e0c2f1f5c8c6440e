// Continuous-batching scheduler — native serving runtime of aimet_tpu_torch.
//
// Host-side slot/admission/termination logic for the serving engine
// (serving/batcher.py delegates its bookkeeping here with use_native=True).
// The compute path stays in PyTorch and the CUDA kernels; this is the C++
// runtime component (admission queue, per-request state machine, slot
// lifecycle) that runs on the host between decode chunks. Built with g++
// at first use by aimet_tpu_torch/native/__init__.py.
//
// State machine per request: QUEUED -> ACTIVE(slot) -> DONE.
// Termination: generated >= max_new_tokens, token == eos_id, or the
// slot's cache position reaching max_len - 1.

#include <cstdint>
#include <deque>
#include <unordered_map>
#include <vector>

namespace {

struct Request {
  int64_t uid;
  int prompt_len;
  int max_new_tokens;
  int eos_id;        // -1 = none
  int generated = 0;
  bool done = false;
};

struct Scheduler {
  int num_slots;
  int max_len;
  int64_t next_uid = 0;
  std::deque<int64_t> pending;
  std::unordered_map<int64_t, Request> requests;
  std::vector<int64_t> slot_req;   // uid or -1
  std::vector<int> position;       // cache write position per slot
  std::vector<int> last_token;     // next decode input per slot

  Scheduler(int slots, int maxlen)
      : num_slots(slots), max_len(maxlen),
        slot_req(slots, -1), position(slots, 0), last_token(slots, 0) {}

  bool finished(const Request& r, int slot) const {
    return r.generated >= r.max_new_tokens ||
           (r.eos_id >= 0 && r.generated > 0 &&
            last_token[slot] == r.eos_id) ||
           position[slot] >= max_len - 1;
  }

  int maybe_finish(int slot) {
    int64_t uid = slot_req[slot];
    if (uid < 0) return 0;
    Request& r = requests[uid];
    if (finished(r, slot)) {
      r.done = true;
      slot_req[slot] = -1;
      return 1;
    }
    return 0;
  }
};

}  // namespace

extern "C" {

void* cb_create(int num_slots, int max_len) {
  return new Scheduler(num_slots, max_len);
}

void cb_destroy(void* s) { delete static_cast<Scheduler*>(s); }

int64_t cb_submit(void* sv, int prompt_len, int max_new_tokens, int eos_id) {
  auto* s = static_cast<Scheduler*>(sv);
  int64_t uid = s->next_uid++;
  s->requests[uid] = Request{uid, prompt_len, max_new_tokens, eos_id};
  s->pending.push_back(uid);
  return uid;
}

// Pop one pending request into a free slot; returns the slot (caller
// prefills it) or -1 when no work or no free slot.
int cb_admit(void* sv, int64_t* uid_out) {
  auto* s = static_cast<Scheduler*>(sv);
  if (s->pending.empty()) return -1;
  for (int slot = 0; slot < s->num_slots; ++slot) {
    if (s->slot_req[slot] < 0) {
      int64_t uid = s->pending.front();
      s->pending.pop_front();
      s->slot_req[slot] = uid;
      s->position[slot] = 0;
      if (uid_out) *uid_out = uid;
      return slot;
    }
  }
  return -1;
}

// After prefill: set the cache position and record the first generated
// token. Returns 1 if the request finished immediately (slot freed).
int cb_start(void* sv, int slot, int first_token) {
  auto* s = static_cast<Scheduler*>(sv);
  int64_t uid = s->slot_req[slot];
  if (uid < 0) return -1;
  Request& r = s->requests[uid];
  s->position[slot] = r.prompt_len;
  s->last_token[slot] = first_token;
  r.generated = 1;
  return s->maybe_finish(slot);
}

// Record one decode-step token. Returns 1 if the request finished.
int cb_record(void* sv, int slot, int token) {
  auto* s = static_cast<Scheduler*>(sv);
  int64_t uid = s->slot_req[slot];
  if (uid < 0) return -1;
  Request& r = s->requests[uid];
  s->last_token[slot] = token;
  s->position[slot] += 1;
  r.generated += 1;
  return s->maybe_finish(slot);
}

int cb_active(void* sv) {
  auto* s = static_cast<Scheduler*>(sv);
  int n = 0;
  for (int64_t u : s->slot_req) n += (u >= 0);
  return n;
}

int cb_pending(void* sv) {
  return static_cast<int>(static_cast<Scheduler*>(sv)->pending.size());
}

// Writes active slot ids into out; returns the count.
int cb_active_slots(void* sv, int* out) {
  auto* s = static_cast<Scheduler*>(sv);
  int n = 0;
  for (int slot = 0; slot < s->num_slots; ++slot)
    if (s->slot_req[slot] >= 0) out[n++] = slot;
  return n;
}

// Per-slot decode feed: last token and position arrays (full slot range;
// inactive slots keep stale values, masked by cb_active_slots).
void cb_decode_state(void* sv, int* tokens_out, int* pos_out) {
  auto* s = static_cast<Scheduler*>(sv);
  for (int slot = 0; slot < s->num_slots; ++slot) {
    tokens_out[slot] = s->last_token[slot];
    pos_out[slot] = s->position[slot];
  }
}

int cb_request_done(void* sv, int64_t uid) {
  auto* s = static_cast<Scheduler*>(sv);
  auto it = s->requests.find(uid);
  return it == s->requests.end() ? -1 : (it->second.done ? 1 : 0);
}

int cb_request_generated(void* sv, int64_t uid) {
  auto* s = static_cast<Scheduler*>(sv);
  auto it = s->requests.find(uid);
  return it == s->requests.end() ? -1 : it->second.generated;
}

// Drop a finished request's record (long-running servers must evict or the
// registry grows unboundedly). Returns 1 on success, 0 if absent or still
// active.
int cb_evict(void* sv, int64_t uid) {
  auto* s = static_cast<Scheduler*>(sv);
  auto it = s->requests.find(uid);
  if (it == s->requests.end() || !it->second.done) return 0;
  s->requests.erase(it);
  return 1;
}

}  // extern "C"
