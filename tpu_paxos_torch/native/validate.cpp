// Native host-side fast paths for tpu_paxos_torch (C ABI, consumed via
// ctypes).  A copy of the JAX package's tpu_paxos/native/validate.cpp.
//
// The reference is 100% native C++ (SURVEY.md: 5,814 LoC, g++,
// -pthread); its harness both validates and prints the committed log
// in-process (ref multi/main.cpp:567-573, multi/paxos.cpp:1694-1703).
// In this framework the card does the protocol work, but the
// whole-run validation and decision-log rendering are host-side and
// become the bottleneck at 10^7..10^8 instances; these single-pass
// C++ loops replace multi-pass numpy scans.  harness/validate.py
// routes large arrays through them; the numpy versions stay as the
// plain versions the tests hold these against.
//
// Build: g++ -O2 -shared -fPIC -o libtpupaxos_torch.so validate.cpp
// (done on demand by tpu_paxos_torch/native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {
constexpr int32_t kNone = -1;
constexpr int32_t kNoopBase = -2;  // vids <= this are no-ops
}  // namespace

extern "C" {

// Agreement: no two nodes learned different values for one instance
// (ref multi/main.cpp:567-570).  learned is [I, A] row-major.
// Returns 0 and leaves *bad untouched when consistent; returns 1 and
// writes the first violating instance otherwise.
int tp_check_agreement(const int32_t* learned, int64_t n_instances,
                       int64_t n_nodes, int64_t* bad) {
  for (int64_t i = 0; i < n_instances; ++i) {
    const int32_t* row = learned + i * n_nodes;
    int32_t seen = kNone;
    for (int64_t a = 0; a < n_nodes; ++a) {
      const int32_t v = row[a];
      if (v == kNone) continue;
      if (seen == kNone) {
        seen = v;
      } else if (v != seen) {
        *bad = i;
        return 1;
      }
    }
  }
  return 0;
}

// Per-instance chosen value: the value any knowing node learned
// (callers run tp_check_agreement first, so knowers agree).
void tp_chosen_per_instance(const int32_t* learned, int64_t n_instances,
                            int64_t n_nodes, int32_t* out) {
  for (int64_t i = 0; i < n_instances; ++i) {
    const int32_t* row = learned + i * n_nodes;
    int32_t seen = kNone;
    for (int64_t a = 0; a < n_nodes; ++a) {
      if (row[a] != kNone) {
        seen = row[a];
        break;
      }
    }
    out[i] = seen;
  }
}

// Exactly-once: no real (vid >= 0) value appears at two instances.
// chosen is [I].  Returns 0 when clean; 1 and the duplicated vid via
// *dup_vid otherwise.  Uses a bitset over the dense vid space when
// max_vid is provided (>= 0), else a sorted vector.  A vid above
// max_vid returns 2 (bound too small) rather than being silently
// skipped — the caller retries without the bound.
int tp_check_unique(const int32_t* chosen, int64_t n_instances,
                    int64_t max_vid, int32_t* dup_vid) {
  if (max_vid >= 0) {
    std::vector<uint8_t> seen(static_cast<size_t>(max_vid) + 1, 0);
    for (int64_t i = 0; i < n_instances; ++i) {
      const int32_t v = chosen[i];
      if (v < 0) continue;  // NONE or no-op
      if (v > max_vid) {
        *dup_vid = v;
        return 2;
      }
      if (seen[v]) {
        *dup_vid = v;
        return 1;
      }
      seen[v] = 1;
    }
    return 0;
  }
  std::vector<int32_t> vals;
  vals.reserve(static_cast<size_t>(n_instances));
  for (int64_t i = 0; i < n_instances; ++i)
    if (chosen[i] >= 0) vals.push_back(chosen[i]);
  if (vals.empty()) return 0;
  std::sort(vals.begin(), vals.end());
  for (size_t k = 1; k < vals.size(); ++k)
    if (vals[k] == vals[k - 1]) {
      *dup_vid = vals[k];
      return 1;
    }
  return 0;
}

// Decision-log renderer in the reference's value grammar
// (ref multi/paxos.cpp:18-22):
//   no-op:  [i] = <ballot>(proposer:value-id)-
//   normal: [i] = <ballot>(proposer:value-id)+value-id
// Membership-change vids are host-rendered by the Python layer (they
// need the intern table); callers route logs containing them to the
// Python path.  Two modes: buf == nullptr sizes the output; otherwise
// writes up to cap bytes.  Returns the total byte length needed
// (excluding the NUL), or -1 if cap was insufficient.
int64_t tp_render_decision_log(const int32_t* chosen_vid,
                               const int32_t* chosen_ballot,
                               int64_t n_instances, int32_t stride,
                               int32_t noop_modulus, char* buf, int64_t cap) {
  int64_t total = 0;
  char line[96];
  for (int64_t i = 0; i < n_instances; ++i) {
    const int32_t v = chosen_vid[i];
    if (v == kNone) continue;
    const int32_t b = chosen_ballot[i];
    int len;
    if (v <= kNoopBase) {
      const int64_t k = static_cast<int64_t>(kNoopBase) - v;
      const int64_t proposer = k / noop_modulus;
      const int64_t inst = k % noop_modulus;
      len = std::snprintf(line, sizeof line, "[%lld] = <%d>(%lld:%lld)-\n",
                          static_cast<long long>(i), b,
                          static_cast<long long>(proposer),
                          static_cast<long long>(inst));
    } else {
      const int32_t proposer = v / stride;
      const int32_t seq = v % stride;
      len = std::snprintf(line, sizeof line, "[%lld] = <%d>(%d:%d)+%d\n",
                          static_cast<long long>(i), b, proposer, seq, seq);
    }
    if (buf != nullptr) {
      if (total + len > cap) return -1;
      std::memcpy(buf + total, line, static_cast<size_t>(len));
    }
    total += len;
  }
  return total;
}

}  // extern "C"
