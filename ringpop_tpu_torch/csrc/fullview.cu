// The exact full-view engine's change application for Hopper (sm_90a):
// kernel F1, one launch per batch of candidate changes.
//
// What it computes (ringpop_tpu_torch/ops/fullview_kernel.py:apply_plain
// has the plain version).  The cluster is seven [N, N] planes, view[i, j]
// = what node i believes of member j: status int8, incarnation int32,
// present, has_change (bool as one byte), pcount int32, pending int8 (the
// state a timer will move from, -1 none) and deadline int32.  A batch is
// one candidate key a cell, cand[i, j] = (incarnation << 3) | state, or -1
// for none, already max-merged.  Each cell with a candidate applies
// memberlist.Update's rules, in this order:
//   refutation   on the diagonal, a Suspect/Faulty/Tombstone claim at an
//                incarnation >= i's own, while present: i reasserts Alive
//                at now_ms;
//   override     otherwise the candidate wins by strict key order over the
//                present cell's key (an absent cell's is -1);
//   tombstone    a first-seen Tombstone is refused;
//   record       an applied change sets has_change and resets pcount;
//   timers       Alive or Leave cancels the pending timer; Suspect, Faulty
//                or Tombstone schedules one at tick + its timeout, unless
//                one for the same state is pending; never on the diagonal.
// A cell without a candidate does not change.  It replaces the ~25 XLA
// elementwise passes of ringpop_tpu/sim/fullview.py:_apply_batch (:171-241)
// that the engine runs five times a tick (request, response, reverse full
// sync, suspect, timers); there is no Pallas kernel there.
//
// What bounds it: bytes.  Every cell's candidate is read (4 bytes); a cell
// with one reads its key's status, incarnation and present (6 bytes), and
// its pending state (1 byte) where a detraction applies off the diagonal;
// an applied cell writes at most 16.  Design: a thread takes four cells' candidates in one 16-byte load
// (one int32 load a thread read the candidate plane at ~45 % of the memory
// rate at N = 4096) and returns where none has one; the planes are updated
// in place, a cell's state read only where it has a candidate and written
// only where a change applies; the diagonal is i == j (no eye plane is
// read); tick and now_ms are read on the card, so a launch adds no host
// sync.
//
// The entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCells = 4;  // cells a thread
constexpr int kAlive = 0, kSuspect = 1, kFaulty = 2, kLeave = 3, kTombstone = 4;

struct Planes {
  int8_t* status;
  int32_t* incarnation;
  uint8_t* present;
  uint8_t* has_change;
  int32_t* pcount;
  int8_t* pending;
  int32_t* deadline;
};

struct Timeouts {
  int32_t suspect, faulty, tombstone;
};

__device__ __forceinline__ bool is_detraction(int state) {
  return state == kSuspect || state == kFaulty || state == kTombstone;
}

// (incarnation << 3) | state in wrapping int32, as the JAX package's arrays
__device__ __forceinline__ int32_t pack_key(int32_t inc, int32_t state) {
  return static_cast<int32_t>((static_cast<uint32_t>(inc) << 3) | static_cast<uint32_t>(state));
}

// one cell with a candidate c >= 0
__device__ __forceinline__ void apply_cell(long long cell, int32_t c, const Planes& p, const int32_t* tick_p,
                                           const int32_t* now_p, long long n, const Timeouts& timeouts) {
  const int cand_state = static_cast<int8_t>(c & 7);
  const int32_t cand_inc = c >> 3;
  const long long i = cell / n;
  const bool diag = cell - i * n == i;
  const int status = p.status[cell];
  const int32_t inc = p.incarnation[cell];
  const bool present = p.present[cell];
  const int32_t local = present ? pack_key(inc, status) : -1;
  const bool refute = diag && is_detraction(cand_state) && cand_inc >= inc && present;
  bool wins = !refute && c > local;
  if (wins && !present && cand_state == kTombstone) wins = false;
  if (!wins && !refute) return;
  const int new_status = refute ? kAlive : cand_state;
  p.status[cell] = static_cast<int8_t>(new_status);
  p.incarnation[cell] = refute ? __ldg(now_p) : cand_inc;
  p.present[cell] = 1;
  p.has_change[cell] = 1;
  p.pcount[cell] = 0;
  if (new_status == kAlive || new_status == kLeave) {
    p.pending[cell] = -1;
  } else if (is_detraction(new_status) && !diag && p.pending[cell] != new_status) {
    p.pending[cell] = static_cast<int8_t>(new_status);
    const int32_t timeout = new_status == kSuspect  ? timeouts.suspect
                            : new_status == kFaulty ? timeouts.faulty
                                                    : timeouts.tombstone;
    p.deadline[cell] = static_cast<int32_t>(static_cast<uint32_t>(__ldg(tick_p)) + static_cast<uint32_t>(timeout));
  }
}

// a thread reads the candidates of kCells consecutive cells in one 16-byte
// load and returns at once where none has one, as most cells of a batch
__global__ void __launch_bounds__(kThreads)
fullview_apply_kernel(const int32_t* __restrict__ cand, Planes p, const int32_t* __restrict__ tick_p,
                      const int32_t* __restrict__ now_p, long long n, long long cells, Timeouts timeouts) {
  const long long first = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kCells;
  if (first >= cells) return;
  int32_t c[kCells];
  if (first + kCells <= cells) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(cand + first));
    c[0] = v.x;
    c[1] = v.y;
    c[2] = v.z;
    c[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < kCells; ++k) c[k] = first + k < cells ? cand[first + k] : -1;
  }
  if ((c[0] & c[1] & c[2] & c[3]) < 0) return;  // every sign bit set: no candidate
#pragma unroll
  for (int k = 0; k < kCells; ++k)
    if (c[k] >= 0) apply_cell(first + k, c[k], p, tick_p, now_p, n, timeouts);
}

}  // namespace

extern "C" {

// the seven planes [n, n], contiguous, in FullViewState's order; cand
// int32 [n, n], 16-byte aligned; tick and now_ms int32 scalars on the card
int rp_fullview_apply(const int32_t* cand, int8_t* status, int32_t* incarnation, uint8_t* present,
                      uint8_t* has_change, int32_t* pcount, int8_t* pending, int32_t* deadline,
                      const int32_t* tick, const int32_t* now_ms, long long n, int suspect_ticks,
                      int faulty_ticks, int tombstone_ticks, void* stream) {
  const long long cells = n * n;
  const Planes planes = {status, incarnation, present, has_change, pcount, pending, deadline};
  const Timeouts timeouts = {suspect_ticks, faulty_ticks, tombstone_ticks};
  const long long threads = (cells + kCells - 1) / kCells;
  const unsigned int blocks = static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  fullview_apply_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cand, planes, tick, now_ms, n, cells, timeouts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
