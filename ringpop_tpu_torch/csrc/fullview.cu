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
// an applied cell writes at most 16.  Design:
// - a thread takes a group of four consecutive cells, 4-aligned in the flat
//   plane: its candidates in one 16-byte load.  A group without a
//   candidate costs its load and a compare.  A thread is held to 32
//   registers (2048 / kThreads blocks an SM; ptxas spills 4 bytes), so the
//   N = 1000 plane's 977 blocks fit one wave: at the 36 ptxas takes
//   unbounded, an SM holds 7 blocks and they take two.  (A grid that
//   strode over the plane, two groups a thread, ran 13-43 % slower at
//   N = 4096: a thread's candidate round trips added up; PERF.md);
// - where a group has one, its state is read in one round trip: status,
//   present and pending as one 4-byte word each and incarnation as one
//   16-byte load (weak global loads: the kernel writes these planes), and
//   tick and now_ms beside them.  The rules run in registers on the packed
//   words, one cell unpacked at a time, with a bit a (plane, cell) for
//   what changed; only the words that change are written back (has_change,
//   pcount and deadline cell by cell, where they apply).  The thread owns
//   its four cells, so the read-modify-write is race-free;
// - the group's row is one 32-bit quotient by a reciprocal of N the host
//   computes (ops/threefry_kernel.py:reciprocal; Hopper has no integer
//   divide), its cells' columns follow by adding, and a group that
//   straddles two rows (N % 4 != 0) moves its later cells to the next row;
//   the diagonal is i == j (no eye plane is read).  So N * N < 2**32 (the
//   wrapper checks; 65535**2 cells would be 68 GB of planes);
// - the plane's last group, where N * N % 4 != 0, is read and written cell
//   by cell.
// tick and now_ms are read on the card, so a launch adds no host sync.
// The wrapper checks the planes' alignment: 16 bytes for the int32 planes
// and the candidates, 4 for the byte planes.
//
// The entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2048 / kThreads;  // blocks an SM must hold at once: caps a thread's registers at 32
constexpr int kCells = 4;                    // cells a group
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

// a / n for uint32 a: the high word of a * magic, with the 33rd bit of
// the magic added back halved where add is set (reciprocal's convention)
struct Divisor {
  uint32_t n, magic, add, shift1, shift2;
};

__device__ __forceinline__ uint32_t quotient(uint32_t a, const Divisor& d) {
  uint32_t q = __umulhi(d.magic, a);
  if (d.add) q += (a - q) >> d.shift1;
  return q >> d.shift2;
}

__device__ __forceinline__ bool is_detraction(int state) {
  return state == kSuspect || state == kFaulty || state == kTombstone;
}

// (incarnation << 3) | state in wrapping int32, as the JAX package's arrays
__device__ __forceinline__ int32_t pack_key(int32_t inc, int32_t state) {
  return static_cast<int32_t>((static_cast<uint32_t>(inc) << 3) | static_cast<uint32_t>(state));
}

// one cell's state, in registers
struct Cell {
  int status, pending;
  int32_t incarnation;
  bool present;
};

// memberlist.Update's rules for a cell with a candidate c >= 0, applied to
// its state in registers; returns whether a change applied, and sets
// schedule where a timer is scheduled (its deadline is then written)
__device__ __forceinline__ bool apply_rules(int32_t c, bool diag, Cell& cell, bool& schedule, int32_t now) {
  const int cand_state = static_cast<int8_t>(c & 7);
  const int32_t cand_inc = c >> 3;
  const int32_t local = cell.present ? pack_key(cell.incarnation, cell.status) : -1;
  const bool refute = diag && is_detraction(cand_state) && cand_inc >= cell.incarnation && cell.present;
  bool wins = !refute && c > local;
  if (wins && !cell.present && cand_state == kTombstone) wins = false;
  schedule = false;
  if (!wins && !refute) return false;
  cell.status = refute ? kAlive : cand_state;
  cell.incarnation = refute ? now : cand_inc;
  cell.present = true;
  if (cell.status == kAlive || cell.status == kLeave) {
    cell.pending = -1;
  } else if (is_detraction(cell.status) && !diag && cell.pending != cell.status) {
    cell.pending = cell.status;
    schedule = true;
  }
  return true;
}

__device__ __forceinline__ int32_t deadline_of(int status, int32_t tick, const Timeouts& t) {
  const int32_t timeout = status == kSuspect ? t.suspect : status == kFaulty ? t.faulty : t.tombstone;
  return static_cast<int32_t>(static_cast<uint32_t>(tick) + static_cast<uint32_t>(timeout));
}

__device__ __forceinline__ int byte_of(uint32_t word, int k) { return static_cast<int8_t>(word >> (8 * k)); }

__device__ __forceinline__ uint32_t with_byte(uint32_t word, int k, int value) {
  return (word & ~(0xFFu << (8 * k))) | (static_cast<uint32_t>(value & 0xFF) << (8 * k));
}

// Weak global loads and stores of the planes: the planes are written by
// the kernel, so not through the read-only path, and a thread reads each
// of its cells before it writes it.
__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  uint32_t v;
  asm("ld.global.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ int4 ld_v4(const int32_t* p) {
  int4 v;
  asm("ld.global.v4.s32 {%0, %1, %2, %3}, [%4];" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ int ld_s8(const void* p) {
  int v;
  asm("ld.global.s8 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ int32_t ld_s32(const int32_t* p) {
  int32_t v;
  asm("ld.global.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void st_u32(void* p, uint32_t v) {
  asm volatile("st.global.u32 [%0], %1;" : : "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void st_v4(int32_t* p, const int32_t (&v)[4]) {
  asm volatile("st.global.v4.s32 [%0], {%1, %2, %3, %4};" : : "l"(p), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

__device__ __forceinline__ void st_u8(void* p, int v) {
  asm volatile("st.global.u8 [%0], %1;" : : "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void st_s32(int32_t* p, int32_t v) {
  asm volatile("st.global.s32 [%0], %1;" : : "l"(p), "r"(v) : "memory");
}

// the group of cells [first, first + 4) with candidates c4 (-1 none), at
// least one >= 0.  kWhole: all four lie in the plane, read and written as
// words; else the plane's last group, cell by cell.  The state stays packed
// in its words, one cell unpacked at a time, and a bit a (plane, cell)
// records what changed, so few registers stay live.
template <bool kWhole>
__device__ __forceinline__ void apply_group(uint32_t first, int4 c4, const Planes& p, const Divisor& n,
                                            const int32_t* tick_p, const int32_t* now_p, const Timeouts& timeouts) {
  const int32_t c[kCells] = {c4.x, c4.y, c4.z, c4.w};
  const int32_t tick = __ldg(tick_p), now = __ldg(now_p);  // loaded with the state, by a thread with a candidate
  uint32_t status_w = 0, present_w = 0, pending_w = 0;
  int32_t inc[kCells] = {0, 0, 0, 0};
  if (kWhole) {
    status_w = ld_u32(p.status + first);
    present_w = ld_u32(p.present + first);
    pending_w = ld_u32(p.pending + first);
    const int4 v = ld_v4(p.incarnation + first);
    inc[0] = v.x;
    inc[1] = v.y;
    inc[2] = v.z;
    inc[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      if (c[k] < 0) continue;  // and every cell past the plane
      status_w = with_byte(status_w, k, ld_s8(p.status + first + k));
      present_w = with_byte(present_w, k, ld_s8(p.present + first + k));
      pending_w = with_byte(pending_w, k, ld_s8(p.pending + first + k));
      inc[k] = ld_s32(p.incarnation + first + k);
    }
  }
  const uint32_t i0 = quotient(first, n), j0 = first - i0 * n.n;
  // bits 0-3 a cell applied, 4-7 its timer scheduled, 8-11 its status,
  // 12-15 its present, 16-19 its pending, 20-23 its incarnation changed
  uint32_t changed = 0;
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    if (c[k] < 0) continue;
    // a group straddles at most one row end (a plane of N = 1 has one cell)
    uint32_t i = i0, j = j0 + k;
    if (j >= n.n) {
      j -= n.n;
      ++i;
    }
    Cell cell = {byte_of(status_w, k), byte_of(pending_w, k), inc[k], byte_of(present_w, k) != 0};
    bool sched;
    if (!apply_rules(c[k], i == j, cell, sched, now)) continue;
    const uint32_t bits = 1u | static_cast<uint32_t>(sched) << 4 |
                          static_cast<uint32_t>(cell.status != byte_of(status_w, k)) << 8 |
                          static_cast<uint32_t>(byte_of(present_w, k) == 0) << 12 |
                          static_cast<uint32_t>(cell.pending != byte_of(pending_w, k)) << 16 |
                          static_cast<uint32_t>(cell.incarnation != inc[k]) << 20;
    changed |= bits << k;
    status_w = with_byte(status_w, k, cell.status);
    present_w = with_byte(present_w, k, 1);
    pending_w = with_byte(pending_w, k, cell.pending);
    inc[k] = cell.incarnation;
  }
  if (!changed) return;
  if (kWhole) {
    if (changed & 0xF00u) st_u32(p.status + first, status_w);
    if (changed & 0xF000u) st_u32(p.present + first, present_w);
    if (changed & 0xF0000u) st_u32(p.pending + first, pending_w);
    if (changed & 0xF00000u) st_v4(p.incarnation + first, inc);
  }
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    if (!(changed >> k & 1u)) continue;
    const uint32_t at = first + k;
    if (!kWhole) {
      st_u8(p.status + at, byte_of(status_w, k));
      st_s32(p.incarnation + at, inc[k]);
      st_u8(p.present + at, 1);
      st_u8(p.pending + at, byte_of(pending_w, k));
    }
    st_u8(p.has_change + at, 1);
    st_s32(p.pcount + at, 0);
    if (changed >> (4 + k) & 1u) st_s32(p.deadline + at, deadline_of(byte_of(status_w, k), tick, timeouts));
  }
}

// a thread loads the candidates of its group of four cells in one 16-byte
// load and returns at once where none has one, as most groups of a batch.
// (Returning first where the group lies past the plane, and keeping
// whether it is whole, ran the legs with candidates 3-4 % slower at
// N = 4096: the registers the group's path gets differ; PERF.md.)
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fullview_apply_kernel(const int32_t* __restrict__ cand, Planes p, const int32_t* __restrict__ tick_p,
                      const int32_t* __restrict__ now_p, Divisor n, uint32_t cells, Timeouts timeouts) {
  // cells < 2**32 and the grid's last group ends fewer than 4 * kThreads
  // cells past them, so first does not wrap
  const uint32_t groups = cells / kCells + (cells % kCells != 0);
  const uint32_t g = blockIdx.x * kThreads + threadIdx.x, first = g * kCells;
  int4 c;
  if (g < groups && first + kCells <= cells) {
    c = __ldg(reinterpret_cast<const int4*>(cand + first));
  } else {
    int32_t v[kCells];
#pragma unroll
    for (int k = 0; k < kCells; ++k) v[k] = g < groups && first + k < cells ? __ldg(cand + first + k) : -1;
    c = make_int4(v[0], v[1], v[2], v[3]);
  }
  if ((c.x & c.y & c.z & c.w) < 0) return;  // every sign bit set: no candidate
  if (first + kCells <= cells) {
    apply_group<true>(first, c, p, n, tick_p, now_p, timeouts);
  } else {
    apply_group<false>(first, c, p, n, tick_p, now_p, timeouts);
  }
}

}  // namespace

extern "C" {

// the seven planes [n, n], contiguous, in FullViewState's order (int32
// planes 16-byte aligned, byte planes 4-byte aligned); cand int32 [n, n],
// 16-byte aligned; tick and now_ms int32 scalars on the card; 1 <= n and
// n * n < 2**32; magic, add, shift1, shift2: n's reciprocal
// (ops/threefry_kernel.py:reciprocal)
int rp_fullview_apply(const int32_t* cand, int8_t* status, int32_t* incarnation, uint8_t* present,
                      uint8_t* has_change, int32_t* pcount, int8_t* pending, int32_t* deadline,
                      const int32_t* tick, const int32_t* now_ms, long long n, unsigned int magic, int add,
                      int shift1, int shift2, int suspect_ticks, int faulty_ticks, int tombstone_ticks,
                      void* stream) {
  const uint32_t cells = static_cast<uint32_t>(n * n);
  const Planes planes = {status, incarnation, present, has_change, pcount, pending, deadline};
  const Divisor divisor = {static_cast<uint32_t>(n), magic, static_cast<uint32_t>(add != 0),
                           static_cast<uint32_t>(shift1), static_cast<uint32_t>(shift2)};
  const Timeouts timeouts = {suspect_ticks, faulty_ticks, tombstone_ticks};
  const long long groups = (static_cast<long long>(cells) + kCells - 1) / kCells;
  const unsigned int blocks = static_cast<unsigned int>((groups + kThreads - 1) / kThreads);
  fullview_apply_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cand, planes, tick, now_ms, divisor, cells, timeouts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
