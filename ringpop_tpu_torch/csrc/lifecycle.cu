// Kernels of the lifecycle engine for Hopper (sm_90a): the subject-slot walk
// (L1) and the per-slot first live learner (L2).
//
// What they compute.  The engine keeps K rumor slots (subject, key) and a
// packed plane learned[N, W] (uint32 words, slot j = word j >> 5, bit
// j & 31; sim/packbits.py) of which node has absorbed which slot.
//
//   L1 rp_slot_walk: walk the K slots sorted by (subject asc, key desc) —
//     the sort stays in the wrapper — and, per node i and per subject s
//     that holds a slot, take i's governing key m = max(key of the first
//     slot of s that i learned, base_key[s]), or base_key[s] when i learned
//     none.  Checksum mode: out[i] = wrapping uint32 sum over those s of
//     member_term(s, m) = fmix32(fmix32(s) ^ m), zero when m < 0 or m is a
//     tombstone key; written as int64[N].  Detect mode: anybad[s] = 1 iff
//     some observer i (obs[i]) has m >= 0 and status(m) < min_status;
//     anybad is bool[N] by subject id, pre-zeroed by the wrapper, and
//     stays 0 for subjects without a slot.  The plane may be a block of
//     R of the N rows (a node rank's block under a mesh): its rows are the
//     nodes walked, while subjects and base_key stay global.
//     int32[R, W] + int32[K] order/subject/key + int32[N] base_key
//     (+ bool[R] obs) -> int64[R] or bool[N].
//   L2 rp_first_live_learner: out[j] = min row r with bit j of learned[r]
//     set and rows[r] (bool[N], or every row when null), for the slots j
//     that want[j] names (bool[K], or every slot when null); 0 for the
//     other slots and where no live row learned j (jnp.argmax of an
//     all-false column).  int32[K].
//
// They replace no Pallas kernel: the JAX package leaves both to XLA
// (ringpop_tpu/sim/lifecycle.py: _walk_subject_slots :1363, a fori_loop of
// K dependent steps over [N] columns under detection_complete :1291 and
// view_checksums :1435; _first_live_learner :755, an argmax over the
// unpacked [N, K] plane under a lax.cond on (fire_s | fire_f).any()).
// Torch has no one-launch form of either.
//
// What bounds them.  L1: bytes, once a node costs a few word operations
// a word; at the headline's N = 1,000,000, K = 256 (W = 8) it reads the
// 32 MB plane and writes 8 MB of int64 checksums (checksum mode), or reads
// the plane and 1 MB of observer mask (detect mode): ~12 and ~10 us at
// 3.35 TB/s.  A walk of K dependent steps per node (the first design: one
// thread per node looping over the sorted slots in shared memory, ~20
// instructions a step) is ~5e9 lane-operations on a full table and bound by
// issue and latency instead: 335-411 us.  L2: bytes, and the bytes it needs
// depend on the data — the rows up to the largest answer among the wanted
// slots; none when no slot is wanted (the tick's common case).  A dense
// plane needs a few KB, so there the latency of a launch, a chunk and the
// last block's pass bounds it instead.
//
// Design.
//   L1 splits the walk by the shape of the runs in the sorted order.  Each
//   block builds, once, in shared memory, from the K-entry sorted table:
//   * for subjects that hold one slot (nearly all at the headline: 1000
//     victims over 256 slots) a node's contribution is `bit ? term_j :
//     base_j` — in checksum mode the constant sum C of their base terms plus
//     a per-nibble table tab[q][v] = sum over the set bits b of v of
//     (term - base) of slot 4q + b (8 nibbles a word x 16 values, 4 KB at
//     W = 8); a node adds 8 table reads a word.  Sixteen entries a nibble
//     sit in 16 banks, so a warp's reads never conflict (a byte table
//     would, ~3.5-way on random bytes, and is 8x larger).  In detect mode
//     two masks a word, bad-if-learned T and bad-if-not B (zero outside
//     single-slot subjects): a node's bad bits are (row & T) | (~row & B),
//     OR-reduced over the warp (__reduce_or_sync) into shared words and
//     mapped back to subjects at the end;
//   * subjects with several slots (a suspect and a faulty rumor of one
//     victim in flight together, ...) go into a list in sorted order, which
//     every node walks with the first-learned rule, reading the words it
//     needs through L1 (the row was just read); detect mode ORs a warp vote
//     per run into a shared flag.  The list is short on the main path.
//   Rows are read straight into registers, 16-byte loads where the width and
//   base allow, consecutive threads on consecutive rows, one node a thread,
//   a grid-stride loop over tiles of 256 nodes.  A block whose table holds
//   no valid slot reads no row.  Checksum sums are uint32 (wrapping, as
//   JAX's uint32 does; addition is associative, so the regrouping is
//   bit-equal).  Every detect store writes the same 1, so the result does
//   not depend on block order.
//   L2 reads rows in ascending chunks and stops as soon as no wanted slot
//   can still be lowered.  Each block first scans its own chunk of kOwnRows
//   rows (block b: rows [32b, 32b + 32)), then takes chunks of kChunkRows
//   from a ticket counter, in row order, the next ticket fetched while the
//   current chunk is scanned (at most kLearnerBlocksPerSm blocks a SM).
//   After each chunk it merges its finds into best[j] (global atomicMin, a
//   128-byte line a slot so hundreds of blocks do not queue on a few lines)
//   and keeps a wanted slot only while best[j] is above the next chunk's
//   first row; with none left it stops.  best only falls and holds real
//   learners, so the result is the same minimum whatever order blocks run
//   in, and a ticket a block abandons cannot lower any best.  Inside a chunk
//   each warp takes groups of 32 consecutive rows with every load (the words
//   and the up bytes) in flight before any is used; a word's 32 x 32 bits
//   are transposed across the warp (five shuffle rounds), so lane i finds
//   bit i's first row with one __ffs and records it in the warp's own
//   first-row table with a plain store, once (a per-warp seen mask).  The
//   block takes the least over its warps.  A shared atomicMin a bit instead
//   cost a dense 32-row chunk several times the rest of the scan, and
//   256-row first chunks would cost 8 warps that each (PERF.md).  The last
//   block to finish (a done counter) writes out[] (INT_MAX -> 0) and
//   restores best[] to INT_MAX and the counters to 0 for the next launch: a
//   scratch buffer the wrapper keeps per device and stream.  A block with no
//   wanted slot exits after reading K bytes: the tick's common case, a
//   launch's cost.  One launch a call, no host sync.
//
// Width.  Both kernels keep per-word tables in shared memory: L1's nibble
// tables (checksum mode) and multi-slot list, ~4 KB a plane word at K = 32W;
// L2's per-warp first-row tables, ~1 KB a plane word.  So a plane of at most
// 219 words (K <= 7008) fits one Hopper block's 227 KB in both; wider planes
// are refused (rp_*_smem give each kernel's bytes; the wrapper keeps the
// limit, ops/lifecycle_kernel.MAX_WORDS).
//
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kTombstone = 4;
constexpr int kStateMask = 7;         // KEY_STATE_BITS = 3
constexpr uint32_t kRunLast = 1u << 31;  // a multi-slot list entry that closes its subject
constexpr int kNibbles = 8;           // nibbles a word
constexpr int kRowsPerThread = 4;     // row groups a thread has in flight in L2's scan
constexpr int kLine = 32;             // ints a 128-byte line
constexpr int kBestAt = 2 * kLine;    // L2's best rows in its scratch
constexpr int kOwnRows = 32;          // rows of each L2 block's own first chunk (one warp's)
constexpr int kChunkRows = 1024;      // rows of each later L2 chunk (a multiple of 32)
constexpr int kLearnerBlocksPerSm = 4;
constexpr int kWalkBlocksPerSm = 8;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The view checksum's contribution of (subject, governing key).
__device__ __forceinline__ uint32_t member_term(int subject, int key) {
  if (key < 0 || (key & kStateMask) == kTombstone) return 0u;
  return fmix32(fmix32((uint32_t)subject) ^ (uint32_t)key);
}

__device__ __forceinline__ uint32_t is_bad(int key, int min_status) {
  return (key >= 0 && (key & kStateMask) < min_status) ? 1u : 0u;
}

template <int VEC>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

// L1's shared memory, in uint32 words.  hdr: the checksum constant C.
// mask_t/mask_b: detect's T and B masks.  bad: detect's per-block bad bits
// (none of the three in checksum mode).
// per_slot: checksum's term - base, detect's subject, by slot id.  nib: the
// nibble tables (checksum).  The multi-slot list: slot | kRunLast, term
// (or bad-if-learned), base (or bad-if-not), and in detect mode a flag and
// the subject.
struct WalkLayout {
  int hdr, mask_t, mask_b, bad, per_slot, nib, mslot, mterm, mbase, mflag, msubj, total;
};

__host__ __device__ inline WalkLayout walk_layout(int w, int k, int mode) {
  WalkLayout L;
  int o = 0;
  L.hdr = o; o += 1;
  L.mask_t = o; if (mode == 1) o += w;
  L.mask_b = o; if (mode == 1) o += w;
  L.bad = o; if (mode == 1) o += w;
  L.per_slot = o; o += 32 * w;
  L.nib = o; if (mode == 0) o += 16 * kNibbles * w;
  L.mslot = o; o += k;
  L.mterm = o; o += k;
  L.mbase = o; o += k;
  L.mflag = o; if (mode == 1) o += k;
  L.msubj = o; if (mode == 1) o += k;
  L.total = o;
  return L;
}

// MODE: 0 = checksum, 1 = detect.  VEC: words a row load.
template <int MODE, int VEC>
__global__ void __launch_bounds__(kThreads)
lifecycle_slot_walk(const uint32_t* __restrict__ learned, int rows, int n, int w, int k,
                    const int* __restrict__ order, const int* __restrict__ sorted_subj,
                    const int* __restrict__ sorted_key, const int* __restrict__ base_key,
                    const uint8_t* __restrict__ obs, int min_status,
                    unsigned long long* __restrict__ sums, uint8_t* __restrict__ anybad) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t s_warp[kWarps];
  const WalkLayout L = walk_layout(w, k, MODE);
  uint32_t* hdr = smem + L.hdr;
  uint32_t* s_t = smem + L.mask_t;
  uint32_t* s_b = smem + L.mask_b;
  uint32_t* s_bad = smem + L.bad;
  uint32_t* s_slot = smem + L.per_slot;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int e = tid; e < L.nib; e += kThreads) smem[e] = 0u;
  __syncthreads();

  // The table: single-slot subjects into the masks / per-slot entries, the
  // others appended to the multi-slot list in sorted order (a block scan).
  uint32_t listed = 0;
  int valid_any = 0;
  for (int j0 = 0; j0 < k; j0 += kThreads) {
    const int j = j0 + tid;
    bool valid = false, single = false, last = false;
    int s = 0, slot = 0, m = 0, bkey = 0;
    if (j < k) {
      s = sorted_subj[j];
      valid = s < n;
      if (valid) {
        const bool first = j == 0 || sorted_subj[j - 1] != s;
        last = j == k - 1 || sorted_subj[j + 1] != s;
        single = first && last;
        slot = order[j];
        bkey = base_key[s];
        const int key = sorted_key[j];
        m = key > bkey ? key : bkey;
      }
    }
    valid_any |= valid;
    if (single) {
      if (MODE == 0) {
        const uint32_t base = member_term(s, bkey);
        s_slot[slot] = member_term(s, m) - base;
        atomicAdd(hdr, base);
      } else {
        const uint32_t bit = 1u << (slot & 31);
        if (is_bad(m, min_status)) atomicOr(s_t + (slot >> 5), bit);
        if (is_bad(bkey, min_status)) atomicOr(s_b + (slot >> 5), bit);
        s_slot[slot] = (uint32_t)s;
      }
    }
    const bool multi = valid && !single;
    const unsigned ball = __ballot_sync(kFull, multi);
    if (lane == 0) s_warp[warp] = __popc(ball);
    __syncthreads();
    uint32_t before = 0, total = 0;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      const uint32_t c = s_warp[q];
      before += q < warp ? c : 0u;
      total += c;
    }
    if (multi) {
      const uint32_t e = listed + before + __popc(ball & ((1u << lane) - 1u));
      smem[L.mslot + e] = (uint32_t)slot | (last ? kRunLast : 0u);
      if (MODE == 0) {
        smem[L.mterm + e] = member_term(s, m);
        smem[L.mbase + e] = member_term(s, bkey);
      } else {
        smem[L.mterm + e] = is_bad(m, min_status);
        smem[L.mbase + e] = is_bad(bkey, min_status);
        smem[L.mflag + e] = 0u;
        smem[L.msubj + e] = (uint32_t)s;
      }
    }
    listed += total;
    __syncthreads();  // s_warp is read before the next chunk writes it
  }
  const int n_multi = (int)listed;
  const bool any_slot = __syncthreads_or(valid_any) != 0;
  if (MODE == 1 && !any_slot) return;  // nothing to flag

  if (MODE == 0) {
    for (int e = tid; e < 16 * kNibbles * w; e += kThreads) {
      const int v = e & 15;
      const uint32_t* d = s_slot + 4 * (e >> 4);
      smem[L.nib + e] = ((v & 1) ? d[0] : 0u) + ((v & 2) ? d[1] : 0u) + ((v & 4) ? d[2] : 0u) +
                        ((v & 8) ? d[3] : 0u);
    }
    __syncthreads();
  }
  const uint32_t c0 = hdr[0];

  for (long long tile = (long long)blockIdx.x * kThreads; tile < rows; tile += (long long)gridDim.x * kThreads) {
    const long long i = tile + tid;
    const bool in = i < rows;
    const uint32_t* row = learned + i * w;  // read only when i < n
    if (MODE == 0) {
      if (!in) continue;
      uint32_t acc = c0;
      if (any_slot) {
        for (int c = 0; c < w; c += VEC) {
          uint32_t v[VEC];
          load_words<VEC>(row + c, v);
#pragma unroll
          for (int u = 0; u < VEC; ++u) {
            const uint32_t* tab = smem + L.nib + (c + u) * (16 * kNibbles);
#pragma unroll
            for (int q = 0; q < kNibbles; ++q) acc += tab[16 * q + ((v[u] >> (4 * q)) & 15u)];
          }
        }
        bool found = false;
        uint32_t cur = 0u;
        for (int e = 0; e < n_multi; ++e) {
          const uint32_t meta = smem[L.mslot + e];
          const uint32_t slot = meta & ~kRunLast;
          const uint32_t bit = (__ldg(row + (slot >> 5)) >> (slot & 31)) & 1u;
          if (bit && !found) {
            cur = smem[L.mterm + e];
            found = true;
          }
          if (meta & kRunLast) {
            acc += found ? cur : smem[L.mbase + e];
            found = false;
          }
        }
      }
      sums[i] = (unsigned long long)acc;
    } else {
      // every lane of a warp runs the votes below, in range or not
      const bool observer = in && obs[i] != 0;  // read beside the row, not before it
      for (int c = 0; c < w; c += VEC) {
        uint32_t v[VEC];
#pragma unroll
        for (int u = 0; u < VEC; ++u) v[u] = 0u;
        if (in) load_words<VEC>(row + c, v);
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          const uint32_t t = s_t[c + u], b = s_b[c + u];
          if ((t | b) == 0u) continue;
          const uint32_t bad = observer ? ((v[u] & t) | (~v[u] & b)) : 0u;
          const uint32_t red = __reduce_or_sync(kFull, bad);
          if (lane == 0 && (red & ~s_bad[c + u]) != 0u) atomicOr(s_bad + c + u, red);
        }
      }
      bool found = false;
      uint32_t cur = 0u;
      for (int e = 0; e < n_multi; ++e) {
        const uint32_t meta = smem[L.mslot + e];
        const uint32_t slot = meta & ~kRunLast;
        const uint32_t bit = observer ? (__ldg(row + (slot >> 5)) >> (slot & 31)) & 1u : 0u;
        if (bit && !found) {
          cur = smem[L.mterm + e];
          found = true;
        }
        if (meta & kRunLast) {
          const bool bad = observer && (found ? cur : smem[L.mbase + e]) != 0u;
          if (__any_sync(kFull, bad) && lane == 0) smem[L.mflag + e] = 1u;
          found = false;
        }
      }
    }
  }
  if (MODE == 1) {
    __syncthreads();
    for (int e = tid; e < 32 * w; e += kThreads) {
      if ((s_bad[e >> 5] >> (e & 31)) & 1u) anybad[s_slot[e]] = 1;
    }
    for (int e = tid; e < n_multi; e += kThreads) {
      if (smem[L.mflag + e] != 0u) anybad[smem[L.msubj + e]] = 1;
    }
  }
}

// The 32 x 32 bit matrix whose row l is lane l's x, transposed across the
// warp: lane i gets column i (bit l set where lane l's x has bit i).  Five
// rounds of swapping off-diagonal blocks by shuffle, no branch.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  constexpr uint32_t kLow[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu, 0x33333333u, 0x55555555u};
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    const int j = 16 >> q;
    const uint32_t m = kLow[q];
    const uint32_t y = __shfl_xor_sync(kFull, x, j);
    x = (lane & j) ? ((x & ~m) | ((y >> j) & m)) : ((x & m) | ((y << j) & ~m));
  }
  return x;
}

// Scan rows [start, end) for the slots open in s_want.  Each warp keeps its
// own first row of each slot in s_wrow ([kWarps][32w]) and the slots it has
// seen in s_wseen ([kWarps][w]); its rows only grow, so a slot is written
// once, with a plain store (a shared atomicMin a bit costs several times the
// whole scan of a dense chunk).  A warp takes groups of 32 consecutive rows,
// kThreads apart, kRowsPerThread groups at a time, every load (the rows'
// words and their up bytes) in flight before any is used.  A word's 32 x 32
// bits are transposed across the warp, so lane i finds bit i's first row
// with one __ffs and writes it: no loop over the bits of a dense word.
template <int VEC>
__device__ __forceinline__ void scan_rows(const uint32_t* __restrict__ plane, const uint8_t* __restrict__ rows,
                                          int w, long long start, long long end, const uint32_t* s_want,
                                          int* s_wrow, uint32_t* s_wseen, int warp, int lane) {
  int* first_row = s_wrow + warp * 32 * w;
  uint32_t* seen = s_wseen + warp * w;
  for (long long base = start + warp * 32; base < end; base += (long long)kThreads * kRowsPerThread) {
    long long r[kRowsPerThread];
    bool in[kRowsPerThread];
    uint8_t up[kRowsPerThread];
#pragma unroll
    for (int g = 0; g < kRowsPerThread; ++g) {
      r[g] = base + (long long)g * kThreads + lane;
      in[g] = r[g] < end;
      up[g] = in[g] && rows != nullptr ? rows[r[g]] : 1;
    }
    for (int c = 0; c < w; c += 2 * VEC) {  // two loads a row in flight
      uint32_t m[2 * VEC], any = 0u;
#pragma unroll
      for (int u = 0; u < 2 * VEC; ++u) {
        m[u] = c + u < w ? s_want[c + u] : 0u;
        any |= m[u];
      }
      if (any == 0u) continue;  // the same for the whole block
      uint32_t v[kRowsPerThread][2 * VEC];
#pragma unroll
      for (int g = 0; g < kRowsPerThread; ++g) {
#pragma unroll
        for (int u = 0; u < 2 * VEC; ++u) v[g][u] = 0u;
        if (in[g]) {
          load_words<VEC>(plane + r[g] * w + c, *reinterpret_cast<uint32_t(*)[VEC]>(&v[g][0]));
          if (c + VEC < w) load_words<VEC>(plane + r[g] * w + c + VEC, *reinterpret_cast<uint32_t(*)[VEC]>(&v[g][VEC]));
        }
      }
#pragma unroll
      for (int g = 0; g < kRowsPerThread; ++g) {
        if (base + (long long)g * kThreads >= end) break;  // the same for the whole warp
#pragma unroll
        for (int u = 0; u < 2 * VEC; ++u) {
          if (m[u] == 0u) continue;
          const uint32_t old = seen[c + u];
          const uint32_t x = up[g] != 0 ? v[g][u] & m[u] & ~old : 0u;
          if (!__any_sync(kFull, x != 0u)) continue;
          const uint32_t lanes = transpose32(x, lane);  // lane i: the lanes whose row has bit i
          if (lanes != 0u) first_row[(c + u) * 32 + lane] = (int)(base + (long long)g * kThreads) + __ffs(lanes) - 1;
          const uint32_t got = __ballot_sync(kFull, lanes != 0u);
          if (lane == 0) seen[c + u] = old | got;
          __syncwarp();
        }
      }
    }
  }
}

// The block's first row of slot j over its warps' tables, which it resets.
__device__ __forceinline__ int take_first(int* s_wrow, int slots, int j) {
  int f = INT_MAX;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) {
    f = min(f, s_wrow[q * slots + j]);
    s_wrow[q * slots + j] = INT_MAX;
  }
  return f;
}

// L2's scratch, in ints: [0] the ticket counter, [kLine] the done counter,
// and from kBestAt the best row of slot j at kBestAt + j * kLine — a
// 128-byte line a slot, so the blocks' merges do not queue on a few lines.
// Between launches the counters hold 0 and every best row INT_MAX (each
// launch leaves them so).
template <int VEC>
__global__ void __launch_bounds__(kThreads)
lifecycle_first_live_learner(const uint32_t* __restrict__ plane, const uint8_t* __restrict__ rows,
                             const uint8_t* __restrict__ want, int n, int w, int k,
                             int* __restrict__ scratch, int* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_want = smem;                                         // [w] wanted slots still open here
  uint32_t* s_wseen = smem + w;                                    // [kWarps][w] slots each warp has seen
  int* s_wrow = reinterpret_cast<int*>(smem + (1 + kWarps) * w);  // [kWarps][32w] their first rows
  __shared__ unsigned int s_ticket;
  __shared__ int s_last;
  unsigned int* ticket_counter = reinterpret_cast<unsigned int*>(scratch);
  unsigned int* done_counter = reinterpret_cast<unsigned int*>(scratch + kLine);
  int* best = scratch + kBestAt;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slots = 32 * w;
  const int span = (slots + kThreads - 1) / kThreads * kThreads;  // whole warps

  int wanted = 0;
  for (int j = tid; j < span; j += kThreads) {
    const bool bit = j < k && (want == nullptr || want[j] != 0);
    const unsigned b = __ballot_sync(kFull, bit);
    if (j < slots && lane == 0) s_want[j >> 5] = b;
    wanted |= bit;
  }
  for (int e = tid; e < kWarps * slots; e += kThreads) s_wrow[e] = INT_MAX;
  for (int e = tid; e < kWarps * w; e += kThreads) s_wseen[e] = 0u;
  if (__syncthreads_or(wanted)) {
    // Tickets in ascending row order: the first gridDim are the blocks' own
    // (kOwnRows rows each; every best row is INT_MAX at launch, nothing to
    // drop), the rest come from the counter (kChunkRows each).
    unsigned int t = blockIdx.x;
    const long long first_end = (long long)gridDim.x * kOwnRows;
    for (;;) {
      if (tid == 0) s_ticket = gridDim.x + atomicAdd(ticket_counter, 1u);  // the next, fetched during this one
      const bool own = t < gridDim.x;
      const long long start = own ? (long long)t * kOwnRows : first_end + (long long)(t - gridDim.x) * kChunkRows;
      if (start >= n) break;
      scan_rows<VEC>(plane, rows, w, start, min((long long)n, start + (own ? kOwnRows : kChunkRows)), s_want,
                     s_wrow, s_wseen, warp, lane);
      __syncthreads();
      const unsigned int next = s_ticket;
      const long long next_start = first_end + (long long)(next - gridDim.x) * kChunkRows;
      // merge (fire and forget), then keep the slots the next chunk can still lower
      int open = 0;
      for (int j = tid; j < span; j += kThreads) {
        bool keep = false;
        if (j < slots) {
          const int f = take_first(s_wrow, slots, j);
          if (f != INT_MAX) atomicMin(best + j * kLine, f);
          keep = ((s_want[j >> 5] >> (j & 31)) & 1u) && f == INT_MAX && next_start < n &&
                 __ldcg(best + j * kLine) > next_start;
        }
        const unsigned b = __ballot_sync(kFull, keep);
        if (j < slots && lane == 0) s_want[j >> 5] = b;
        open |= keep;
      }
      for (int e = tid; e < kWarps * w; e += kThreads) s_wseen[e] = 0u;
      if (!__syncthreads_or(open)) break;
      t = next;
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(done_counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (s_last) {
    __threadfence();
    for (int j = tid; j < slots; j += kThreads) {
      const int b = __ldcg(best + j * kLine);
      if (j < k) out[j] = b == INT_MAX ? 0 : b;
      if (b != INT_MAX) best[j * kLine] = INT_MAX;
    }
    if (tid == 0) {
      *ticket_counter = 0u;
      *done_counter = 0u;
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return sms;
}

// The grid for `kernel`: at most (resident blocks a SM, capped at
// max_per_sm) x SMs blocks of kThreads, no more than `work`; 0 with *err set
// when the device or the kernel refuses.
template <typename Kernel>
unsigned resident_grid(Kernel kernel, long long work, long long smem, int max_per_sm, int* err) {
  const int sms = sm_count();
  *err = 0;
  if (sms <= 0) {
    *err = (int)cudaErrorInvalidDevice;
    return 0;
  }
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess) {
    *err = (int)cudaGetLastError();
    return 0;
  }
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, (size_t)smem) != cudaSuccess) {
    *err = (int)cudaGetLastError();
    return 0;
  }
  if (per_sm < 1) {
    *err = (int)cudaErrorInvalidConfiguration;
    return 0;
  }
  if (per_sm > max_per_sm) per_sm = max_per_sm;
  const long long cap = (long long)per_sm * sms;
  return (unsigned)(work < cap ? (work < 1 ? 1 : work) : cap);
}

template <typename Kernel, typename... Args>
int launch_resident(Kernel kernel, long long work, long long smem, int max_per_sm, cudaStream_t stream,
                    Args... args) {
  int err = 0;
  const unsigned grid = resident_grid(kernel, work, smem, max_per_sm, &err);
  if (err != 0) return err;
  kernel<<<grid, kThreads, (size_t)smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_walk(int vec, long long tiles, long long smem, cudaStream_t s, const uint32_t* p, int rows, int n,
                int w, int k, const int* o, const int* ss, const int* sk, const int* bk, const uint8_t* obs,
                int min_status, unsigned long long* sums, uint8_t* anybad) {
  if (vec == 4)
    return launch_resident(lifecycle_slot_walk<MODE, 4>, tiles, smem, kWalkBlocksPerSm, s, p, rows, n, w, k, o, ss,
                           sk, bk, obs, min_status, sums, anybad);
  if (vec == 2)
    return launch_resident(lifecycle_slot_walk<MODE, 2>, tiles, smem, kWalkBlocksPerSm, s, p, rows, n, w, k, o, ss,
                           sk, bk, obs, min_status, sums, anybad);
  return launch_resident(lifecycle_slot_walk<MODE, 1>, tiles, smem, kWalkBlocksPerSm, s, p, rows, n, w, k, o, ss,
                         sk, bk, obs, min_status, sums, anybad);
}

}  // namespace

// Shared memory bytes of one L1 block (mode 0 = checksum, 1 = detect).
extern "C" long long rp_slot_walk_smem(int w, int k, int mode) { return 4LL * walk_layout(w, k, mode).total; }

// mode: 0 = checksum (sums: int64[rows]), 1 = detect (obs: bool[rows],
// anybad: bool[n] pre-filled with 0).  learned: the plane's first `rows`
// rows, or a block of them; subjects (and base_key: int32[n]) range over
// [0, n).  order/sorted_subj/sorted_key: int32[k], the slots sorted by
// (subject asc, key desc), free slots (subject n) last.  vec: 4, 2 or 1,
// dividing w, with the plane's base aligned to 4 * vec bytes.  rows >= 1,
// n >= 1, 1 <= k < 2^24, w*32 >= k.
extern "C" int rp_slot_walk(const void* learned, int rows, int n, int w, int k, const void* order,
                            const void* sorted_subj, const void* sorted_key, const void* base_key,
                            const void* obs, int min_status, int mode, int vec, void* sums, void* anybad,
                            void* stream) {
  if (rows < 1 || n < 1 || k < 1 || k >= (1 << 24) || w < 1 || 32LL * w < k || (mode != 0 && mode != 1) ||
      (vec != 1 && vec != 2 && vec != 4) || w % vec != 0)
    return (int)cudaErrorInvalidValue;
  const long long smem = rp_slot_walk_smem(w, k, mode);
  const long long tiles = ((long long)rows + kThreads - 1) / kThreads;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint32_t*>(learned);
  const auto* o = static_cast<const int*>(order);
  const auto* ss = static_cast<const int*>(sorted_subj);
  const auto* sk = static_cast<const int*>(sorted_key);
  const auto* bk = static_cast<const int*>(base_key);
  const auto* ob = static_cast<const uint8_t*>(obs);
  auto* su = static_cast<unsigned long long*>(sums);
  auto* ab = static_cast<uint8_t*>(anybad);
  if (mode == 1) return launch_walk<1>(vec, tiles, smem, s, p, rows, n, w, k, o, ss, sk, bk, ob, min_status, su, ab);
  return launch_walk<0>(vec, tiles, smem, s, p, rows, n, w, k, o, ss, sk, bk, ob, min_status, su, ab);
}

// Shared memory bytes of one L2 block.
extern "C" long long rp_first_live_learner_smem(int w) { return 4LL * (1 + 33 * kWarps) * w; }

// Ints of L2's scratch for a w-word plane.
extern "C" long long rp_first_live_learner_scratch(int w) { return (long long)kBestAt + 32LL * w * kLine; }

// Where L2's scratch starts its best rows, in ints: every int from there on
// holds INT32_MAX between launches, every int before it 0.
extern "C" long long rp_first_live_learner_best_at() { return kBestAt; }

// rows: bool[n] or null.  want: bool[k] or null.  scratch: int32
// [rp_first_live_learner_scratch(w)] as rp_first_live_learner_best_at
// describes it, which each launch leaves so.  out: int32[k].  vec: as
// rp_slot_walk's.  n >= 1, 1 <= k <= 32w.
extern "C" int rp_first_live_learner(const void* plane, const void* rows, const void* want, int n, int w,
                                     int k, int vec, void* scratch, void* out, void* stream) {
  if ((vec != 1 && vec != 2 && vec != 4) || w % vec != 0 || n < 1 || k < 1 || k > 32LL * w)
    return (int)cudaErrorInvalidValue;
  const long long smem = rp_first_live_learner_smem(w);
  const long long work = ((long long)n + kOwnRows - 1) / kOwnRows;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint32_t*>(plane);
  const auto* m = static_cast<const uint8_t*>(rows);
  const auto* wt = static_cast<const uint8_t*>(want);
  auto* sc = static_cast<int*>(scratch);
  auto* o = static_cast<int*>(out);
  if (vec == 4)
    return launch_resident(lifecycle_first_live_learner<4>, work, smem, kLearnerBlocksPerSm, s, p, m, wt, n,
                           w, k, sc, o);
  if (vec == 2)
    return launch_resident(lifecycle_first_live_learner<2>, work, smem, kLearnerBlocksPerSm, s, p, m, wt, n,
                           w, k, sc, o);
  return launch_resident(lifecycle_first_live_learner<1>, work, smem, kLearnerBlocksPerSm, s, p, m, wt, n, w,
                         k, sc, o);
}
