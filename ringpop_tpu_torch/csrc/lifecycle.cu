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
//     stays 0 for subjects without a slot.
//     int32[N, W] + int32[K] order/subject/key + int32[N] base_key
//     (+ bool[N] obs) -> int64[N] or bool[N].
//   L2 rp_first_live_learner: out[j] = min row r with bit j of learned[r]
//     set and rows[r] (bool[N], or every row when null); out is int32[32W],
//     pre-filled with INT32_MAX by the wrapper, which maps INT32_MAX to 0
//     (jnp.argmax of an all-false column) and keeps the first K entries.
//
// They replace no Pallas kernel: the JAX package leaves both to XLA
// (ringpop_tpu/sim/lifecycle.py: _walk_subject_slots :1363, a fori_loop of
// K dependent steps over [N] columns under detection_complete :1291 and
// view_checksums :1435; _first_live_learner :755, an argmax over the
// unpacked [N, K] plane).  Torch has no one-launch form of either.
//
// What bounds them.  Bytes, by design: at the headline's N = 1,000,000,
// K = 256 (W = 8), L1 reads the 32 MB plane and writes 8 MB of int64
// checksums (checksum mode) or reads the plane and 1 MB of observer mask
// and sets 1 MB of flags (detect mode); its K-entry tables are noise.  L2
// reads 32 MB + 1 MB.  At 3.35 TB/s that is ~12 us, ~10 us and ~10 us.
//
// Design.
//   L1: computing fmix32(fmix32(s) ^ m) per (node, subject) would be
//   ~2 * K fmix32 per node, ~5e9 integer operations at the headline: it
//   would be compute-bound.  Within a subject the slots are sorted by key
//   descending, so a node's governing key is fixed by the FIRST slot of the
//   subject it learned.  Each block therefore builds, in shared memory, a
//   K-entry table: per sorted position j the slot id, whether it closes its
//   subject, the term (checksum mode) or the bad bit (detect mode) a node
//   whose first learned slot of s_j is j takes, and the same for a node that
//   learned none (the base).  That is 2K fmix32 per block.  A node then does
//   one bit test per slot and one table read per subject.  The block stages
//   its nodes' rows in shared memory (coalesced loads; row stride W | 1
//   words, odd, so the per-slot reads of 32 rows hit 32 banks), one thread
//   per node, a grid-stride loop over node tiles.  The walk stops at the
//   first free slot (free slots sort last).  Checksum mode adds into a
//   uint32 (wraps as JAX's uint32 does) and writes one int64 per node.
//   Detect mode ORs a warp ballot into a shared flag per subject; at the
//   end each block stores 1 into anybad[s] for its set flags.  Every store
//   writes the same 1, so the result does not depend on the order of the
//   blocks.
//   L2: S1's fold (csrc/packbits.cu) with min instead of OR.  Threads form
//   `lanes` rows of `tcols` VEC-word columns (a tile of at most 32 columns
//   per grid.y); each walks its rows in ascending order, four loads in
//   flight, and keeps the bits it has already seen: a bit seen for the
//   first time is that thread's lowest row for the slot, and goes into a
//   shared int32 per slot by atomicMin.  The block then merges its slots
//   into `out` by atomicMin.  Min commutes: the result is deterministic.
//
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTombstone = 4;
constexpr int kStateMask = 7;       // KEY_STATE_BITS = 3
constexpr uint32_t kValid = 1u << 31;
constexpr uint32_t kLast = 1u << 30;
constexpr uint32_t kSlotMask = (1u << 24) - 1;
constexpr int kL2TileCols = 32;     // element columns per L2 block tile

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

// Shared memory: meta[k], term[k], base[k], flag[k], then the row tile.
template <int MODE>  // 0 = checksum, 1 = detect
__global__ void __launch_bounds__(kThreads)
lifecycle_slot_walk(const uint32_t* __restrict__ learned, int n, int w, int k,
                    const int* __restrict__ order, const int* __restrict__ sorted_subj,
                    const int* __restrict__ sorted_key, const int* __restrict__ base_key,
                    const uint8_t* __restrict__ obs, int min_status,
                    unsigned long long* __restrict__ sums, uint8_t* __restrict__ anybad) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_meta = smem;
  uint32_t* s_term = smem + k;
  uint32_t* s_base = smem + 2 * k;
  uint32_t* s_flag = smem + 3 * k;
  uint32_t* s_rows = smem + 4 * k;
  const int stride = w | 1;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;

  for (int j = tid; j < k; j += threads) {
    const int s = sorted_subj[j];
    const bool valid = s < n;
    const bool last = valid && (j == k - 1 || sorted_subj[j + 1] != s);
    const int sc = s < n ? s : n - 1;
    const int bkey = base_key[sc];
    const int key = sorted_key[j];
    const int m = key > bkey ? key : bkey;
    s_meta[j] = ((uint32_t)order[j] & kSlotMask) | (valid ? kValid : 0u) | (last ? kLast : 0u);
    if (MODE == 0) {
      s_term[j] = member_term(sc, m);
      s_base[j] = member_term(sc, bkey);
    } else {
      s_term[j] = is_bad(m, min_status);
      s_base[j] = is_bad(bkey, min_status);
    }
    s_flag[j] = 0u;
  }

  const int lane = tid & 31;
  uint32_t* my_row = s_rows + tid * stride;
  for (long long tile = (long long)blockIdx.x * threads; tile < n; tile += (long long)gridDim.x * threads) {
    const int rows_here = (int)((n - tile) < threads ? (n - tile) : threads);
    __syncthreads();  // the table is built / the previous tile's rows are read
    const uint32_t* src = learned + tile * w;
    for (int e = tid; e < rows_here * w; e += threads) {
      const int r = e / w;
      s_rows[r * stride + (e - r * w)] = __ldg(src + e);
    }
    __syncthreads();
    const bool in = tid < rows_here;
    const bool observer = in && (MODE == 0 || obs[tile + tid] != 0);
    uint32_t acc = 0u, cur = 0u;
    bool found = false;
    for (int j = 0; j < k; ++j) {
      const uint32_t meta = s_meta[j];
      if (!(meta & kValid)) break;  // free slots sort last
      const uint32_t slot = meta & kSlotMask;
      const uint32_t bit = in ? (my_row[slot >> 5] >> (slot & 31)) & 1u : 0u;
      if (bit && !found) {
        cur = s_term[j];
        found = true;
      }
      if (meta & kLast) {
        const uint32_t v = found ? cur : s_base[j];
        if (MODE == 0) {
          acc += v;
        } else {
          const unsigned any = __ballot_sync(0xFFFFFFFFu, observer && v != 0u);
          if (any != 0u && lane == 0) s_flag[j] = 1u;
        }
        found = false;
      }
    }
    if (MODE == 0 && in) sums[tile + tid] = (unsigned long long)acc;
  }
  if (MODE == 1) {
    __syncthreads();
    for (int j = tid; j < k; j += threads) {
      if (s_flag[j] != 0u) anybad[sorted_subj[j]] = 1;  // set only at a subject's last slot
    }
  }
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

// Record the bits of `v` this thread has not seen yet at row r.
template <int VEC>
__device__ __forceinline__ void note_row(const uint32_t (&v)[VEC], uint32_t (&seen)[VEC], int r,
                                         int* s_first, int c) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    uint32_t fresh = v[i] & ~seen[i];
    seen[i] |= v[i];
    while (fresh != 0u) {
      const int b = __ffs(fresh) - 1;
      fresh &= fresh - 1u;
      int* dst = s_first + (c * VEC + i) * 32 + b;
      if (r < *dst) atomicMin(dst, r);
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
lifecycle_first_live_learner(const uint32_t* __restrict__ plane, const uint8_t* __restrict__ rows,
                             int n, int w, int* __restrict__ out) {
  __shared__ int s_first[kL2TileCols * VEC * 32];
  const int cols = w / VEC;
  const int tile0 = blockIdx.y * kL2TileCols;
  const int tcols = min(kL2TileCols, cols - tile0);
  const int lanes = kThreads / tcols;
  const int tid = threadIdx.x;
  const int lane = tid / tcols;
  const int c = tid - lane * tcols;
  const int slots = tcols * VEC * 32;
  for (int e = tid; e < slots; e += kThreads) s_first[e] = INT_MAX;
  __syncthreads();

  if (lane < lanes) {
    uint32_t seen[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) seen[i] = 0u;
    const uint32_t* base = plane + (long long)(tile0 + c) * VEC;
    const long long stride = (long long)gridDim.x * lanes;
    long long r = (long long)blockIdx.x * lanes + lane;
    for (; r + 3 * stride < n; r += 4 * stride) {
      uint32_t v[4][VEC];
      bool keep[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long rr = r + u * stride;
        load_words<VEC>(base + rr * w, v[u]);
        keep[u] = rows == nullptr || __ldg(rows + rr) != 0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (keep[u]) note_row<VEC>(v[u], seen, (int)(r + u * stride), s_first, c);
      }
    }
    for (; r < n; r += stride) {
      uint32_t v[VEC];
      load_words<VEC>(base + r * w, v);
      if (rows == nullptr || __ldg(rows + r) != 0) note_row<VEC>(v, seen, (int)r, s_first, c);
    }
  }
  __syncthreads();
  for (int e = tid; e < slots; e += kThreads) {
    const int v = s_first[e];
    if (v != INT_MAX) atomicMin(out + tile0 * VEC * 32 + e, v);
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return sms;
}

}  // namespace

// Shared memory bytes of one L1 block of `threads` threads.
extern "C" long long rp_slot_walk_smem(int w, int k, int threads) {
  return 4LL * (4LL * k + (long long)threads * (w | 1));
}

// mode: 0 = checksum (sums: int64[n]), 1 = detect (obs: bool[n], anybad:
// bool[n] pre-filled with 0).  order/sorted_subj/sorted_key: int32[k], the
// slots sorted by (subject asc, key desc), free slots (subject n) last.
// threads: a multiple of 32 in [32, 256].  n >= 1, 1 <= k < 2^24, w*32 >= k.
extern "C" int rp_slot_walk(const void* learned, int n, int w, int k, const void* order,
                            const void* sorted_subj, const void* sorted_key, const void* base_key,
                            const void* obs, int min_status, int mode, int threads, void* sums,
                            void* anybad, void* stream) {
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  if (n < 1 || k < 1 || k >= (1 << 24) || w < 1 || 32LL * w < k || threads < 32 ||
      threads > kThreads || threads % 32 != 0 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  const long long smem = rp_slot_walk_smem(w, k, threads);
  const long long tiles = ((long long)n + threads - 1) / threads;
  const long long cap = 8LL * sms;
  const unsigned grid = (unsigned)(tiles < cap ? tiles : cap);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint32_t*>(learned);
  const auto* o = static_cast<const int*>(order);
  const auto* ss = static_cast<const int*>(sorted_subj);
  const auto* sk = static_cast<const int*>(sorted_key);
  const auto* bk = static_cast<const int*>(base_key);
  if (mode == 0) {
    if (smem > 48 * 1024 &&
        cudaFuncSetAttribute(lifecycle_slot_walk<0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess)
      return (int)cudaGetLastError();
    lifecycle_slot_walk<0><<<grid, threads, smem, s>>>(
        p, n, w, k, o, ss, sk, bk, nullptr, min_status, static_cast<unsigned long long*>(sums), nullptr);
  } else {
    if (smem > 48 * 1024 &&
        cudaFuncSetAttribute(lifecycle_slot_walk<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess)
      return (int)cudaGetLastError();
    lifecycle_slot_walk<1><<<grid, threads, smem, s>>>(
        p, n, w, k, o, ss, sk, bk, static_cast<const uint8_t*>(obs), min_status, nullptr,
        static_cast<uint8_t*>(anybad));
  }
  return (int)cudaGetLastError();
}

// rows: bool[n] or null.  out: int32[32 * w], pre-filled with INT32_MAX.
// vec: 4, 2 or 1, dividing w, with the plane's base aligned to 4 * vec
// bytes.  n >= 1, w >= 1.
extern "C" int rp_first_live_learner(const void* plane, const void* rows, int n, int w, int vec,
                                     void* out, void* stream) {
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  if ((vec != 1 && vec != 2 && vec != 4) || w % vec != 0 || n < 1) return (int)cudaErrorInvalidValue;
  const int cols = w / vec;
  const int tcols = cols < kL2TileCols ? cols : kL2TileCols;
  const int lanes = kThreads / tcols;
  const long long chunks = ((long long)n + lanes - 1) / lanes;
  const long long cap = 4LL * sms;
  const dim3 grid((unsigned)(chunks < cap ? chunks : cap), (unsigned)((cols + kL2TileCols - 1) / kL2TileCols));
  const auto* p = static_cast<const uint32_t*>(plane);
  const auto* m = static_cast<const uint8_t*>(rows);
  auto* o = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    lifecycle_first_live_learner<4><<<grid, kThreads, 0, s>>>(p, m, n, w, o);
  else if (vec == 2)
    lifecycle_first_live_learner<2><<<grid, kThreads, 0, s>>>(p, m, n, w, o);
  else
    lifecycle_first_live_learner<1><<<grid, kThreads, 0, s>>>(p, m, n, w, o);
  return (int)cudaGetLastError();
}
