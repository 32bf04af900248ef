// Telemetry-plane kernels of the sim engines for Hopper (sm_90a): the state
// digest (D1), the per-tick telemetry accumulate (P1) and the record's
// float32 sums in the JAX package's order (R1).
//
// What they compute.
//   D1 rp_state_digest: for each leaf l of a state (a table of up to
//      kMaxLeaves flat integer arrays), its inner sum
//          S_l = sum over elements i of mix32(v_i ^ mix32(offset + i))  (mod 2**32)
//      where v_i is the element as uint32 (bool 0/1, int8 sign-extended,
//      int32 as its bits, int64 by its low word) and mix32 is murmur3's
//      fmix32; then, with `final` set,
//          out = sum over l of mix32(S_l ^ (l * 0x9E3779B9))  (mod 2**32),
//      else out = S_0 (one leaf at a given offset).  For a contiguous leaf
//      the flat element index i equals JAX's row * rowlen + col, so the
//      index lane offset + i, truncated to 32 bits, is the JAX package's
//      wrapping flat_index_u32 at every size, 2**32 elements and past.
//      int8/bool/int32/int64 leaves -> one int64 holding the uint32 digest.
//   P1 rp_telemetry_accumulate: one tick of the accumulators, in place:
//          piggybacked[r, c] += popc(sent[r, c]) + popc(resp[r, c])
//          expired[r, c]     += popc(ride_ok[r, c] & ~mid_ride[r, c])
//          pings[r] += delivered[r];  probes_failed[r] += probing[r]
//          ping_reqs[r] += probing[r] ? sum over j of peer_ok[r, j] : 0
//          incarnation_bumps[r] += refute[r] & placed[r]
//          base_timer_fires[r] += base_fired[r]
//      over int32[N, W] planes (uint32 bits) and [N] vectors.
//   R1 rp_f32_sums: for each input of a table (bool, int32 or uint32 held
//      in int32; rows of `width` words `ld` apart: a vector, a plane or
//      one column of a plane), its float32 sum in XLA:CPU's order, as
//      sim/telemetry.py's f32_sum_plain takes it: windows of kSumWindow
//      rows (zero padding, pad / 2 in front), each summed in row-major
//      order, or with its first `first` rows in `lanes` lanes (row r in
//      lane r % lanes, the lanes then halved pairwise) and the rest in
//      order; then the window sums level by level in windows of kSumWindow
//      until at most kSumWindow are left, added in order.  An input with
//      lanes 0 (the reduce whose order is not pinned) is summed exactly in
//      int64 and rounded once.  Every add is one float32 __fadd_rn.
// They replace no Pallas kernel: the JAX package leaves them to XLA
// (ringpop_tpu/sim/telemetry.py, leaf_digest_sum :373 / tree_digest :408,
// accumulate :148 and fetch's float32 sums :280-332).  Torch has no
// popcount, no uint32 arithmetic and no sum of a fixed order, so the plain
// PyTorch version of each is a chain of launches (hundreds for R1: a
// float32 add a window position); these are one launch each (D1 after one
// zero fill), two for R1's whole record.
//
// What bounds them.  D1: the operations.  Each element costs two fmix32
// (shift, xor, multiply, shift, xor, multiply, shift, xor: 8 instructions,
// the value's xor folded into the inner mix's last three-input xor) and a
// wrapping add, 17 instructions, against one to eight bytes read; at the
// lifecycle headline's state (1M x 256: 2.8e8 elements, 335 MB) that is
// 0.141 ms at the card's issue rate against 0.100 ms of bytes.  P1 and R1:
// the bytes (P1: six [N, W] planes read, two written, five [N] counters
// read and written, six [N]-sized masks read, about 90 us at 1M x 8 words;
// R1: each input read once, about 25 us for a 1M x 8-word record).
//
// Design.
//   D1: one launch over a table of the leaves, passed by value (a
//   __grid_constant__ parameter, so a block indexes it without a local
//   copy).  Each leaf owns a contiguous range of the grid's blocks, in
//   proportion to its elements (one wave of kBlocksPerSm blocks an SM over
//   the whole state, at least one block a leaf).  A leaf is cut into a
//   head (the elements before its first 16-byte boundary), a body of
//   16-byte vectors (16 int8 or bool elements, or 4 int32) and a tail;
//   the leaf's blocks walk the body grid-stride, kUnroll vectors in flight
//   a thread, and the head, the tail and int64 leaves element by element.
//   Within a vector the flat index is a 32-bit lane: idx0 + j, with idx0
//   formed once a vector by wrapping 32-bit arithmetic from the leaf's
//   offset.  When the body's vectors start at flat indices that are
//   multiples of their element count (offset + head is), idx0 + j never
//   carries out of the low 16 bits, so the inner mix's first step
//   (idx ^ idx >> 16) is the vector's b = idx0 ^ idx0 >> 16 xored with j:
//   one instruction an element where it took three.  The inner mix's last
//   shift by 16 and the outer mix's first cancel (digest_from), so an
//   element takes the value as w = v ^ v >> 16: one byte permute for an
//   int8 or bool element (byte_fold), a shift and a three-input xor for an
//   int32 one.  On the H100 every one of these instructions (xor, shift,
//   multiply, byte permute, add) issues at 64 lanes a clock an SM, the
//   multiplies included (PERF.md: multiply-highs in place of the shifts
//   ran no faster), so the design counts instructions: about 15 an int8 element.  Blocks
//   reduce by warp shuffles and shared memory with wrapping adds and add
//   their partial to the leaf's slot with one atomicAdd; wrapping addition
//   is associative, so the result does not depend on the order in which
//   blocks finish.  The last block to finish (a counter bumped after a
//   fence) mixes the leaf sums and writes the result.  The slots and the
//   counter are zeroed by the wrapper.
//   P1: one thread a word of the planes (a grid-stride loop over N * W),
//   and the same thread also updates row e of the [N] legs while e < N, so
//   every load is coalesced and the tick pays one launch.
//   R1: launch one, a thread a first-level window of any input of the
//   table (inputs own contiguous block ranges, as D1's leaves do), each
//   add in the window's order, the window read as a stream of 16-byte
//   vectors where the input allows (a thread's window is contiguous but a
//   warp's 32 windows are not, so each sector is used whole while L1 holds
//   it); launch two, a block an input, the upper levels in the block (a
//   pass a level, through global scratch and __syncthreads, each pass's
//   windows staged in shared memory so that a warp loads one window's 32
//   values, one line), then the last values in order.
//
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef RP_D1_UNROLL
#define RP_D1_UNROLL 4  // 16-byte vectors in flight a thread
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 64;
constexpr int kBlocksPerSm = 8;  // 256 threads of at most 32 registers: 2048 a SM
constexpr int kUnroll = RP_D1_UNROLL;
constexpr int kVecBytes = 16;
constexpr uint32_t kC1 = 0x85EBCA6Bu, kC2 = 0xC2B2AE35u;

enum Kind : int { kBool = 0, kInt8 = 1, kInt32 = 2, kInt64 = 3 };

struct Leaf {             // 48 bytes: the table stays within 4 KB of parameters
  const void* ptr;
  long long n;          // elements
  long long vecs;       // 16-byte vectors in the body (none for int64)
  int block0;           // first block of the grid that works on this leaf
  int blocks;           // blocks on this leaf
  int head;             // elements before the body (at most 15)
  unsigned offset;      // the flat index of element 0
  int kind;
  int aligned;          // the body's vectors start at flat indices that are multiples of their elements
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int count;
  int final_mix;
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= kC1;
  x ^= x >> 13;
  x *= kC2;
  x ^= x >> 16;
  return x;
}

// mix32(v ^ mix32(idx)) from h = (idx ^ idx >> 16) * kC1, the inner mix's
// first product, and w = v ^ v >> 16.  The inner mix ends with g = h2 ^
// h2 >> 16 (h2 its second product), and the outer one starts with x ^ x >>
// 16 of x = g ^ v; since g >> 16 is h2 >> 16, that is h2 ^ w: neither mix
// takes its shift by 16 there.
__device__ __forceinline__ uint32_t digest_from(uint32_t h, uint32_t w) {
  h ^= h >> 13;
  h *= kC2;
  h ^= w;
  h *= kC1;
  h ^= h >> 13;
  h *= kC2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t digest_at(uint32_t idx, uint32_t v) {
  return digest_from((idx ^ (idx >> 16)) * kC1, v ^ (v >> 16));
}

template <int K>
__device__ __forceinline__ uint32_t load_u32(const void* p, long long i) {
  if constexpr (K == kBool) {
    return (uint32_t)__ldg(static_cast<const uint8_t*>(p) + i);
  } else if constexpr (K == kInt8) {
    return (uint32_t)(int32_t)__ldg(static_cast<const int8_t*>(p) + i);
  } else if constexpr (K == kInt32) {
    return (uint32_t)__ldg(static_cast<const int32_t*>(p) + i);
  } else {
    return (uint32_t)(unsigned long long)__ldg(static_cast<const long long*>(p) + i);
  }
}

// elements [lo, hi) of a leaf, one at a time, a thread every `stride`
template <int K>
__device__ __forceinline__ uint32_t scalar_partial(const Leaf& lf, long long lo, long long hi, long long first,
                                                   long long stride) {
  uint32_t acc = 0;
  for (long long i = lo + first; i < hi; i += stride)
    acc += digest_at(lf.offset + (uint32_t)i, load_u32<K>(lf.ptr, i));
  return acc;
}

// elements of a 16-byte vector of kind K
template <int K>
constexpr uint32_t kPerVec = K == kInt32 ? 4u : 16u;

// w = v ^ v >> 16 of byte b of `word`, in one PRMT.  An int8 byte sign-
// extended, v, has bytes [b, s, s, s] (s its sign replicated), so w's are
// [b ^ s, 0, s, s]: byte b of q (q = word ^ each byte's sign replicated,
// whose bytes' top bits are clear), then that byte's sign (0), then the
// word's byte's sign twice (selector nibbles with bit 3 set replicate a
// sign: PTX prmt's default mode; __byte_perm reads only a nibble's low
// three bits).  A bool byte is below 2**16: w = v, zero-extended.
template <int K, int b>
__device__ __forceinline__ uint32_t byte_fold(uint32_t q, uint32_t word) {
  uint32_t r;
  if constexpr (K == kInt8) {
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(q), "r"(word), "n"(b | (8 | b) << 4 | (12 | b) << 8 | (12 | b) << 12));
  } else {
    asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(word), "n"(0x4440 | b));
  }
  return r;
}

// one 16-byte vector whose first element has flat index idx0
template <int K, bool kAligned>
__device__ __forceinline__ uint32_t digest_vec(uint4 vec, uint32_t idx0) {
  const uint32_t words[4] = {vec.x, vec.y, vec.z, vec.w};
  uint32_t q[4] = {0, 0, 0, 0};
  if constexpr (K == kInt8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t sign;
      asm("prmt.b32 %0, %1, 0, 0xBA98;" : "=r"(sign) : "r"(words[i]));  // each byte's sign, replicated
      q[i] = words[i] ^ sign;
    }
  }
  const uint32_t b = idx0 ^ (idx0 >> 16);
  uint32_t acc = 0;
#pragma unroll
  for (uint32_t j = 0; j < kPerVec<K>; ++j) {
    uint32_t w, h;
    if constexpr (K == kInt32) {
      w = words[j] ^ (words[j] >> 16);
    } else {
      switch (j % 4) {  // resolved at compile time: the loop is unrolled
        case 0: w = byte_fold<K, 0>(q[j / 4], words[j / 4]); break;
        case 1: w = byte_fold<K, 1>(q[j / 4], words[j / 4]); break;
        case 2: w = byte_fold<K, 2>(q[j / 4], words[j / 4]); break;
        default: w = byte_fold<K, 3>(q[j / 4], words[j / 4]); break;
      }
    }
    if constexpr (kAligned) {
      h = (b ^ j) * kC1;
    } else {
      const uint32_t idx = idx0 + j;
      h = (idx ^ (idx >> 16)) * kC1;
    }
    acc += digest_from(h, w);
  }
  return acc;
}

// a bool, int8 or int32 leaf: its head and tail element by element, its
// body a vector at a time, kUnroll in flight
template <int K, bool kAligned>
__device__ __forceinline__ uint32_t leaf_partial(const Leaf& lf, long long first, long long stride) {
  constexpr uint32_t kPer = kPerVec<K>;
  uint32_t acc = scalar_partial<K>(lf, 0, lf.head, first, stride);
  const long long body_end = lf.head + lf.vecs * (long long)kPer;
  acc += scalar_partial<K>(lf, body_end, lf.n, first, stride);
  const uint4* body = reinterpret_cast<const uint4*>(static_cast<const uint8_t*>(lf.ptr) +
                                                     lf.head * (K == kInt32 ? 4 : 1));
  const uint32_t idx_body = lf.offset + (uint32_t)lf.head;
  long long v = first;
  for (; v + (kUnroll - 1) * stride < lf.vecs; v += kUnroll * stride) {
    uint4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) q[u] = __ldg(body + v + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      acc += digest_vec<K, kAligned>(q[u], idx_body + kPer * (uint32_t)(v + u * stride));
  }
  for (; v < lf.vecs; v += stride)
    acc += digest_vec<K, kAligned>(__ldg(body + v), idx_body + kPer * (uint32_t)v);
  return acc;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
telemetry_state_digest(const __grid_constant__ Table t, uint32_t* __restrict__ slots, long long* __restrict__ out) {
  // slots[0, count): the leaves' sums; slots[count]: blocks finished
  __shared__ uint32_t warp_sum[kThreads / 32];
  __shared__ bool last;
  const long long b = blockIdx.x;
  int l = 0;
  while (l + 1 < t.count && b >= t.leaf[l + 1].block0) ++l;
  const Leaf& lf = t.leaf[l];
  const long long stride = (long long)lf.blocks * kThreads;
  const long long first = (b - lf.block0) * kThreads + threadIdx.x;
  uint32_t acc;
#ifdef RP_D1_ONLY
  // a measurement build: the walk of one kind (kind * 2 + aligned) alone,
  // whose SASS is counted
  acc = leaf_partial<RP_D1_ONLY / 2, (RP_D1_ONLY % 2) != 0>(lf, first, stride);
#else
  switch (lf.kind * 2 + lf.aligned) {
    case kBool * 2: acc = leaf_partial<kBool, false>(lf, first, stride); break;
    case kBool * 2 + 1: acc = leaf_partial<kBool, true>(lf, first, stride); break;
    case kInt8 * 2: acc = leaf_partial<kInt8, false>(lf, first, stride); break;
    case kInt8 * 2 + 1: acc = leaf_partial<kInt8, true>(lf, first, stride); break;
    case kInt32 * 2: acc = leaf_partial<kInt32, false>(lf, first, stride); break;
    case kInt32 * 2 + 1: acc = leaf_partial<kInt32, true>(lf, first, stride); break;
    default: acc = scalar_partial<kInt64>(lf, 0, lf.n, first, stride); break;
  }
#endif
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xFFFFFFFFu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t s = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sum[w];
    atomicAdd(slots + l, s);
    __threadfence();
    last = atomicAdd(slots + t.count, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    uint32_t d;
    if (t.final_mix) {
      d = 0;
      for (int j = 0; j < t.count; ++j) d += mix32(atomicAdd(slots + j, 0u) ^ ((uint32_t)j * 0x9E3779B9u));
    } else {
      d = atomicAdd(slots, 0u);
    }
    *out = (long long)d;
  }
}

__global__ void __launch_bounds__(kThreads)
telemetry_accumulate(int* __restrict__ piggybacked, int* __restrict__ expired,
                     const int* __restrict__ sent, const int* __restrict__ resp,
                     const int* __restrict__ ride_ok, const int* __restrict__ mid_ride,
                     long long n, int w,
                     int* __restrict__ pings, int* __restrict__ ping_reqs,
                     int* __restrict__ probes_failed, int* __restrict__ incarnation_bumps,
                     int* __restrict__ base_timer_fires,
                     const uint8_t* __restrict__ delivered, const uint8_t* __restrict__ probing,
                     const uint8_t* __restrict__ peer_ok, int p,
                     const uint8_t* __restrict__ refute, const uint8_t* __restrict__ placed,
                     const uint8_t* __restrict__ base_fired) {
  const long long words = n * w;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < words; e += stride) {
    const uint32_t s = (uint32_t)__ldg(sent + e), r = (uint32_t)__ldg(resp + e);
    const uint32_t ok = (uint32_t)__ldg(ride_ok + e), mid = (uint32_t)__ldg(mid_ride + e);
    piggybacked[e] = (int)((uint32_t)piggybacked[e] + __popc(s) + __popc(r));
    expired[e] = (int)((uint32_t)expired[e] + __popc(ok & ~mid));
    if (e < n) {
      const int prob = __ldg(probing + e);
      int legs = 0;
      if (prob) {
        for (int j = 0; j < p; ++j) legs += __ldg(peer_ok + e * p + j);
      }
      pings[e] += __ldg(delivered + e);
      probes_failed[e] += prob;
      ping_reqs[e] += legs;
      incarnation_bumps[e] += __ldg(refute + e) & __ldg(placed + e);
      base_timer_fires[e] += __ldg(base_fired + e);
    }
  }
}

// -- R1 ------------------------------------------------------------------------

constexpr int kSumWindow = 32;
constexpr int kMaxSums = 32;  // a record has at most 20 inputs (tier columns counted)

enum SumKind : int { kSumBool = 0, kSumInt32 = 1, kSumUint32 = 2 };

struct SumIn {
  const void* ptr;
  long long rows;
  long long windows;    // first-level windows (1 when rows <= kSumWindow, 0 when empty)
  long long win0;       // the first window's slot in the scratch
  long long block0;     // first block of launch one on this input
  int width;            // words a row
  int ld;               // elements from one row to the next
  int kind;
  int lanes;            // 0: exact; 1: in order; 4 or 8: the window's first rows in lanes
  int pad_lo;           // first level's zero rows in front
  int first;            // rows of a window summed in lanes
  int vec;              // contiguous and 16-byte aligned: read a 16-byte vector at a time
};

struct SumTable {
  SumIn in[kMaxSums];
  int count;
};

template <int K>
__device__ __forceinline__ float as_f32(const void* p, long long e) {
  if constexpr (K == kSumBool) {
    return (float)__ldg(static_cast<const uint8_t*>(p) + e);
  } else if constexpr (K == kSumInt32) {
    return __int2float_rn(__ldg(static_cast<const int*>(p) + e));
  } else {
    return __uint2float_rn((unsigned)__ldg(static_cast<const int*>(p) + e));
  }
}

__device__ __forceinline__ long long as_i64(const SumIn& s, long long e) {
  if (s.kind == kSumBool) return (long long)__ldg(static_cast<const uint8_t*>(s.ptr) + e);
  const int v = __ldg(static_cast<const int*>(s.ptr) + e);
  return s.kind == kSumInt32 ? (long long)v : (long long)(unsigned)v;
}

// an input's elements, taken in increasing order: a 16-byte vector at a
// time where the input is contiguous and 16-byte aligned, else, and in a
// last partial vector, one at a time.  A thread's window is contiguous but
// its neighbours' are elsewhere, so a warp's load touches 32 lines; a
// vector uses a sector whole while it is in L1.  Every branch here is the
// same for the threads of a warp: they take windows of one input.
template <int K>
struct Stream {
  static constexpr int kPer = K == kSumBool ? 16 : 4;
  const void* ptr;
  long long vecs;  // whole vectors of the input (0: one element at a time)
  long long held;  // the vector in q, -1 for none
  uint4 q;

  __device__ __forceinline__ float operator()(long long e) {
    if (e / kPer >= vecs) return as_f32<K>(ptr, e);
    if (e / kPer != held) {
      held = e / kPer;
      q = __ldg(static_cast<const uint4*>(ptr) + held);
    }
    const int k = (int)(e % kPer);
    const int wi = K == kSumBool ? k >> 2 : k;
    const uint32_t w = (wi & 2) ? ((wi & 1) ? q.w : q.z) : ((wi & 1) ? q.y : q.x);
    if constexpr (K == kSumBool) {
      return (float)((w >> (8 * (k & 3))) & 0xFFu);
    } else if constexpr (K == kSumInt32) {
      return __int2float_rn((int)w);
    } else {
      return __uint2float_rn(w);
    }
  }
};

// first-level window w of input s in float32, lanes L (1: in order)
template <int K, int L>
__device__ __forceinline__ float window_sum(const SumIn& s, long long w) {
  Stream<K> x{s.ptr, s.vec ? s.rows * s.width / Stream<K>::kPer : 0, -1, {}};
  const long long r0 = w * kSumWindow - s.pad_lo;
  float acc = 0.0f;
  int r = 0;
  if constexpr (L > 1) {
    float lane[L];
#pragma unroll
    for (int l = 0; l < L; ++l) lane[l] = 0.0f;
    for (int i = 0; i < s.first / L; ++i) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const long long e = (r0 + i * L + l) * s.ld;
        for (int c = 0; c < s.width; ++c) lane[l] = __fadd_rn(lane[l], x(e + c));
      }
    }
#pragma unroll
    for (int h = L / 2; h > 0; h /= 2) {
#pragma unroll
      for (int l = 0; l < h; ++l) lane[l] = __fadd_rn(lane[l], lane[l + h]);
    }
    acc = lane[0];
    r = s.first;
  }
  for (; r < kSumWindow; ++r) {
    const long long row = r0 + r;
    if (row < 0 || row >= s.rows) continue;  // a zero of the padding adds nothing
    for (int c = 0; c < s.width; ++c) acc = __fadd_rn(acc, x(row * s.ld + c));
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
telemetry_sum_windows(const __grid_constant__ SumTable t, float* __restrict__ fwin, long long* __restrict__ xwin) {
  const long long b = blockIdx.x;
  int k = 0;
  while (k + 1 < t.count && b >= t.in[k + 1].block0) ++k;
  const SumIn& s = t.in[k];
  const long long w = (b - s.block0) * kThreads + threadIdx.x;
  if (w >= s.windows) return;
  if (s.lanes == 0) {
    const long long r0 = w * kSumWindow;
    const long long r1 = r0 + kSumWindow < s.rows ? r0 + kSumWindow : s.rows;
    long long acc = 0;
    for (long long r = r0; r < r1; ++r)
      for (int c = 0; c < s.width; ++c) acc += as_i64(s, r * s.ld + c);
    xwin[s.win0 + w] = acc;
    return;
  }
  float v;
  const int lanes = s.lanes == 8 ? 2 : (s.lanes == 4 ? 1 : 0);
  switch (s.kind * 3 + lanes) {
    case kSumBool * 3: v = window_sum<kSumBool, 1>(s, w); break;
    case kSumBool * 3 + 1: v = window_sum<kSumBool, 4>(s, w); break;
    case kSumBool * 3 + 2: v = window_sum<kSumBool, 8>(s, w); break;
    case kSumInt32 * 3: v = window_sum<kSumInt32, 1>(s, w); break;
    case kSumInt32 * 3 + 1: v = window_sum<kSumInt32, 4>(s, w); break;
    case kSumInt32 * 3 + 2: v = window_sum<kSumInt32, 8>(s, w); break;
    case kSumUint32 * 3: v = window_sum<kSumUint32, 1>(s, w); break;
    case kSumUint32 * 3 + 1: v = window_sum<kSumUint32, 4>(s, w); break;
    default: v = window_sum<kSumUint32, 8>(s, w); break;
  }
  fwin[s.win0 + w] = v;
}

// A level's windows are staged in shared memory: tile[window][i], rows
// padded to kTileStride words, so that a warp loading one window (one line)
// and a thread walking its own row each touch 32 banks.
constexpr int kTileStride = kSumWindow + 1;

// the levels above the first, in the block: windows of kSumWindow over the
// m values at src (zero padding, pad / 2 in front, added as XLA adds it),
// kThreads windows at a time staged in the tile, a warp loading 32 windows
// with a load each in flight together, until at most kSumWindow are left;
// then their sum in order (every thread returns it)
__device__ float float_levels(float* src, float* dst, long long m, float (*tile)[kTileStride]) {
  constexpr int kWarps = kThreads / 32;
  const int i = threadIdx.x & 31;
  while (m > kSumWindow) {
    const long long pad = (kSumWindow - m % kSumWindow) % kSumWindow, lo = pad / 2;
    const long long next = (m + pad) / kSumWindow;
    for (long long g = 0; g < next; g += kThreads) {
#pragma unroll
      for (int u = 0; u < kThreads / kWarps; ++u) {
        const int wi = (threadIdx.x >> 5) + u * kWarps;
        const long long at = (g + wi) * kSumWindow + i - lo;
        tile[wi][i] = g + wi < next && at >= 0 && at < m ? src[at] : 0.0f;
      }
      __syncthreads();
      if (g + threadIdx.x < next) {
        float acc = 0.0f;
        for (int j = 0; j < kSumWindow; ++j) acc = __fadd_rn(acc, tile[threadIdx.x][j]);
        dst[g + threadIdx.x] = acc;
      }
      __syncthreads();
    }
    float* tmp = src;
    src = dst;
    dst = tmp;
    m = next;
  }
  float v[kSumWindow];
#pragma unroll
  for (int j = 0; j < kSumWindow; ++j) v[j] = j < m ? src[j] : 0.0f;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kSumWindow; ++j) acc = __fadd_rn(acc, v[j]);  // a zero past m adds nothing
  return acc;
}

// an exact input's window sums: their int64 total (any order)
__device__ long long exact_total(const long long* src, long long m) {
  __shared__ long long part[kThreads];
  long long acc = 0;
  for (long long j = threadIdx.x; j < m; j += kThreads) acc += src[j];
  part[threadIdx.x] = acc;
  __syncthreads();
  long long total = 0;
  for (int j = 0; j < kThreads; ++j) total += part[j];
  return total;
}

__global__ void __launch_bounds__(kThreads)
telemetry_sum_levels(const __grid_constant__ SumTable t, float* fwin, long long* xwin, long long windows,
                     float* __restrict__ out) {
  __shared__ float tile[kThreads][kTileStride];
  const SumIn& s = t.in[blockIdx.x];
  float total;
  if (s.lanes == 0) {
    total = __ll2float_rn(exact_total(xwin + s.win0, s.windows));
  } else {
    total = float_levels(fwin + s.win0, fwin + windows + s.win0, s.windows, tile);
  }
  if (threadIdx.x == 0) out[blockIdx.x] = total;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return sms;
}

}  // namespace

// ptrs, ns, offsets, kinds: count leaves (1 <= count <= 64), each of ns[l] >= 0
// elements of kind kinds[l] (0 bool, 1 int8, 2 int32, 3 int64), based at an
// address that is a multiple of its element size.  slots: uint32[count + 1],
// zeroed.  out: one int64.  final_mix: 1 for the tree digest, 0 for the
// first leaf's sum.
extern "C" int rp_state_digest(const void* const* ptrs, const long long* ns, const unsigned* offsets,
                               const int* kinds, int count, int final_mix, void* slots, void* out,
                               void* stream) {
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  if (count < 1 || count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  Table t = {};
  t.count = count;
  t.final_mix = final_mix;
  long long elements = 0;
  for (int l = 0; l < count; ++l) {
    if (ns[l] < 0 || kinds[l] < kBool || kinds[l] > kInt64) return (int)cudaErrorInvalidValue;
    elements += ns[l];
  }
  const long long wave = (long long)kBlocksPerSm * sms;
  long long blocks = 0;
  for (int l = 0; l < count; ++l) {
    const long long n = ns[l];
    const int size = kinds[l] == kInt32 ? 4 : (kinds[l] == kInt64 ? 8 : 1);
    const uintptr_t addr = reinterpret_cast<uintptr_t>(ptrs[l]);
    if (addr % size) return (int)cudaErrorMisalignedAddress;
    long long head = 0, vecs = 0, per = 1;  // an int64 leaf is walked element by element
    int aligned = 0;
    if (kinds[l] != kInt64) {
      per = kVecBytes / size;
      head = (long long)((kVecBytes - addr % kVecBytes) % kVecBytes) / size;
      head = head < n ? head : n;
      vecs = (n - head) / per;
      aligned = ((offsets[l] + (unsigned)head) % (unsigned)per) == 0;
    }
    // items a thread takes: vectors, and the head's and tail's elements;
    // every leaf takes at least one block, so an empty leaf still counts
    // toward the last block's finish
    const long long items = kinds[l] == kInt64 ? n : vecs + (n - vecs * per);
    long long want = (items + (long long)kThreads * kUnroll - 1) / ((long long)kThreads * kUnroll);
    const long long share = elements > 0 ? (wave * n + elements - 1) / elements : 1;
    want = want < share ? want : share;
    want = want < 1 ? 1 : want;
    if (blocks + want > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    t.leaf[l] = Leaf{ptrs[l], n, vecs, (int)blocks, (int)want, (int)head, offsets[l], kinds[l], aligned};
    blocks += want;
  }
  telemetry_state_digest<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<uint32_t*>(slots), static_cast<long long*>(out));
  return (int)cudaGetLastError();
}

// The planes: int32[n, w]; the counters: int32[n]; the masks: bool[n], and
// peer_ok bool[n, p].  n >= 1, w >= 1, p >= 0.
extern "C" int rp_telemetry_accumulate(void* piggybacked, void* expired, const void* sent,
                                       const void* resp, const void* ride_ok, const void* mid_ride,
                                       long long n, int w, void* pings, void* ping_reqs,
                                       void* probes_failed, void* incarnation_bumps,
                                       void* base_timer_fires, const void* delivered,
                                       const void* probing, const void* peer_ok, int p,
                                       const void* refute, const void* placed,
                                       const void* base_fired, void* stream) {
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  if (n < 1 || w < 1 || p < 0) return (int)cudaErrorInvalidValue;
  const long long words = n * w;
  const long long want = (words + kThreads - 1) / kThreads;
  const long long cap = 8LL * sms;
  const unsigned grid = (unsigned)(want < cap ? want : cap);
  telemetry_accumulate<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(piggybacked), static_cast<int*>(expired), static_cast<const int*>(sent),
      static_cast<const int*>(resp), static_cast<const int*>(ride_ok), static_cast<const int*>(mid_ride), n, w,
      static_cast<int*>(pings), static_cast<int*>(ping_reqs), static_cast<int*>(probes_failed),
      static_cast<int*>(incarnation_bumps), static_cast<int*>(base_timer_fires),
      static_cast<const uint8_t*>(delivered), static_cast<const uint8_t*>(probing),
      static_cast<const uint8_t*>(peer_ok), p, static_cast<const uint8_t*>(refute),
      static_cast<const uint8_t*>(placed), static_cast<const uint8_t*>(base_fired));
  return (int)cudaGetLastError();
}

// count inputs (1 <= count <= 32): ptrs[i] holds rows[i] rows of widths[i]
// elements, lds[i] apart, of kind kinds[i] (0 bool, 1 int32, 2 uint32 held
// in int32); lanes[i] is 0 (exact), 1 (in order), or 4 or 8 (the first
// level's lanes, only where rows[i] > 32 and rows[i] % 32 is 0 or 31).
// fwin and xwin hold 2 * windows floats and int64s, windows being the sum
// over inputs of ceil(rows[i] / 32); out: float32[count].  *launched: the
// launches made (two, or one when every input is empty).
extern "C" int rp_f32_sums(const void* const* ptrs, const long long* rows, const int* widths, const int* lds,
                           const int* kinds, const int* lanes, int count, void* fwin, void* xwin,
                           long long windows, void* out, int* launched, void* stream) {
  *launched = 0;
  if (count < 1 || count > kMaxSums) return (int)cudaErrorInvalidValue;
  SumTable t = {};
  t.count = count;
  long long win = 0, blocks = 0;
  for (int i = 0; i < count; ++i) {
    if (rows[i] < 0 || widths[i] < 1 || lds[i] < widths[i] || kinds[i] < kSumBool || kinds[i] > kSumUint32 ||
        !(lanes[i] == 0 || lanes[i] == 1 || lanes[i] == 4 || lanes[i] == 8))
      return (int)cudaErrorInvalidValue;
    SumIn s = {};
    s.ptr = ptrs[i];
    s.rows = rows[i];
    s.width = widths[i];
    s.ld = lds[i];
    s.kind = kinds[i];
    s.lanes = lanes[i];
    s.vec = lds[i] == widths[i] && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
    // a window of kSumWindow rows, and one for all of a shorter input
    s.windows = (rows[i] + kSumWindow - 1) / kSumWindow;
    if (rows[i] > kSumWindow && s.lanes != 0) {
      const long long pad = (kSumWindow - rows[i] % kSumWindow) % kSumWindow;
      s.pad_lo = (int)(pad / 2);
      s.first = (int)((kSumWindow - pad) / s.lanes * s.lanes);
    }
    if (s.lanes > 1 && (rows[i] <= kSumWindow || s.pad_lo != 0)) return (int)cudaErrorInvalidValue;
    s.win0 = win;
    s.block0 = blocks;
    win += s.windows;
    blocks += (s.windows + kThreads - 1) / kThreads;
    t.in[i] = s;
  }
  if (win != windows || blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    telemetry_sum_windows<<<(unsigned)blocks, kThreads, 0, st>>>(t, static_cast<float*>(fwin),
                                                                 static_cast<long long*>(xwin));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    *launched += 1;
  }
  telemetry_sum_levels<<<count, kThreads, 0, st>>>(t, static_cast<float*>(fwin), static_cast<long long*>(xwin),
                                                   windows, static_cast<float*>(out));
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) *launched += 1;
  return (int)err;
}
