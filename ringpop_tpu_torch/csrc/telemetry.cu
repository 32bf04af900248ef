// Telemetry-plane kernels of the sim engines for Hopper (sm_90a): the state
// digest (D1) and the per-tick telemetry accumulate (P1).
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
// They replace no Pallas kernel: the JAX package leaves both to XLA
// (ringpop_tpu/sim/telemetry.py, leaf_digest_sum :373 / tree_digest :408
// and accumulate :148).  Torch has no popcount and no uint32 arithmetic,
// so the plain PyTorch version of each is a chain of launches over int64
// temporaries; these are one launch each (D1 after one zero fill).
//
// What bounds them.  D1: the operations.  Each element costs two fmix32
// (shift, xor, multiply, shift, xor, multiply, shift, xor: 8 instructions,
// the value's xor folded into the inner mix's last three-input xor) and a
// wrapping add, 17 instructions, against one to eight bytes read; at the
// lifecycle headline's state (1M x 256: 2.8e8 elements, 335 MB) that is
// 0.141 ms at the card's issue rate against 0.100 ms of bytes.  P1: the
// bytes: six [N, W] planes read, two written, five [N] counters read and
// written and six [N]-sized masks read; about 90 us at 1M x 8 words.
//
// Design.
//   D1: one launch over a table of the leaves, passed by value (a
//   __grid_constant__ parameter, so a block indexes it without a local
//   copy).  Each leaf
//   owns a contiguous range of the grid's blocks, sized to its elements
//   (at most 8 blocks an SM a leaf); a block walks its leaf grid-stride,
//   four elements in flight a thread, reads each element once in its own
//   type, reduces by warp shuffles and shared memory with wrapping adds, and
//   adds its partial to the leaf's slot with one atomicAdd.  Wrapping
//   addition is associative, so the result does not depend on the order in
//   which blocks finish.  The last block to finish (a counter bumped after
//   a fence) mixes the leaf sums and writes the result.  The slots and the
//   counter are zeroed by the wrapper.
//   P1: one thread a word of the planes (a grid-stride loop over N * W),
//   and the same thread also updates row e of the [N] legs while e < N, so
//   every load is coalesced and the tick pays one launch.
//
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 64;
constexpr int kUnroll = 4;

enum Kind : int { kBool = 0, kInt8 = 1, kInt32 = 2, kInt64 = 3 };

struct Leaf {
  const void* ptr;
  long long n;          // elements
  long long block0;     // first block of the grid that works on this leaf
  long long blocks;     // blocks on this leaf
  unsigned offset;      // the flat index of element 0
  int kind;
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int count;
  int final_mix;
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
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

template <int K>
__device__ __forceinline__ uint32_t leaf_partial(const Leaf& lf, long long first, long long stride) {
  uint32_t acc = 0;
  const long long n = lf.n;
  long long i = first;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    uint32_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = load_u32<K>(lf.ptr, i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      acc += mix32(v[u] ^ mix32(lf.offset + (uint32_t)(i + u * stride)));
  }
  for (; i < n; i += stride) acc += mix32(load_u32<K>(lf.ptr, i) ^ mix32(lf.offset + (uint32_t)i));
  return acc;
}

__global__ void __launch_bounds__(kThreads)
telemetry_state_digest(const __grid_constant__ Table t, uint32_t* __restrict__ slots, long long* __restrict__ out) {
  // slots[0, count): the leaves' sums; slots[count]: blocks finished
  __shared__ uint32_t warp_sum[kThreads / 32];
  __shared__ bool last;
  const long long b = blockIdx.x;
  int l = 0;
  while (l + 1 < t.count && b >= t.leaf[l + 1].block0) ++l;
  const Leaf& lf = t.leaf[l];
  const long long stride = lf.blocks * kThreads;
  const long long first = (b - lf.block0) * kThreads + threadIdx.x;
  uint32_t acc;
  switch (lf.kind) {
    case kBool: acc = leaf_partial<kBool>(lf, first, stride); break;
    case kInt8: acc = leaf_partial<kInt8>(lf, first, stride); break;
    case kInt32: acc = leaf_partial<kInt32>(lf, first, stride); break;
    default: acc = leaf_partial<kInt64>(lf, first, stride); break;
  }
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

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return sms;
}

}  // namespace

// ptrs, ns, offsets, kinds: count leaves (1 <= count <= 64), each of ns[l] >= 0
// elements of kind kinds[l] (0 bool, 1 int8, 2 int32, 3 int64).  slots:
// uint32[count + 1], zeroed.  out: one int64.  final_mix: 1 for the tree
// digest, 0 for the first leaf's sum.
extern "C" int rp_state_digest(const void* const* ptrs, const long long* ns, const unsigned* offsets,
                               const int* kinds, int count, int final_mix, void* slots, void* out,
                               void* stream) {
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  if (count < 1 || count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  Table t = {};
  t.count = count;
  t.final_mix = final_mix;
  const long long cap = 8LL * sms;
  long long blocks = 0;
  for (int l = 0; l < count; ++l) {
    if (ns[l] < 0 || kinds[l] < kBool || kinds[l] > kInt64) return (int)cudaErrorInvalidValue;
    // every leaf takes at least one block, so an empty leaf still counts
    // toward the last block's finish
    long long want = (ns[l] + (long long)kThreads * kUnroll - 1) / ((long long)kThreads * kUnroll);
    want = want < 1 ? 1 : (want > cap ? cap : want);
    t.leaf[l] = Leaf{ptrs[l], ns[l], blocks, want, offsets[l], kinds[l]};
    blocks += want;
  }
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
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
