// The jax.random threefry stream for Hopper (sm_90a): kernel T1, one launch
// per draw of the sim engines (split, randint, uniform, raw bits).
//
// What it computes (ringpop_tpu_torch/sim/threefry.py has the plain
// version).  A key is int64[2] holding the uint32 pair (k1, k2).  Element i
// of a draw of C values (row-major flat index, 64-bit) is
// threefry2x32(k1, k2, hi(i), lo(i)) -> (b1, b2), Threefry-2x32 with 20
// rounds, as jax 0.9 with jax_threefry_partitionable lowers it:
//   rp_threefry_split:   out[i] = (b1, b2) as int64[num, 2];
//   rp_threefry_bits:    out[i] = b1 ^ b2 as int64 holding uint32;
//   rp_threefry_randint: randint(key, shape, lo, hi, int32): the key split
//                        in two, higher = bits(key_a, i), lower =
//                        bits(key_b, i), out[i] = lo + (((higher % span) *
//                        mult + lower % span) % span), all in wrapping
//                        uint32, as int32;
//   rp_threefry_uniform: f = bits as float32 mantissa in [1, 2) less 1,
//                        out[i] = max(minval, fma(f, maxval - minval,
//                        minval)): XLA contracts the scale and shift into
//                        one fused multiply-add;
//   rp_threefry_fold_in: jax.random.fold_in(key, d) = threefry2x32(key, (0,
//                        d)) as int64[2]: one thread, one cipher.
//
// Kernel C1, rp_threefry_categorical_rows, shares the cipher: the masked
// categorical draw jax.random.categorical(key, where(mask, 0, -inf)) of
// each row of a bool mask [R, N] (ringpop_tpu_torch/sim/threefry.py:
// categorical_masked has the plain version and why it is exact): out[q] is
// the first j of row q / reps that maximises bits(q * N + j) >> 9 among the
// entries the mask allows, or over the whole row where it allows none.  It
// replaces XLA's Gumbel draw, add and argmax of jax.random.categorical at
// ringpop_tpu/sim/fullview.py:296 (targets, [N, N]) and :375 (ping-req
// peers, [N, 3, N]).  Bound: operations, one cipher an element (68 lane
// instructions with the xor) and a compare-and-select, against one mask
// byte read.  Design: one block a (row, rep); its threads stride over the
// row, each keeping (largest, first index) for the allowed entries and for
// the whole row in registers, then a warp shuffle and a shared-memory
// reduce write one int32.  The mask is read once and the draw is never
// written to memory.
// It replaces no Pallas kernel: the JAX package reaches threefry through
// jax.random at its engines' draw sites (ringpop_tpu/sim/delta.py:334,373-
// 404; ringpop_tpu/sim/lifecycle.py:195,446-652,888-894), which XLA lowers
// with _threefry2x32_lowering (jax/_src/prng.py).  In plain PyTorch one
// threefry2x32 is about 150 launches; here each draw is one, and the key is
// read on the card, so a draw adds no host sync.
//
// What bounds it: integer instructions.  One threefry2x32 is 2 key adds,
// 20 rounds of add, rotate and xor and 5 two-word key injections, at least
// 67 instructions an element where a run shares the key and the counter's
// high word, for 4 bytes written; at the headline's [1,000,000, 3] randint
// the 12 MB take 3.6 us at 3.35 TB/s and the function's least 72
// instructions an element 6.5 us at the card's issue rate (132 SMs x 128
// lanes x 1.98 GHz).  The cipher's funnel shifts and xors, and the adds
// ptxas leaves beside them, issue to the ALU pipe, 64 lanes an SM a clock;
// ptxas moves the other adds to the FMA pipe (IMAD.IADD).  Rotations by
// multiplies (IMAD.HI and IMAD on the FMA pipe) ran slower.
//
// Design, so that a thread runs no more than the function's own work:
// - randint splits its key once a block: one thread computes each subkey
//   a variant reads, threefry2x32(key, (0, j)), into shared memory, and no
//   thread repeats it;
// - jax's randint multiplier, ((2**16 mod span)**2 mod span) in wrapping
//   uint32, is 0 for every span above 2**16 and for spans that divide
//   2**16, and then higher does not reach the output: the host picks the
//   variant (template parameter kTwoStreams), so a one-stream draw runs one
//   cipher an element and neither variant branches per element;
// - a remainder by the span is a high multiply, a shift and a
//   multiply-subtract with a magic number the host computes once a call
//   (Granlund-Montgomery, round-up, with the add indicator kAdd for the
//   divisors whose magic needs 33 bits; ops/threefry_kernel.py:reciprocal),
//   exact for every uint32 dividend and every divisor 1 .. 2**32 - 1;
//   Hopper has no integer divide, and `%` by a runtime value is a routine.
//   kAdd is a template parameter, not a kernel argument, because ptxas
//   computes a runtime add indicator's step at every remainder and selects
//   (SEL): the headline's randint ran about 5 % slower (PERF.md);
// - a thread draws a run of kPerThread = 8 consecutive elements:
//   independent cipher chains the scheduler interleaves, one counter high
//   word, key schedule and index for all of them, and 16-byte stores (two
//   of int32 or float32 values, four of int64); the count % 8 elements left
//   over go one to a thread, so no thread runs ciphers one after another
//   and a scalar draw or a split of 5 keys takes one cipher's time.
//   kPerThread divides 2**32 and a run starts at a multiple of it, so a
//   run's counters never carry into the high word.  128 threads x 8
//   elements (32 registers, full occupancy) drew the headline's randint
//   fastest of the block sizes and run lengths that threefry_tuning.py
//   times (PERF.md); RP_THREEFRY_THREADS and RP_THREEFRY_PER_THREAD set
//   them for such measurement builds.
// Rotations are funnel shifts (SHF).
//
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError().  Outputs are 16-byte aligned (the wrapper
// allocates them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifndef RP_THREEFRY_THREADS
#define RP_THREEFRY_THREADS 128
#endif
#ifndef RP_THREEFRY_PER_THREAD
#define RP_THREEFRY_PER_THREAD 8
#endif

constexpr int kThreads = RP_THREEFRY_THREADS;
constexpr int kPerThread = RP_THREEFRY_PER_THREAD;
static_assert((1ll << 32) % kPerThread == 0, "a thread's counters stay in one high word");

struct Words {
  uint32_t a, b;
};

// the key schedule: (k0, k1, k0 ^ k1 ^ parity)
struct Schedule {
  uint32_t k[3];
};

// d, and the magic number and shifts of `a / d` for uint32 a (see remainder)
struct Divisor {
  uint32_t d, magic, shift1, shift2;
};

__device__ __forceinline__ Schedule schedule(Words key) { return {{key.a, key.b, key.a ^ key.b ^ 0x1BD11BDAu}}; }

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

__device__ __forceinline__ Words threefry2x32(const Schedule& ks, uint32_t x0, uint32_t x1) {
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks.k[0];
  x1 += ks.k[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, kRot[i & 1][j]) ^ x0;
    }
    x0 += ks.k[(i + 1) % 3];
    x1 += ks.k[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return {x0, x1};
}

__device__ __forceinline__ uint32_t bits32(const Schedule& ks, uint32_t hi, uint32_t lo) {
  const Words w = threefry2x32(ks, hi, lo);
  return w.a ^ w.b;
}

// a % d: q = floor(a / d) from the high word of a * magic; with kAdd the
// magic has a 33rd bit, 2**32, whose product a is added back halved
// (shift1 = 1; 0 for d = 1) so that the sum stays in 32 bits.
template <bool kAdd>
__device__ __forceinline__ uint32_t remainder(uint32_t a, const Divisor& d) {
  uint32_t q = __umulhi(d.magic, a);
  if (kAdd) q += (a - q) >> d.shift1;
  return a - (q >> d.shift2) * d.d;
}

__device__ __forceinline__ Words load_key(const int64_t* key) {
  return {static_cast<uint32_t>(__ldg(key)), static_cast<uint32_t>(__ldg(key + 1))};
}

static_assert(kPerThread % 4 == 0, "the stores below write runs of four");

// a whole run's values to out[0 .. kPerThread), in 16-byte stores
__device__ __forceinline__ void store_run(int32_t* out, const int32_t (&v)[kPerThread]) {
#pragma unroll
  for (int j = 0; j < kPerThread; j += 4)
    *reinterpret_cast<int4*>(out + j) = make_int4(v[j], v[j + 1], v[j + 2], v[j + 3]);
}

__device__ __forceinline__ void store_run(float* out, const float (&v)[kPerThread]) {
#pragma unroll
  for (int j = 0; j < kPerThread; j += 4)
    *reinterpret_cast<float4*>(out + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
}

__device__ __forceinline__ void store_run(int64_t* out, const int64_t (&v)[kPerThread]) {
#pragma unroll
  for (int j = 0; j < kPerThread; j += 2) *reinterpret_cast<longlong2*>(out + j) = make_longlong2(v[j], v[j + 1]);
}

__device__ __forceinline__ void store_run(longlong2* out, const longlong2 (&v)[kPerThread]) {
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) out[j] = v[j];
}

// out[i] = draw(hi(i), lo(i)) over a draw of count elements.  Thread g <
// count / kPerThread draws the run from i = g * kPerThread, every chain at
// once, and stores it whole; each of the count % kPerThread elements left
// goes to a thread of its own, so no thread runs chains one after another
// (a scalar draw is one cipher).  The block's threads run draw_elements
// whatever their share, so a kernel may synchronise before it.
template <typename T, typename Draw>
__device__ __forceinline__ void draw_elements(T* __restrict__ out, long long count, Draw draw) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long runs = count / kPerThread;
  if (g < runs) {
    const long long e = g * kPerThread;
    const uint32_t hi = static_cast<uint32_t>(e >> 32), lo = static_cast<uint32_t>(e);
    T v[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) v[j] = draw(hi, lo + j);
    store_run(out + e, v);
    return;
  }
  const long long i = runs * kPerThread + (g - runs);
  if (i < count) out[i] = draw(static_cast<uint32_t>(i >> 32), static_cast<uint32_t>(i));
}

__global__ void __launch_bounds__(kThreads)
threefry_split_kernel(const int64_t* __restrict__ key, long long num, longlong2* __restrict__ out) {
  const Schedule ks = schedule(load_key(key));
  draw_elements(out, num, [&](uint32_t hi, uint32_t lo) {
    const Words w = threefry2x32(ks, hi, lo);
    return make_longlong2(w.a, w.b);
  });
}

__global__ void __launch_bounds__(kThreads)
threefry_bits_kernel(const int64_t* __restrict__ key, long long count, int64_t* __restrict__ out) {
  const Schedule ks = schedule(load_key(key));
  draw_elements(out, count, [&](uint32_t hi, uint32_t lo) { return static_cast<int64_t>(bits32(ks, hi, lo)); });
}

template <bool kTwoStreams, bool kAdd>
__global__ void __launch_bounds__(kThreads)
threefry_randint_kernel(const int64_t* __restrict__ key, long long count, uint32_t lo, Divisor span,
                        uint32_t mult, int32_t* __restrict__ out) {
  // split(key, 2), once a block: subkey j is threefry2x32(key, (0, j));
  // higher draws from subkey 0, lower from subkey 1
  __shared__ Words sub[2];
  if (threadIdx.x == 1 || (kTwoStreams && threadIdx.x == 0))
    sub[threadIdx.x] = threefry2x32(schedule(load_key(key)), 0u, threadIdx.x);
  __syncthreads();
  // the one-stream variant wrote no subkey 0 and reads none
  const Schedule higher_key = schedule(sub[kTwoStreams ? 0 : 1]), lower_key = schedule(sub[1]);
  draw_elements(out, count, [&](uint32_t hi, uint32_t c) {
    uint32_t offset = remainder<kAdd>(bits32(lower_key, hi, c), span);
    if (kTwoStreams) offset = remainder<kAdd>(remainder<kAdd>(bits32(higher_key, hi, c), span) * mult + offset, span);
    return static_cast<int32_t>(lo + offset);
  });
}

__global__ void __launch_bounds__(kThreads)
threefry_uniform_kernel(const int64_t* __restrict__ key, long long count, float minval, float maxval,
                        float* __restrict__ out) {
  const Schedule ks = schedule(load_key(key));
  const float scale = __fsub_rn(maxval, minval);
  draw_elements(out, count, [&](uint32_t hi, uint32_t lo) {
    const uint32_t bits = bits32(ks, hi, lo);
    const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
    return fmaxf(minval, __fmaf_rn(f, scale, minval));
  });
}

__global__ void threefry_fold_in_kernel(const int64_t* __restrict__ key, uint32_t data, longlong2* __restrict__ out) {
  const Words w = threefry2x32(schedule(load_key(key)), 0u, data);
  *out = make_longlong2(w.a, w.b);
}

constexpr int kCategoricalThreads = 256;
constexpr int kNoIndex = 0x7FFFFFFF;

// (best, at) takes (value, index) when it is larger, or as large at a
// smaller index: the first index of the largest value wins
__device__ __forceinline__ void take_first_max(int& best, int& at, int value, int index) {
  if (value > best || (value == best && index < at)) {
    best = value;
    at = index;
  }
}

__device__ __forceinline__ void warp_first_max(int& best, int& at) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const int value = __shfl_down_sync(0xFFFFFFFFu, best, offset);
    const int index = __shfl_down_sync(0xFFFFFFFFu, at, offset);
    take_first_max(best, at, value, index);
  }
}

// one block a (row, rep) q = row * reps + rep: out[q] is the first index of
// the largest 23-bit draw of the allowed entries of mask row q / reps, or of
// the whole row where none is allowed
__global__ void __launch_bounds__(kCategoricalThreads)
threefry_categorical_kernel(const int64_t* __restrict__ key, const uint8_t* __restrict__ mask, int n, int reps,
                            int32_t* __restrict__ out) {
  constexpr int kWarps = kCategoricalThreads / 32;
  __shared__ int warp_best[2][kWarps], warp_at[2][kWarps];
  const long long q = blockIdx.x;
  const uint8_t* row = mask + (q / reps) * static_cast<long long>(n);
  const unsigned long long base = static_cast<unsigned long long>(q) * static_cast<unsigned long long>(n);
  const Schedule ks = schedule(load_key(key));
  int best_allowed = -1, at_allowed = kNoIndex, best_any = -1, at_any = kNoIndex;
  // j rises within a thread, so a strict compare keeps the first index
  for (int j = threadIdx.x; j < n; j += kCategoricalThreads) {
    const unsigned long long c = base + static_cast<unsigned long long>(j);
    const int value = static_cast<int>(bits32(ks, static_cast<uint32_t>(c >> 32), static_cast<uint32_t>(c)) >> 9);
    if (value > best_any) {
      best_any = value;
      at_any = j;
    }
    if (__ldg(row + j) && value > best_allowed) {
      best_allowed = value;
      at_allowed = j;
    }
  }
  warp_first_max(best_allowed, at_allowed);
  warp_first_max(best_any, at_any);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    warp_best[0][warp] = best_allowed;
    warp_at[0][warp] = at_allowed;
    warp_best[1][warp] = best_any;
    warp_at[1][warp] = at_any;
  }
  __syncthreads();
  if (warp == 0) {
    best_allowed = lane < kWarps ? warp_best[0][lane] : -1;
    at_allowed = lane < kWarps ? warp_at[0][lane] : kNoIndex;
    best_any = lane < kWarps ? warp_best[1][lane] : -1;
    at_any = lane < kWarps ? warp_at[1][lane] : kNoIndex;
    warp_first_max(best_allowed, at_allowed);
    warp_first_max(best_any, at_any);
    if (lane == 0) out[q] = best_allowed >= 0 ? at_allowed : at_any;
  }
}

// threads: one a whole run, one an element left over
unsigned int blocks_for(long long count) {
  const long long threads = count / kPerThread + count % kPerThread;
  return static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int rp_threefry_split(const int64_t* key, long long num, int64_t* out, void* stream) {
  threefry_split_kernel<<<blocks_for(num), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      key, num, reinterpret_cast<longlong2*>(out));
  return static_cast<int>(cudaGetLastError());
}

int rp_threefry_bits(const int64_t* key, long long count, int64_t* out, void* stream) {
  threefry_bits_kernel<<<blocks_for(count), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(key, count, out);
  return static_cast<int>(cudaGetLastError());
}

// two_streams: mult != 0; add, shift1, shift2 and magic: the span's
// reciprocal (ops/threefry_kernel.py:reciprocal)
int rp_threefry_randint(const int64_t* key, long long count, int lo, unsigned int span, unsigned int mult,
                        int two_streams, unsigned int magic, int add, int shift1, int shift2, int32_t* out,
                        void* stream) {
  const Divisor d = {span, magic, static_cast<uint32_t>(shift1), static_cast<uint32_t>(shift2)};
  decltype(&threefry_randint_kernel<false, false>) kernel =
      two_streams ? (add ? threefry_randint_kernel<true, true> : threefry_randint_kernel<true, false>)
                  : (add ? threefry_randint_kernel<false, true> : threefry_randint_kernel<false, false>);
  kernel<<<blocks_for(count), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      key, count, static_cast<uint32_t>(lo), d, mult, out);
  return static_cast<int>(cudaGetLastError());
}

int rp_threefry_uniform(const int64_t* key, long long count, float minval, float maxval, float* out,
                        void* stream) {
  threefry_uniform_kernel<<<blocks_for(count), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      key, count, minval, maxval, out);
  return static_cast<int>(cudaGetLastError());
}

int rp_threefry_fold_in(const int64_t* key, unsigned int data, int64_t* out, void* stream) {
  threefry_fold_in_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(key, data, reinterpret_cast<longlong2*>(out));
  return static_cast<int>(cudaGetLastError());
}

// mask: bool [rows, n], contiguous; out: int32 [rows * reps], one a (row,
// rep); rows * reps < 2**31 and n >= 1 (the wrapper checks)
int rp_threefry_categorical_rows(const int64_t* key, const uint8_t* mask, long long rows, long long n, int reps,
                                 int32_t* out, void* stream) {
  threefry_categorical_kernel<<<static_cast<unsigned int>(rows * reps), kCategoricalThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(key, mask, static_cast<int>(n), reps, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
