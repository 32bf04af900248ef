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
// byte read.  Design, so that a lane runs little beyond the function's own
// work:
// - a warp draws one (row, rep), eight warps a block: a butterfly of warp
//   shuffles leaves every lane with the warp's (largest, first index), with
//   no shared memory and no barrier.  (A warp drawing every rep of its row,
//   which read the mask once, and units of 2, 4 or 8 warps a row drew the
//   fullview tick's draws at N = 1000 and 4096 slower: PERF.md);
// - a lane draws runs of kRun = 8 consecutive elements: independent cipher
//   chains, written round by round across the run so that they interleave,
//   one key schedule, one counter high word and one 8-byte load of the
//   run's mask bytes, issued while the lane's run before draws.  Runs are
//   aligned to the mask's address, so a row's first and last run may be
//   partial; a run whose counters carry into the high word mid-run takes
//   the generic path, which adds the carry per element;
// - an element's key is its top 23 bits in place with kRun - k in the low
//   9 bits, 0 where barred: one unsigned max an element picks the run's
//   largest draw at its first index, and a lane carries one (largest,
//   first index) pair across its runs;
// - a run whose mask bytes are all 0 runs no cipher; where every lane's
//   run has all its bytes set, the warp runs no mask test.  The path is a
//   warp vote: a warp split between the two runs both, and at the loss1k
//   detection state ~9 % of runs are mixed, so nearly every warp was
//   split (C1 at N = 1000 took 1.5-1.6 times as long).  A row that
//   allows nothing is found by the warp's pass, which drew no run: the
//   warp then draws the row whole.  (A ballot over the mask before the
//   pass cost a dependent round trip to memory for each of a lane's runs.)
// The draw is never written to memory.
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

constexpr int kC1Threads = 256;  // eight warps, a warp a (row, rep)
constexpr int kRun = 8;          // elements a run: its mask bytes are one 8-byte load
constexpr int kNoIndex = 0x7FFFFFFF;
constexpr uint32_t kCodeBits = 0x1FFu;  // an element's key: its draw's top 23 bits in place, kRun - k below

// the mask bytes of one run, four to a word
struct RunMask {
  uint32_t w[kRun / 4];
};

// one aligned load of a run that lies inside its row
__device__ __forceinline__ RunMask load_run(const uint8_t* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  return RunMask{{v.x, v.y}};
}

// the mask of the run from column j0 of a row: its bytes, or 1 for every
// column where the row allows none (whole), and 0 outside [0, n)
__device__ __forceinline__ RunMask run_mask(const uint8_t* row, int j0, int n, bool whole) {
  RunMask m;
  if (j0 >= 0 && j0 + kRun <= n) {
    if (whole) {
#pragma unroll
      for (int i = 0; i < kRun / 4; ++i) m.w[i] = 0x01010101u;
      return m;
    }
    return load_run(row + j0);
  }
#pragma unroll
  for (int i = 0; i < kRun / 4; ++i) m.w[i] = 0;
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const int j = j0 + k;
    if (j >= 0 && j < n) m.w[k / 4] |= static_cast<uint32_t>(whole || __ldg(row + j) != 0) << (8 * (k % 4));
  }
  return m;
}

__device__ __forceinline__ bool run_none(const RunMask& m) {
  uint32_t any = 0;
#pragma unroll
  for (int i = 0; i < kRun / 4; ++i) any |= m.w[i];
  return any == 0;
}

// every byte set (a byte may hold any non-zero value)
__device__ __forceinline__ bool run_all(const RunMask& m) {
  uint32_t zero = 0;
#pragma unroll
  for (int i = 0; i < kRun / 4; ++i) zero |= __vcmpeq4(m.w[i], 0u);
  return zero == 0;
}

// the largest key of the run whose first counter is (hi, lo): element k
// draws bits(hi, lo + k), and its key is those bits with the low 9 set to
// kRun - k, so the largest key is the largest draw at its first index.
// The cipher runs round by round across the run's kRun chains, so each
// chain's next step sits kRun independent instructions after its last.
// kGeneric: barred elements (mask byte 0) key 0, and the carry of lo + k
// into the high word; else every element is drawn on one high word.
template <bool kGeneric>
__device__ __forceinline__ uint32_t draw_run(const Schedule& ks, uint32_t hi, uint32_t lo, const RunMask& m) {
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0[kRun], x1[kRun];
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const uint32_t c = lo + k;
    x0[k] = (kGeneric ? hi + (c < lo) : hi) + ks.k[0];
    x1[k] = c + ks.k[1];
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        x0[k] += x1[k];
        x1[k] = rotl(x1[k], kRot[i & 1][j]) ^ x0[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      x0[k] += ks.k[(i + 1) % 3];
      x1[k] += ks.k[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
    }
  }
  uint32_t best = 0;
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    uint32_t key = ((x0[k] ^ x1[k]) & ~kCodeBits) | static_cast<uint32_t>(kRun - k);
    if (kGeneric && !((m.w[k / 4] >> (8 * (k % 4))) & 0xFFu)) key = 0;
    best = max(best, key);
  }
  return best;
}

// (best, at) takes (value, index) when it is larger, or as large at a
// smaller index: the first index of the largest value wins
__device__ __forceinline__ void take_first_max(int& best, int& at, int value, int index) {
  if (value > best || (value == best && index < at)) {
    best = value;
    at = index;
  }
}

// a butterfly over the warp: every lane ends with the warp's first max
__device__ __forceinline__ void warp_first_max(int& best, int& at) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const int value = __shfl_xor_sync(0xFFFFFFFFu, best, offset);
    const int index = __shfl_xor_sync(0xFFFFFFFFu, at, offset);
    take_first_max(best, at, value, index);
  }
}

// one pass of a warp over its row for one (row, rep), the row's draws on
// counters base + j: every lane returns the warp's (largest draw, first
// index), (-1, kNoIndex) where it drew nothing
__device__ __forceinline__ void warp_draw(const Schedule& ks, const uint8_t* m, int off, int runs, int n,
                                          unsigned long long base, bool whole, int lane, int& best, int& at) {
  best = -1;
  at = kNoIndex;
  // each run's mask is loaded one run ahead, while the run before draws
  RunMask next = run_mask(m, lane * kRun - off, n, whole);
  // runs rise within a lane, so a strict compare keeps the first index
  for (int t = lane; t < runs; t += 32) {
    const RunMask mk = next;
    if (t + 32 < runs) next = run_mask(m, (t + 32) * kRun - off, n, whole);
    if (run_none(mk)) continue;
    const int j0 = t * kRun - off;
    // a head run's counters before column 0 wrap below base; they are barred
    const unsigned long long c0 = base + static_cast<unsigned long long>(static_cast<long long>(j0));
    const uint32_t hi = static_cast<uint32_t>(c0 >> 32), lo = static_cast<uint32_t>(c0);
    // the warp takes one path: where one lane's run is mixed or carries,
    // every lane of the warp takes the generic one (a warp split between
    // the two would run both)
    const bool fast = __all_sync(__activemask(), run_all(mk) && lo <= 0xFFFFFFFFu - (kRun - 1));
    const uint32_t top = fast ? draw_run<false>(ks, hi, lo, mk) : draw_run<true>(ks, hi, lo, mk);
    const int value = static_cast<int>(top >> 9);
    if (top && value > best) {
      best = value;
      at = j0 + kRun - static_cast<int>(top & kCodeBits);
    }
  }
  warp_first_max(best, at);
}

// C1: warp q of the grid draws (row, rep) = (q / reps, q % reps) of mask
// [rows, n]: out[q] is the first index of the largest 23-bit draw
// bits(q * n + j) >> 9 among the row's allowed entries, or over the whole
// row where it allows none
__global__ void __launch_bounds__(kC1Threads)
threefry_categorical_kernel(const int64_t* __restrict__ key, const uint8_t* __restrict__ mask, int units, int n,
                            int reps, int32_t* __restrict__ out) {
  const int q = blockIdx.x * (kC1Threads / 32) + threadIdx.x / 32;
  if (q >= units) return;  // the whole warp
  const int lane = threadIdx.x % 32;
  const uint8_t* m = mask + static_cast<long long>(q / reps) * n;
  // runs are aligned to the mask's address: run t covers columns
  // [t * kRun - off, (t + 1) * kRun - off) of the row
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(m) % kRun);
  const int runs = (off + n + kRun - 1) / kRun;
  const Schedule ks = schedule(load_key(key));
  const unsigned long long base = static_cast<unsigned long long>(q) * static_cast<unsigned>(n);
  int best, at;
  warp_draw(ks, m, off, runs, n, base, false, lane, best, at);
  // the pass drew nothing: the row allows nothing, so the warp draws all of it
  if (best < 0) warp_draw(ks, m, off, runs, n, base, true, lane, best, at);
  if (lane == 0) out[q] = at;
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
// rep); rows * reps < 2**31 and 1 <= n <= 2**30 (the wrapper checks)
int rp_threefry_categorical_rows(const int64_t* key, const uint8_t* mask, long long rows, long long n, int reps,
                                 int32_t* out, void* stream) {
  constexpr long long kWarps = kC1Threads / 32;
  const long long units = rows * reps;
  threefry_categorical_kernel<<<static_cast<unsigned int>((units + kWarps - 1) / kWarps), kC1Threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(key, mask, static_cast<int>(units),
                                                                     static_cast<int>(n), reps, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
