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
//                        one fused multiply-add.
// It replaces no Pallas kernel: the JAX package reaches threefry through
// jax.random at its engines' draw sites (ringpop_tpu/sim/delta.py:334,373-
// 404; ringpop_tpu/sim/lifecycle.py:195,446-652,888-894), which XLA lowers
// with _threefry2x32_lowering (jax/_src/prng.py).  In plain PyTorch one
// threefry2x32 is about 150 launches; here each draw is one, and the key is
// read on the card, so a draw adds no host sync.
//
// What bounds it: instructions.  A randint element is two threefry2x32 (20
// rounds of add, rotate, xor and 5 key injections each) and three uint32
// remainders by a runtime span, about 150 SASS instructions, for 4 bytes
// written; at the headline's [1,000,000, 3] draw the 12 MB take 3.6 us at
// 3.35 TB/s and the instructions 13.5 us at the card's rate of 132 SMs x
// 128 lanes x 1.98 GHz.  The thread's own stream is 330 instructions: it
// repeats the key split (below).
//
// Design: one thread per output element, the 64-bit flat index split into
// the counter words; rotations are funnel shifts (SHF); randint splits its
// key in every thread (two threefry2x32 of constant counters, recomputed
// rather than shared, so the thread's stream is straight-line); a uniform
// or randint store is 4 bytes per thread, coalesced across the warp.
//
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Words {
  uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

__device__ __forceinline__ Words threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1) {
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, kRot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return {x0, x1};
}

__device__ __forceinline__ long long element() {
  return static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
}

__device__ __forceinline__ Words load_key(const int64_t* key) {
  return {static_cast<uint32_t>(__ldg(key)), static_cast<uint32_t>(__ldg(key + 1))};
}

__device__ __forceinline__ uint32_t bits32(Words key, long long i) {
  const Words w = threefry2x32(key.a, key.b, static_cast<uint32_t>(i >> 32), static_cast<uint32_t>(i));
  return w.a ^ w.b;
}

__global__ void __launch_bounds__(kThreads)
threefry_split_kernel(const int64_t* __restrict__ key, long long num, longlong2* __restrict__ out) {
  const long long i = element();
  if (i >= num) return;
  const Words k = load_key(key);
  const Words w = threefry2x32(k.a, k.b, static_cast<uint32_t>(i >> 32), static_cast<uint32_t>(i));
  out[i] = make_longlong2(w.a, w.b);
}

__global__ void __launch_bounds__(kThreads)
threefry_bits_kernel(const int64_t* __restrict__ key, long long count, int64_t* __restrict__ out) {
  const long long i = element();
  if (i >= count) return;
  out[i] = bits32(load_key(key), i);
}

__global__ void __launch_bounds__(kThreads)
threefry_randint_kernel(const int64_t* __restrict__ key, long long count, uint32_t lo, uint32_t span,
                        uint32_t mult, int32_t* __restrict__ out) {
  const long long i = element();
  if (i >= count) return;
  const Words k = load_key(key);
  // split(key, 2): keys 0 and 1 are the threefry of counters (0, 0), (0, 1)
  const Words ka = threefry2x32(k.a, k.b, 0u, 0u);
  const Words kb = threefry2x32(k.a, k.b, 0u, 1u);
  const uint32_t higher = bits32(ka, i);
  const uint32_t lower = bits32(kb, i);
  const uint32_t offset = ((higher % span) * mult + lower % span) % span;
  out[i] = static_cast<int32_t>(lo + offset);
}

__global__ void __launch_bounds__(kThreads)
threefry_uniform_kernel(const int64_t* __restrict__ key, long long count, float minval, float maxval,
                        float* __restrict__ out) {
  const long long i = element();
  if (i >= count) return;
  const uint32_t bits = bits32(load_key(key), i);
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  out[i] = fmaxf(minval, __fmaf_rn(f, __fsub_rn(maxval, minval), minval));
}

unsigned int blocks_for(long long count) {
  return static_cast<unsigned int>((count + kThreads - 1) / kThreads);
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

int rp_threefry_randint(const int64_t* key, long long count, int lo, unsigned int span, unsigned int mult,
                        int32_t* out, void* stream) {
  threefry_randint_kernel<<<blocks_for(count), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      key, count, static_cast<uint32_t>(lo), span, mult, out);
  return static_cast<int>(cudaGetLastError());
}

int rp_threefry_uniform(const int64_t* key, long long count, float minval, float maxval, float* out,
                        void* stream) {
  threefry_uniform_kernel<<<blocks_for(count), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      key, count, minval, maxval, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
