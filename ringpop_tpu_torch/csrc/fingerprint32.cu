// FarmHash Fingerprint32 (farmhashmk::Hash32) of B byte strings on Hopper.
//
// Replaces ringpop_tpu/ops/hash_pallas.py::_mix_kernel (the Pallas kernel
// behind fingerprint32_pallas) together with the XLA work around it: the
// <=24-byte length classes and the five tail fetches of the >24 path.  One
// thread hashes one key row end to end — length class, tail fetches, the
// (len-1)/20 mixing iterations and the finalizer — in registers, so each row
// of the key matrix is read from device memory once and nothing is written
// between stages.
//
// Bound: device-memory bytes.  Per row the kernel moves W key bytes, 4 bytes
// of length and 4 bytes of hash (B*W + 4B + 4B in all) and does a few hundred
// integer operations, far below the card's integer rate.  This first version
// reads bytes one at a time from each thread's own row; neighbouring threads
// hit addresses W bytes apart, so a warp's loads are not coalesced and lean
// on L1.  Staging rows in shared memory with 16-byte loads is later work.
//
// Layout: mat is uint8[B, W] row-major (row r starts at r*W, W arbitrary, so
// rows are not 4-byte aligned: every word is assembled from 4 byte loads —
// a uint32 load at an unaligned address faults).  lens is int32[B].  out is
// uint32[B].  Dynamic byte offsets are clamped to [0, W-4]; the wrapper
// guarantees W >= 4.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kC1 = 0xcc9e2d51u;
constexpr uint32_t kC2 = 0x1b873593u;
constexpr uint32_t kMixC = 0xe6546b64u;

__device__ __forceinline__ uint32_t ror32(uint32_t v, int s) {
  return (v >> s) | (v << (32 - s));
}

__device__ __forceinline__ uint32_t fmix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t mur(uint32_t a, uint32_t h) {
  a *= kC1;
  a = ror32(a, 17);
  a *= kC2;
  h ^= a;
  h = ror32(h, 19);
  return h * 5u + kMixC;
}

// little-endian word at byte offset idx of one row, clamped to [0, W-4]
__device__ __forceinline__ uint32_t fetch32(const uint8_t* row, int idx, int width) {
  idx = min(max(idx, 0), width - 4);
  return static_cast<uint32_t>(row[idx]) |
         (static_cast<uint32_t>(row[idx + 1]) << 8) |
         (static_cast<uint32_t>(row[idx + 2]) << 16) |
         (static_cast<uint32_t>(row[idx + 3]) << 24);
}

__device__ uint32_t hash_0_4(const uint8_t* row, int len, int width) {
  uint32_t b = 0, c = 9;
  const int lim = width < 4 ? width : 4;
  for (int i = 0; i < lim; ++i) {
    if (len > i) {
      // signed char semantics: bytes >= 0x80 enter as negative values
      const uint32_t v = static_cast<uint32_t>(
          static_cast<int32_t>(static_cast<int8_t>(row[i])));
      b = b * kC1 + v;
      c ^= b;
    }
  }
  return fmix(mur(b, mur(static_cast<uint32_t>(len), c)));
}

__device__ uint32_t hash_5_12(const uint8_t* row, int len, int width) {
  const uint32_t ln = static_cast<uint32_t>(len);
  const uint32_t a = ln + fetch32(row, 0, width);
  const uint32_t b = ln * 5u + fetch32(row, len - 4, width);
  const uint32_t c = 9u + fetch32(row, (len >> 1) & 4, width);
  const uint32_t d = ln * 5u;
  return fmix(mur(c, mur(b, mur(a, d))));
}

__device__ uint32_t hash_13_24(const uint8_t* row, int len, int width) {
  const uint32_t ln = static_cast<uint32_t>(len);
  uint32_t a = fetch32(row, (len >> 1) - 4, width);
  const uint32_t b = fetch32(row, 4, width);
  const uint32_t c = fetch32(row, len - 8, width);
  const uint32_t d = fetch32(row, len >> 1, width);
  const uint32_t e = fetch32(row, 0, width);
  const uint32_t f = fetch32(row, len - 4, width);
  uint32_t h = d * kC1 + ln;
  a = ror32(a, 12) + f;
  h = mur(c, h) + a;
  a = ror32(a, 3) + c;
  h = mur(e, h) + a;
  a = ror32(a + f, 12) + d;
  h = mur(b, h) + a;
  return fmix(h);
}

__device__ __forceinline__ uint32_t tail_word(const uint8_t* row, int idx, int width) {
  return ror32(fetch32(row, idx, width) * kC1, 17) * kC2;
}

__device__ uint32_t hash_gt_24(const uint8_t* row, int len, int width) {
  const uint32_t ln = static_cast<uint32_t>(len);
  const uint32_t a0 = tail_word(row, len - 4, width);
  const uint32_t a1 = tail_word(row, len - 8, width);
  const uint32_t a2 = tail_word(row, len - 16, width);
  const uint32_t a3 = tail_word(row, len - 12, width);
  const uint32_t a4 = tail_word(row, len - 20, width);
  uint32_t h = ln;
  uint32_t g = kC1 * ln;
  uint32_t f = g;
  h = ror32(h ^ a0, 19) * 5u + kMixC;
  h = ror32(h ^ a2, 19) * 5u + kMixC;
  g = ror32(g ^ a1, 19) * 5u + kMixC;
  g = ror32(g ^ a3, 19) * 5u + kMixC;
  f = ror32(f + a4, 19) + 113u;
  // (len-1)/20 chunks, never past the row: (W-1)/20 chunks end inside it
  int iters = (len - 1) / 20;
  const int max_iters = (width - 1) / 20;
  if (iters > max_iters) iters = max_iters;
  for (int t = 0; t < iters; ++t) {
    const int off = 20 * t;
    const uint32_t a = fetch32(row, off, width);
    const uint32_t b = fetch32(row, off + 4, width);
    const uint32_t c = fetch32(row, off + 8, width);
    const uint32_t d = fetch32(row, off + 12, width);
    const uint32_t e = fetch32(row, off + 16, width);
    h = mur(d, h + a) + e;
    g = mur(c, g + b) + a;
    f = mur(b + e * kC1, f + c) + d;
    f += g;
    g += f;
  }
  g = ror32(g, 11) * kC1;
  g = ror32(g, 17) * kC1;
  f = ror32(f, 11) * kC1;
  f = ror32(f, 17) * kC1;
  h = ror32(h + g, 19) * 5u + kMixC;
  h = ror32(h, 17) * kC1;
  h = ror32(h + f, 19) * 5u + kMixC;
  h = ror32(h, 17) * kC1;
  return h;
}

__global__ void fingerprint32_kernel(const uint8_t* __restrict__ mat,
                                     const int32_t* __restrict__ lens,
                                     uint32_t* __restrict__ out,
                                     int64_t rows, int width) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const uint8_t* row = mat + r * width;
  const int len = lens[r];
  uint32_t h;
  if (len <= 4) {
    h = hash_0_4(row, len, width);
  } else if (len <= 12) {
    h = hash_5_12(row, len, width);
  } else if (len <= 24) {
    h = hash_13_24(row, len, width);
  } else {
    h = hash_gt_24(row, len, width);
  }
  out[r] = h;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream` and returns
// cudaGetLastError() as an int: 0 when the launch was accepted.
extern "C" int rp_fingerprint32(const void* mat, const void* lens, void* out,
                                long long rows, int width, void* stream) {
  if (rows <= 0) return 0;
  constexpr int kThreads = 256;
  const long long blocks = (rows + kThreads - 1) / kThreads;
  fingerprint32_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mat), static_cast<const int32_t*>(lens),
      static_cast<uint32_t*>(out), static_cast<int64_t>(rows), width);
  return static_cast<int>(cudaGetLastError());
}
