// FarmHash Fingerprint32 (farmhashmk::Hash32) of B byte strings on Hopper.
//
// Replaces ringpop_tpu/ops/hash_pallas.py::_mix_kernel (the Pallas kernel
// behind fingerprint32_pallas) together with the XLA work around it: the
// <=24-byte length classes and the five tail fetches of the >24 path.  One
// thread hashes one key row end to end — length class, tail fetches, the
// (len-1)/20 mixing iterations and the finalizer — in registers, and writes
// the zero-extended uint32 hash as int64 itself.
//
// Bound: device-memory bytes.  The kernel reads the key matrix (B*W bytes)
// and the lengths (4B or 8B) and writes the hashes (8B); a key costs about a
// hundred integer operations, far below the card's integer rate.
//
// The first version read each word as 4 byte loads straight from device
// memory, one thread per row: neighbouring threads read addresses W bytes
// apart, so every warp-wide byte load touched a dozen cache lines for 32
// useful bytes, and the kernel was bound by load instructions and L1
// wavefronts rather than by device memory.  This version:
//
// - Tiles.  A block hashes T rows at a time (T a multiple of 32, one thread
//   per row).  Rows are contiguous, so a tile is one contiguous span of
//   T*W bytes of the matrix, and T*W is a multiple of 16.
// - Asynchronous staging.  The span is copied into shared memory with
//   cp.async.cg, 16 bytes per thread per instruction: a warp moves 512
//   contiguous bytes per instruction, coalesced, through L2 only.  It is
//   cp.async rather than one TMA bulk copy because the staged span is
//   skewed (below), which a single bulk copy cannot lay out.
// - A pipeline.  The grid is persistent (as many blocks as fit on the SMs,
//   each walking tiles blockIdx.x, +gridDim.x, ...) and each block keeps a
//   ring of two buffers: the copy of its next tile is in flight while a
//   tile is hashed (one buffer where W is so wide that two do not fit).  cp.async groups order the ring, and a
//   block barrier guards a buffer before it is refilled.  The lengths of
//   the block's next tile are loaded into registers while this one is
//   hashed.
// - Words from shared memory.  A little-endian word at any byte offset is
//   built from the two aligned 32-bit words that hold it and one
//   __funnelshift_r, not from 4 byte loads; the mixing loop and the five
//   tail words read consecutive words, so each aligned word is loaded once.
// - Bank skew.  Row r starts W bytes after row r-1 in shared memory; for W a
//   multiple of 16 every row of a warp would start in the same few banks
//   (32-way at W = 128).  The staged span gets a 16-byte pad after every
//   2^pad_shift 16-byte chunks, which the wrapper chooses per W
//   (hash_kernel.pad_shift) to spread a warp's rows over the banks.
// - Ragged edges.  A matrix whose base is not 16-byte aligned (a view at a
//   storage offset) is staged from the aligned-down address: chunks wholly
//   inside the tensor go by cp.async, the at most 15 + 15 bytes of a span's
//   head and tail chunk by ordinary byte loads, so nothing outside the
//   tensor's bytes is read.  The last tile masks with row < B.
// - Wide rows.  When not even a 32-row stage fits in shared memory the
//   wrapper launches fingerprint32_wide instead: the first version's
//   design, one thread per row hashing straight from device memory with
//   byte loads.
//
// Semantics kept bit for bit with the plain version: every dynamic byte
// offset is clamped to [0, W-4], the mixing loop is capped at (W-1)/20
// iterations, and the 0-4 class reads bytes as signed chars.
//
// Layout: mat is uint8[B, W] row-major, W >= 4, at any address.  lens is
// int32[B] or int64[B].  out is int64[B] holding uint32 values.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kC1 = 0xcc9e2d51u;
constexpr uint32_t kC2 = 0x1b873593u;
constexpr uint32_t kMixC = 0xe6546b64u;
constexpr int kMaxThreads = 256;

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

__device__ __forceinline__ int clamp_idx(int idx, int width) {
  return min(max(idx, 0), width - 4);
}

// One row in device memory (the wide route): words from 4 byte loads.
struct GlobalRow {
  const uint8_t* row;
  int width;

  __device__ __forceinline__ uint32_t at(int idx) const {  // idx in [0, W-4]
    return static_cast<uint32_t>(row[idx]) |
           (static_cast<uint32_t>(row[idx + 1]) << 8) |
           (static_cast<uint32_t>(row[idx + 2]) << 16) |
           (static_cast<uint32_t>(row[idx + 3]) << 24);
  }
  __device__ __forceinline__ uint32_t word(int idx) const {
    return at(clamp_idx(idx, width));
  }

  // consecutive words from row offset idx on (the caller keeps them in
  // [0, W-4])
  struct Stream {
    const GlobalRow& r;
    int idx;
    __device__ __forceinline__ uint32_t next() {
      const uint32_t v = r.at(idx);
      idx += 4;
      return v;
    }
  };
  __device__ __forceinline__ Stream stream(int idx) const { return Stream{*this, idx}; }
};

// One row staged in shared memory.  `base` is the row's first byte as a
// logical offset into the stage (the stage before skewing); logical word k
// lies at physical word k + 4 * (k >> pad_shift >> 2).
struct SharedRow {
  const uint32_t* stage;
  int base;
  int width;
  int pad_shift;  // log2 of the 16-byte chunks between two pads

  __device__ __forceinline__ uint32_t aligned(int k) const {
    return stage[k + (((k >> 2) >> pad_shift) << 2)];
  }
  __device__ __forceinline__ uint32_t at(int idx) const {  // idx in [0, W-4]
    const int x = base + idx;
    const int k = x >> 2;
    return __funnelshift_r(aligned(k), aligned(k + 1), (x & 3) * 8);
  }
  __device__ __forceinline__ uint32_t word(int idx) const {
    return at(clamp_idx(idx, width));
  }

  struct Stream {
    const SharedRow& r;
    int k;
    int shift;
    uint32_t cur;
    __device__ __forceinline__ uint32_t next() {
      const uint32_t nxt = r.aligned(++k);
      const uint32_t v = __funnelshift_r(cur, nxt, shift);
      cur = nxt;
      return v;
    }
  };
  __device__ __forceinline__ Stream stream(int idx) const {
    const int x = base + idx;
    return Stream{*this, x >> 2, (x & 3) * 8, aligned(x >> 2)};
  }
};

template <typename Row>
__device__ uint32_t hash_0_4(const Row& row, int len) {
  // bytes 0-3 of the row (W >= 4), entering as signed chars
  const uint32_t w = row.at(0);
  uint32_t b = 0, c = 9;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (len > i) {
      const uint32_t v = static_cast<uint32_t>(
          static_cast<int32_t>(static_cast<int8_t>(w >> (8 * i))));
      b = b * kC1 + v;
      c ^= b;
    }
  }
  return fmix(mur(b, mur(static_cast<uint32_t>(len), c)));
}

template <typename Row>
__device__ uint32_t hash_5_12(const Row& row, int len) {
  const uint32_t ln = static_cast<uint32_t>(len);
  const uint32_t a = ln + row.at(0);
  const uint32_t b = ln * 5u + row.word(len - 4);
  const uint32_t c = 9u + row.word((len >> 1) & 4);
  const uint32_t d = ln * 5u;
  return fmix(mur(c, mur(b, mur(a, d))));
}

template <typename Row>
__device__ uint32_t hash_13_24(const Row& row, int len) {
  const uint32_t ln = static_cast<uint32_t>(len);
  uint32_t a = row.word((len >> 1) - 4);
  const uint32_t b = row.word(4);
  const uint32_t c = row.word(len - 8);
  const uint32_t d = row.word(len >> 1);
  const uint32_t e = row.at(0);
  const uint32_t f = row.word(len - 4);
  uint32_t h = d * kC1 + ln;
  a = ror32(a, 12) + f;
  h = mur(c, h) + a;
  a = ror32(a, 3) + c;
  h = mur(e, h) + a;
  a = ror32(a + f, 12) + d;
  h = mur(b, h) + a;
  return fmix(h);
}

__device__ __forceinline__ uint32_t tail_word(uint32_t w) {
  return ror32(w * kC1, 17) * kC2;
}

template <typename Row>
__device__ uint32_t hash_gt_24(const Row& row, int len, int width) {
  const uint32_t ln = static_cast<uint32_t>(len);
  uint32_t a0, a1, a2, a3, a4;
  if (len <= width) {
    // len-20 .. len-4 all lie in [0, W-4]: five consecutive words
    auto st = row.stream(len - 20);
    a4 = tail_word(st.next());
    a2 = tail_word(st.next());
    a3 = tail_word(st.next());
    a1 = tail_word(st.next());
    a0 = tail_word(st.next());
  } else {
    a0 = tail_word(row.word(len - 4));
    a1 = tail_word(row.word(len - 8));
    a2 = tail_word(row.word(len - 16));
    a3 = tail_word(row.word(len - 12));
    a4 = tail_word(row.word(len - 20));
  }
  uint32_t h = ln;
  uint32_t g = kC1 * ln;
  uint32_t f = g;
  h = ror32(h ^ a0, 19) * 5u + kMixC;
  h = ror32(h ^ a2, 19) * 5u + kMixC;
  g = ror32(g ^ a1, 19) * 5u + kMixC;
  g = ror32(g ^ a3, 19) * 5u + kMixC;
  f = ror32(f + a4, 19) + 113u;
  // (len-1)/20 chunks, never past the row: (W-1)/20 chunks end inside it,
  // so the loop's offsets 0 .. 20*iters-4 need no clamp
  int iters = (len - 1) / 20;
  const int max_iters = (width - 1) / 20;
  if (iters > max_iters) iters = max_iters;
  auto st = row.stream(0);
  for (int t = 0; t < iters; ++t) {
    const uint32_t a = st.next();
    const uint32_t b = st.next();
    const uint32_t c = st.next();
    const uint32_t d = st.next();
    const uint32_t e = st.next();
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

template <typename Row>
__device__ __forceinline__ uint32_t hash_row(const Row& row, int len, int width) {
  if (len <= 4) return hash_0_4(row, len);
  if (len <= 12) return hash_5_12(row, len);
  if (len <= 24) return hash_13_24(row, len);
  return hash_gt_24(row, len, width);
}

__device__ __forceinline__ void cp_async16(uint32_t smem_addr, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage tile `tile` (if it exists) into the buffer at `stage`: the chunks of
// its span that lie wholly inside the tensor by cp.async (uncommitted: the
// caller commits), the head and tail bytes by ordinary loads.  Logical byte
// L of the stage is global byte mat - a + s + L, where s = tile*T*W is a
// multiple of 16 and a = mat mod 16.
__device__ __forceinline__ void stage_tile(uint8_t* stage, const uint8_t* mat, int a,
                                           int64_t tile, int64_t n_tiles, int64_t total,
                                           int64_t tile_bytes, int pad_shift) {
  if (tile >= n_tiles) return;
  const int64_t s = tile * tile_bytes;
  const int span = static_cast<int>(min(tile_bytes, total - s));  // bytes [s, s+span)
  const int end = a + span;                                         // logical end
  const int c_begin = (a + 15) >> 4;
  const int c_end = max(end >> 4, c_begin);
  const uint8_t* src = mat - a + s;  // logical byte 0 (dereferenced only in [a, end))
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(stage));
  for (int c = c_begin + threadIdx.x; c < c_end; c += blockDim.x) {
    cp_async16(dst + 16u * static_cast<uint32_t>(c + (c >> pad_shift)), src + 16 * c);
  }
  // head bytes [a, min(16*c_begin, end)) and tail bytes [16*c_end, end)
  const int head = min(16 * c_begin, end) - a;
  const int tail_from = max(16 * c_end, a + head);
  const int j = threadIdx.x;
  int L = -1;
  if (j < head) {
    L = a + j;
  } else if (j >= 16 && tail_from + (j - 16) < end) {
    L = tail_from + (j - 16);
  }
  if (L >= 0) stage[L + 16 * ((L >> 4) >> pad_shift)] = src[L];
}

template <typename LenT>
__global__ void __launch_bounds__(kMaxThreads)
    fingerprint32_staged(const uint8_t* __restrict__ mat, const LenT* __restrict__ lens,
                         int64_t* __restrict__ out, int64_t rows, int width, int stages,
                         int stage_bytes, int pad_shift) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int T = blockDim.x;
  const int64_t tile_bytes = static_cast<int64_t>(T) * width;
  const int64_t total = rows * width;
  const int64_t n_tiles = (rows + T - 1) / T;
  const int a = static_cast<int>(reinterpret_cast<uintptr_t>(mat) & 15);
  const int64_t first = blockIdx.x;
  const int64_t step = gridDim.x;

  // prologue: the block's first stages-1 tiles in flight, one group each
  for (int i = 0; i < stages - 1; ++i) {
    stage_tile(smem + i * stage_bytes, mat, a, first + i * step, n_tiles, total, tile_bytes,
               pad_shift);
    cp_async_commit();
  }
  int64_t row = first * T + threadIdx.x;
  int len = row < rows ? static_cast<int>(lens[row]) : 0;
  int slot = 0;
  for (int64_t tile = first; tile < n_tiles; tile += step) {
    // refill the buffer that the previous tile used (guarded by the barrier
    // at the end of the last iteration) with the tile stages-1 ahead
    const int refill = slot == 0 ? stages - 1 : slot - 1;
    stage_tile(smem + refill * stage_bytes, mat, a, tile + (stages - 1) * step, n_tiles, total,
               tile_bytes, pad_shift);
    cp_async_commit();
    const int64_t next_row = row + step * T;
    const int next_len = next_row < rows ? static_cast<int>(lens[next_row]) : 0;
    // at most stages-1 groups pending: this tile's copies have landed
    if (stages == 1) {
      cp_async_wait<0>();
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();
    if (row < rows) {
      const SharedRow r{reinterpret_cast<const uint32_t*>(smem + slot * stage_bytes),
                        a + static_cast<int>(threadIdx.x) * width, width, pad_shift};
      out[row] = static_cast<int64_t>(hash_row(r, len, width));
    }
    __syncthreads();
    row = next_row;
    len = next_len;
    slot = slot + 1 == stages ? 0 : slot + 1;
  }
  cp_async_wait<0>();
}

template <typename LenT>
__global__ void __launch_bounds__(kMaxThreads)
    fingerprint32_wide(const uint8_t* __restrict__ mat, const LenT* __restrict__ lens,
                       int64_t* __restrict__ out, int64_t rows, int width) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const GlobalRow row{mat + r * width, width};
  out[r] = static_cast<int64_t>(hash_row(row, static_cast<int>(lens[r]), width));
}

template <typename LenT>
int launch_staged(const void* mat, const void* lens, void* out, long long rows, int width,
                  int rows_per_tile, int stages, int smem_bytes, int pad_shift,
                  cudaStream_t stream) {
  auto kernel = fingerprint32_staged<LenT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, rows_per_tile,
                                                           smem_bytes)) != cudaSuccess)
    return static_cast<int>(err);
  const long long n_tiles = (rows + rows_per_tile - 1) / rows_per_tile;
  long long blocks = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > n_tiles) blocks = n_tiles;
  kernel<<<static_cast<unsigned int>(blocks), rows_per_tile, smem_bytes, stream>>>(
      static_cast<const uint8_t*>(mat), static_cast<const LenT*>(lens),
      static_cast<int64_t*>(out), static_cast<int64_t>(rows), width, stages,
      smem_bytes / stages, pad_shift);
  return static_cast<int>(cudaGetLastError());
}

template <typename LenT>
int launch_wide(const void* mat, const void* lens, void* out, long long rows, int width,
                cudaStream_t stream) {
  const long long blocks = (rows + kMaxThreads - 1) / kMaxThreads;
  fingerprint32_wide<LenT><<<static_cast<unsigned int>(blocks), kMaxThreads, 0, stream>>>(
      static_cast<const uint8_t*>(mat), static_cast<const LenT*>(lens),
      static_cast<int64_t*>(out), static_cast<int64_t>(rows), width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream` and
// returns a cudaError_t as an int: 0 when the launch was accepted.
// rows_per_tile (a multiple of 32, at most 256), stages (1 or 2), smem_bytes
// (stages equal buffers, each a multiple of 16) and pad_shift come from
// hash_kernel.plan_tiles / hash_kernel.pad_shift.
extern "C" int rp_fingerprint32_staged(const void* mat, const void* lens, int lens_is_64,
                                       void* out, long long rows, int width, int rows_per_tile,
                                       int stages, int smem_bytes, int pad_shift,
                                       void* stream) {
  if (rows <= 0) return 0;
  if (rows_per_tile < 32 || rows_per_tile > kMaxThreads || rows_per_tile % 32 != 0 ||
      stages < 1 || stages > 2 || smem_bytes % (16 * stages) != 0 || width < 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return lens_is_64 ? launch_staged<int64_t>(mat, lens, out, rows, width, rows_per_tile, stages,
                                             smem_bytes, pad_shift, s)
                    : launch_staged<int32_t>(mat, lens, out, rows, width, rows_per_tile, stages,
                                             smem_bytes, pad_shift, s);
}

extern "C" int rp_fingerprint32_wide(const void* mat, const void* lens, int lens_is_64, void* out,
                                     long long rows, int width, void* stream) {
  if (rows <= 0) return 0;
  if (width < 4) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return lens_is_64 ? launch_wide<int64_t>(mat, lens, out, rows, width, s)
                    : launch_wide<int32_t>(mat, lens, out, rows, width, s);
}
