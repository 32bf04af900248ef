// Packed-plane kernels of the sim engines for Hopper (sm_90a): the bitwise
// row reduce (S1) and the per-row popcount (S2).
//
// What they compute.  A packed plane is uint32[N, W]: the K rumor slots of
// each of N nodes, 32 to a word (sim/packbits.py).
//   S1 rp_row_reduce:    out[c] = OP over the rows r of plane[r, c], OP in
//                        {OR, AND}; with a row mask (bool[N]) only the rows
//                        where it is set take part.  int32[N, W] (+ bool[N])
//                        -> int32[W].
//   S2 rp_popcount_rows: out[r] = sum over c of popcount(plane[r, c]).
//                        int32[N, W] -> int32[N].
// They replace no Pallas kernel: the JAX package leaves both to XLA
// (ringpop_tpu/sim/packbits.py, _tree_reduce_rows :181-205 and
// popcount_rows :126).  Torch has no popcount and no bitwise OR/AND
// reduction, so the plain PyTorch version of each is a chain of many
// launches; these are one launch each.
//
// What bounds them: bytes.  Each word of the plane is read once (plus one
// byte of mask per row, plus 4 bytes of count per row for S2), and the
// integer work per word is one or two instructions.  At the delta engine's
// N = 1,000,000, W = 4: S1 moves 16 MB (17 MB masked), S2 20 MB; at
// 3.35 TB/s that is 4.8 / 5.1 us and 6.0 us.
//
// Design.
//   S1: a grid over chunks of rows, at most 4 blocks of 256 threads per SM.
//   A row's W words are VEC-word elements (VEC = 4, 2 or 1: the widest that
//   divides W and the base's alignment), so at W = 4 a thread reads a whole
//   16-byte row in one load.  A block covers a tile of at most 256 element
//   columns (grid.y tiles wider planes); its threads form `lanes` rows of
//   `tcols` columns, so a warp reads consecutive elements of consecutive
//   rows.  Each thread folds every stride-th row into registers, four rows
//   in flight at a time; the block then combines its lanes (warp shuffles
//   and shared memory when tcols is a power of two up to 32, shared memory
//   otherwise) and merges its partial into `out` with one atomicOr /
//   atomicAnd per word.  `out` is pre-filled with the identity by the
//   wrapper.  Bitwise atomics commute, so the result does not depend on the
//   order in which blocks finish.  A masked-off row is loaded all the same
//   (no dependent load on the mask) and skipped in the fold.
//   S2: one thread per row, VEC-word loads, __popc per word, one int32
//   store; a grid-stride loop over at most 8 blocks per SM.
//
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct OrOp {
  static constexpr uint32_t kIdentity = 0u;
  static __device__ __forceinline__ uint32_t apply(uint32_t a, uint32_t b) { return a | b; }
  static __device__ __forceinline__ void merge(uint32_t* dst, uint32_t v) { atomicOr(dst, v); }
};

struct AndOp {
  static constexpr uint32_t kIdentity = 0xFFFFFFFFu;
  static __device__ __forceinline__ uint32_t apply(uint32_t a, uint32_t b) { return a & b; }
  static __device__ __forceinline__ void merge(uint32_t* dst, uint32_t v) { atomicAnd(dst, v); }
};

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

template <class Op, int VEC>
__global__ void __launch_bounds__(kThreads)
packbits_row_reduce(const uint32_t* __restrict__ plane, const uint8_t* __restrict__ rows,
                    long long n, int w, uint32_t* __restrict__ out) {
  const int cols = w / VEC;
  const int tile0 = blockIdx.y * kThreads;
  const int tcols = min(kThreads, cols - tile0);
  const int lanes = kThreads / tcols;
  const int tid = threadIdx.x;
  const int lane = tid / tcols;
  const int c = tid - lane * tcols;

  uint32_t acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = Op::kIdentity;

  if (lane < lanes) {
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
        if (keep[u]) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] = Op::apply(acc[i], v[u][i]);
        }
      }
    }
    for (; r < n; r += stride) {
      uint32_t v[VEC];
      load_words<VEC>(base + r * w, v);
      if (rows == nullptr || __ldg(rows + r) != 0) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = Op::apply(acc[i], v[i]);
      }
    }
  }

  __shared__ uint32_t part[kThreads * VEC];
  if (tcols <= 32 && (tcols & (tcols - 1)) == 0) {
    // a warp's threads with equal tid % tcols hold the same column
    for (int off = 16; off >= tcols; off >>= 1) {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[i] = Op::apply(acc[i], __shfl_xor_sync(0xFFFFFFFFu, acc[i], off));
    }
    const int warp = tid >> 5, wl = tid & 31;
    if (wl < tcols) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) part[(warp * tcols + wl) * VEC + i] = acc[i];
    }
    __syncthreads();
    if (tid < tcols) {  // warp 0: acc already holds its own partial
      for (int wp = 1; wp < kThreads / 32; ++wp) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = Op::apply(acc[i], part[(wp * tcols + tid) * VEC + i]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) part[tid * VEC + i] = acc[i];
    __syncthreads();
    if (tid < tcols) {
      for (int l = 1; l < lanes; ++l) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = Op::apply(acc[i], part[(l * tcols + tid) * VEC + i]);
      }
    }
  }
  if (tid < tcols) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) Op::merge(out + (long long)(tile0 + tid) * VEC + i, acc[i]);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
packbits_popcount_rows(const uint32_t* __restrict__ plane, long long n, int w, int* __restrict__ out) {
  const int cols = w / VEC;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x; r < n; r += stride) {
    const uint32_t* row = plane + r * w;
    int count = 0;
    for (int c = 0; c < cols; ++c) {
      uint32_t v[VEC];
      load_words<VEC>(row + c * VEC, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) count += __popc(v[i]);
    }
    out[r] = count;
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return sms;
}

template <class Op>
void launch_reduce(const uint32_t* plane, const uint8_t* rows, long long n, int w, int vec,
                   uint32_t* out, int sms, cudaStream_t stream) {
  const int cols = w / vec;
  const int lanes = kThreads / (cols < kThreads ? cols : kThreads);
  long long chunks = (n + lanes - 1) / lanes;
  const long long cap = 4LL * sms;
  const dim3 grid((unsigned)(chunks < cap ? chunks : cap), (unsigned)((cols + kThreads - 1) / kThreads));
  if (vec == 4)
    packbits_row_reduce<Op, 4><<<grid, kThreads, 0, stream>>>(plane, rows, n, w, out);
  else if (vec == 2)
    packbits_row_reduce<Op, 2><<<grid, kThreads, 0, stream>>>(plane, rows, n, w, out);
  else
    packbits_row_reduce<Op, 1><<<grid, kThreads, 0, stream>>>(plane, rows, n, w, out);
}

}  // namespace

// op: 0 = OR, 1 = AND.  rows: bool[n] or null.  out: int32[w], pre-filled
// with the op's identity.  vec: 4, 2 or 1, dividing w, with the plane's base
// aligned to 4 * vec bytes.  n >= 1, w >= 1.
extern "C" int rp_row_reduce(const void* plane, const void* rows, long long n, int w, int op,
                             int vec, void* out, void* stream) {
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  if ((vec != 1 && vec != 2 && vec != 4) || w % vec != 0 || n < 1) return (int)cudaErrorInvalidValue;
  const auto* p = static_cast<const uint32_t*>(plane);
  const auto* m = static_cast<const uint8_t*>(rows);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (op == 0)
    launch_reduce<OrOp>(p, m, n, w, vec, o, sms, s);
  else if (op == 1)
    launch_reduce<AndOp>(p, m, n, w, vec, o, sms, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// out: int32[n].  vec as for rp_row_reduce.  n >= 1, w >= 1.
extern "C" int rp_popcount_rows(const void* plane, long long n, int w, int vec, void* out,
                                void* stream) {
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  if ((vec != 1 && vec != 2 && vec != 4) || w % vec != 0 || n < 1) return (int)cudaErrorInvalidValue;
  const auto* p = static_cast<const uint32_t*>(plane);
  auto* o = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 8LL * sms;
  const unsigned grid = (unsigned)(blocks < cap ? blocks : cap);
  if (vec == 4)
    packbits_popcount_rows<4><<<grid, kThreads, 0, s>>>(p, n, w, o);
  else if (vec == 2)
    packbits_popcount_rows<2><<<grid, kThreads, 0, s>>>(p, n, w, o);
  else
    packbits_popcount_rows<1><<<grid, kThreads, 0, s>>>(p, n, w, o);
  return (int)cudaGetLastError();
}
