// Fused exact scan + per-tile top-m for Hopper (sm_90a), on CUDA cores.
//
// Replaces the Pallas kernel body cqs_tpu/ops/topk.py::_scan_kernel ("loop",
// topk.py:58-108), reached through topk_pallas (pl.pallas_call at
// topk.py:145), in the three branches the reference picks by the dtypes of
// rows and query (the grouped body, _scan_kernel_grouped, is the
// tensor-core kernel in scan_topk_mma.cu):
//   row kinds (template parameter KIND):
//   - kBf16:    bf16 rows x bf16 query, f32 products and sums
//               (topk.py:79-80);
//   - kI8:      int8 rows x int8 query -> int32 dot -> f32
//               (topk.py:69-75);
//   - kI8Widen: int8 rows widened exactly to f32 x bf16 query, f32 sums
//               (topk.py:76-78).
// For each logical row tile of tile_n rows and each query it computes the
// scores, sets masked rows to NEG, and reduces the tile to m (value, global
// row) slots by m rounds of (row max -> lowest column among the maxima ->
// retire that column to NEG); once only NEG is left, every later round
// writes NEG with the lowest column (the reference's slot contents past a
// tile's valid rows). Outputs are tile-major [num_tiles, B, m], as the
// reference's. Only the score pass depends on KIND.
//
// What bounds it on the card: the score pass reads N*D*(2 or 1) bytes of
// rows (plus N*4 of mask) once per query block; at B=1 that is all the work
// and the kernel is memory-bound (a 1M x 1024 bf16 sketch is 2 GB, its int8
// copy 1 GB). The design keeps the [qb, tile_n] f32 score block in shared
// memory, so no score ever reaches device memory, and serves qb <= 8
// queries per CTA so a row tile is read once per query block rather than
// once per query. Each warp keeps 4 rows' 16-byte loads in flight (8 bf16 or
// 16 int8 values a lane). int8 x int8 takes __dp4a against the query block
// kept packed in shared memory and sums in int32, so its scores are exact
// and independent of summation order; the f32 conversion happens once per
// score. The selection rounds run on shared memory with each thread caching
// the best of the columns it owns, so a round costs one group reduction plus
// one owner rescan. No tensor cores, TMA or pipelining here.
//
// Plain C ABI for ctypes: pointers and the stream as void*, returns
// cudaGetLastError() (0 = launched).

#include "scan_common.cuh"

namespace {

using namespace cqs;

constexpr int kRowsPerIter = 4;

__host__ __device__ constexpr int vec_elems(int kind) { return kind == kBf16 ? 8 : 16; }
// bytes of one query element in shared memory (int8 packed, else f32)
__host__ __device__ constexpr int q_bytes(int kind) { return kind == kI8 ? 1 : 4; }

size_t smem_bytes(int kind, int qb, int D, int tile_n) {
  return (size_t)qb * D * q_bytes(kind) + (size_t)qb * tile_n * 4;
}

template <int KIND>
struct Acc {
  using T = float;
};
template <>
struct Acc<kI8> {
  using T = int;
};

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, off);
    int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// (max, lowest index) over the G threads of one query group. Groups of more
// than one warp exchange through shared memory; every thread of the block
// calls this the same number of times, so the barriers are uniform.
__device__ __forceinline__ void group_argmax(float& v, int& i, int G,
                                             float* red_v, int* red_i) {
  warp_argmax(v, i);
  if (G <= 32) return;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  const int first = (threadIdx.x / G) * (G / 32);
  v = red_v[first];
  i = red_i[first];
  for (int w = 1; w < G / 32; ++w) {
    if (better(red_v[first + w], red_i[first + w], v, i)) {
      v = red_v[first + w];
      i = red_i[first + w];
    }
  }
  __syncthreads();
}

// 8 bf16 row values against 8 f32 query values.
__device__ __forceinline__ float dot8(uint4 x, const float* q) {
  const float4 qa = *reinterpret_cast<const float4*>(q);
  const float4 qb = *reinterpret_cast<const float4*>(q + 4);
  float acc = __uint_as_float(x.x << 16) * qa.x;
  acc = fmaf(__uint_as_float(x.x & 0xffff0000u), qa.y, acc);
  acc = fmaf(__uint_as_float(x.y << 16), qa.z, acc);
  acc = fmaf(__uint_as_float(x.y & 0xffff0000u), qa.w, acc);
  acc = fmaf(__uint_as_float(x.z << 16), qb.x, acc);
  acc = fmaf(__uint_as_float(x.z & 0xffff0000u), qb.y, acc);
  acc = fmaf(__uint_as_float(x.w << 16), qb.z, acc);
  acc = fmaf(__uint_as_float(x.w & 0xffff0000u), qb.w, acc);
  return acc;
}

// 4 signed bytes of w, widened exactly, against 4 f32 query values.
__device__ __forceinline__ float fma4_i8(uint32_t w, float4 q, float acc) {
  // shift the byte to the top, then an arithmetic shift sign-extends it
  acc = fmaf(__int2float_rn(static_cast<int>(w << 24) >> 24), q.x, acc);
  acc = fmaf(__int2float_rn(static_cast<int>(w << 16) >> 24), q.y, acc);
  acc = fmaf(__int2float_rn(static_cast<int>(w << 8) >> 24), q.z, acc);
  return fmaf(__int2float_rn(static_cast<int>(w) >> 24), q.w, acc);
}

// 16 int8 row values (widened) against 16 f32 query values.
__device__ __forceinline__ float dot16_widen(uint4 x, const float* q) {
  const float4* q4 = reinterpret_cast<const float4*>(q);
  float acc = fma4_i8(x.x, q4[0], 0.0f);
  acc = fma4_i8(x.y, q4[1], acc);
  acc = fma4_i8(x.z, q4[2], acc);
  return fma4_i8(x.w, q4[3], acc);
}

// 16 int8 row values against 16 packed int8 query values, summed in int32.
__device__ __forceinline__ int dot16_i8(uint4 x, const int8_t* q) {
  const int4 qq = *reinterpret_cast<const int4*>(q);
  int acc = __dp4a(static_cast<int>(x.x), qq.x, 0);
  acc = __dp4a(static_cast<int>(x.y), qq.y, acc);
  acc = __dp4a(static_cast<int>(x.z), qq.z, acc);
  return __dp4a(static_cast<int>(x.w), qq.w, acc);
}

template <int KIND>
__device__ __forceinline__ typename Acc<KIND>::T dot_vec(uint4 x, const unsigned char* qs,
                                                         size_t elem) {
  if constexpr (KIND == kI8) {
    return dot16_i8(x, reinterpret_cast<const int8_t*>(qs) + elem);
  } else if constexpr (KIND == kI8Widen) {
    return dot16_widen(x, reinterpret_cast<const float*>(qs) + elem);
  } else {
    return dot8(x, reinterpret_cast<const float*>(qs) + elem);
  }
}

template <int KIND, int QB>
__global__ void __launch_bounds__(kThreads)
scan_topk_kernel(const void* __restrict__ q,          // [B, D] bf16 bits or int8
                 const uint4* __restrict__ rows,      // [N, D], 16 bytes per uint4
                 const int* __restrict__ mask,        // [N]
                 float* __restrict__ out_v,           // [tiles, B, m]
                 int* __restrict__ out_i,             // [tiles, B, m]
                 int B, int D, int tile_n, int m) {
  using AccT = typename Acc<KIND>::T;
  constexpr int VE = vec_elems(KIND);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qs = smem;                                                // [QB, D]
  float* sc = reinterpret_cast<float*>(smem + (size_t)QB * D * q_bytes(KIND));  // [QB, tile_n]
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];

  const int t = blockIdx.x;
  const int b0 = blockIdx.y * QB;
  const int nvec = D / VE;

  // query block -> shared memory (zero rows past B): packed int8 for kI8,
  // f32 from bf16 bits otherwise
  for (int e = threadIdx.x; e < QB * D; e += kThreads) {
    const int b = b0 + e / D;
    const size_t src = (size_t)b * D + e % D;
    if constexpr (KIND == kI8) {
      reinterpret_cast<int8_t*>(qs)[e] = b < B ? static_cast<const int8_t*>(q)[src] : 0;
    } else {
      reinterpret_cast<float*>(qs)[e] =
          b < B ? __uint_as_float(static_cast<uint32_t>(static_cast<const uint16_t*>(q)[src]) << 16)
                : 0.0f;
    }
  }
  __syncthreads();

  // score pass: warp w takes rows w*4 .. w*4+3, then strides by 32 rows
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t row0 = (size_t)t * tile_n;
  const int* mtile = mask + row0;
  for (int r0 = warp * kRowsPerIter; r0 < tile_n; r0 += kWarps * kRowsPerIter) {
    AccT acc[kRowsPerIter][QB];
#pragma unroll
    for (int rr = 0; rr < kRowsPerIter; ++rr)
#pragma unroll
      for (int qi = 0; qi < QB; ++qi) acc[rr][qi] = 0;
    for (int v = lane; v < nvec; v += 32) {
      uint4 x[kRowsPerIter];
#pragma unroll
      for (int rr = 0; rr < kRowsPerIter; ++rr) {
        const int r = r0 + rr;
        x[rr] = r < tile_n ? rows[(row0 + r) * nvec + v] : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerIter; ++rr)
#pragma unroll
        for (int qi = 0; qi < QB; ++qi)
          acc[rr][qi] += dot_vec<KIND>(x[rr], qs, (size_t)qi * D + (size_t)v * VE);
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerIter; ++rr) {
      const int r = r0 + rr;
#pragma unroll
      for (int qi = 0; qi < QB; ++qi) {
        AccT a = acc[rr][qi];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
        float f;
        if constexpr (KIND == kI8) {
          f = __int2float_rn(a);  // the reference's int32 -> f32 cast
        } else {
          f = a;
        }
        if (lane == 0 && r < tile_n) sc[qi * tile_n + r] = mtile[r] > 0 ? f : kNeg;
      }
    }
  }
  __syncthreads();

  // selection: G threads per query of the block
  const int G = kThreads / QB;
  const int qi = threadIdx.x / G;
  const int gt = threadIdx.x % G;
  float* s = sc + qi * tile_n;
  float bv;
  int bi;
  local_best(s, tile_n, gt, G, bv, bi);
  const int b = b0 + qi;
  const size_t out0 = ((size_t)t * B + b) * m;
  for (int round = 0; round < m; ++round) {
    float mv = bv;
    int mi = bi;
    group_argmax(mv, mi, G, red_v, red_i);
    if (gt == 0 && b < B) {
      out_v[out0 + round] = mv;
      out_i[out0 + round] = (int)row0 + mi;
    }
    if (mi % G == gt) {  // owner retires the column and rescans its share
      s[mi] = kNeg;
      local_best(s, tile_n, gt, G, bv, bi);
    }
  }
}

template <int KIND, int QB>
int launch(const void* q, const void* rows, const void* mask, void* vals, void* inds,
           int B, int N, int D, int tile_n, int m, cudaStream_t stream) {
  const size_t smem = smem_bytes(KIND, QB, D, tile_n);
  auto kernel = scan_topk_kernel<KIND, QB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / tile_n, (B + QB - 1) / QB);
  kernel<<<grid, kThreads, smem, stream>>>(
      q, static_cast<const uint4*>(rows), static_cast<const int*>(mask),
      static_cast<float*>(vals), static_cast<int*>(inds), B, D, tile_n, m);
  return (int)cudaGetLastError();
}

template <int KIND>
int dispatch(const void* q, const void* rows, const void* mask, void* vals, void* inds,
             int B, int N, int D, int tile_n, int m, int qb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (qb) {
    case 8: return launch<KIND, 8>(q, rows, mask, vals, inds, B, N, D, tile_n, m, s);
    case 4: return launch<KIND, 4>(q, rows, mask, vals, inds, B, N, D, tile_n, m, s);
    case 2: return launch<KIND, 2>(q, rows, mask, vals, inds, B, N, D, tile_n, m, s);
    case 1: return launch<KIND, 1>(q, rows, mask, vals, inds, B, N, D, tile_n, m, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared memory bytes one CTA needs for a query block of qb over rows of
// the given kind (0 bf16, 1 int8 x int8, 2 int8 widened).
size_t cqs_scan_smem_bytes(int kind, int qb, int D, int tile_n) {
  return smem_bytes(kind, qb, D, tile_n);
}

#define CQS_SCAN_ENTRY(NAME, KIND)                                                         \
  int NAME(const void* q, const void* rows, const void* mask, void* vals, void* inds, int B, \
           int N, int D, int tile_n, int m, int qb, void* stream) {                        \
    return dispatch<KIND>(q, rows, mask, vals, inds, B, N, D, tile_n, m, qb, stream);       \
  }

CQS_SCAN_ENTRY(cqs_scan_topk_loop_bf16, kBf16)
CQS_SCAN_ENTRY(cqs_scan_topk_loop_i8, kI8)
CQS_SCAN_ENTRY(cqs_scan_topk_loop_i8w, kI8Widen)

}  // extern "C"
