// Fused exact scan + per-tile top-m for Hopper (sm_90a), bf16 rows.
//
// Replaces the two Pallas kernel bodies reached through
// cqs_tpu/ops/topk.py::topk_pallas (pl.pallas_call at topk.py:145):
//   - _scan_kernel          ("loop",    topk.py:58-108)
//   - _scan_kernel_grouped  ("grouped", topk.py:183-255)
// For each logical row tile of tile_n rows and each query they compute
// scores = q . rows^T (bf16 x bf16 products, f32 accumulation), set masked
// rows to NEG, and reduce the tile to m (value, global row) slots:
//   loop:    m rounds of (row max -> lowest column among the maxima ->
//            retire that column to NEG); once only NEG is left, every later
//            round writes NEG with the lowest column (the reference's slot
//            contents past a tile's valid rows).
//   grouped: fold the tile into 128 group maxima (group g = columns g,
//            128+g, ...; strict > so the lower offset keeps a tie), then m
//            rounds over the groups (lowest lane among the maxima), each
//            writing the group's winning column and retiring the group.
// Outputs are tile-major [num_tiles, B, m], as the reference's.
//
// What bounds it on the card: the score pass reads N*D*2 bytes of rows
// (plus N*4 of mask) once per query block; at B=1 that is all the work and
// the kernel is memory-bound (a 1M x 1024 bf16 sketch is 2 GB). The design
// keeps the [qb, tile_n] f32 score block in shared memory, so no score ever
// reaches device memory, and serves qb <= 8 queries per CTA so a row tile is
// read once per query block rather than once per query. Each warp keeps 4
// rows' 16-byte loads in flight. The selection rounds run on shared memory
// with each thread caching the best of the columns it owns, so a round costs
// one group reduction plus one owner rescan. No tensor cores, TMA or
// pipelining yet: those are later optimisations.
//
// Plain C ABI for ctypes: pointers and the stream as void*, returns
// cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerIter = 4;
constexpr int kLanes = 128;  // grouped extraction width
constexpr float kNeg = -3.0e38f;

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

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

// Best (value, column) among the columns j = gt, gt+G, ... < L of s.
__device__ __forceinline__ void local_best(const float* s, int L, int gt, int G,
                                           float& v, int& i) {
  v = -INFINITY;
  i = 0x7fffffff;
  for (int j = gt; j < L; j += G) {
    if (better(s[j], j, v, i)) {
      v = s[j];
      i = j;
    }
  }
}

template <int QB, bool GROUPED>
__global__ void __launch_bounds__(kThreads)
scan_topk_kernel(const uint16_t* __restrict__ q,      // [B, D] bf16 bits
                 const uint4* __restrict__ rows,      // [N, D] bf16, 8 per uint4
                 const int* __restrict__ mask,        // [N]
                 float* __restrict__ out_v,           // [tiles, B, m]
                 int* __restrict__ out_i,             // [tiles, B, m]
                 int B, int D, int tile_n, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);              // [QB, D]
  float* sc = qs + QB * D;                                 // [QB, tile_n]
  int* ssel = reinterpret_cast<int*>(sc + QB * tile_n);    // [QB, 128]
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];

  const int t = blockIdx.x;
  const int b0 = blockIdx.y * QB;
  const int nvec = D / 8;

  // query block -> shared f32 (zero rows past B)
  for (int e = threadIdx.x; e < QB * D; e += kThreads) {
    const int qi = e / D;
    const int b = b0 + qi;
    qs[e] = b < B ? __uint_as_float(static_cast<uint32_t>(q[(size_t)b * D + e % D]) << 16)
                  : 0.0f;
  }
  __syncthreads();

  // score pass: warp w takes rows w*4 .. w*4+3, then strides by 32 rows
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t row0 = (size_t)t * tile_n;
  const int* mtile = mask + row0;
  for (int r0 = warp * kRowsPerIter; r0 < tile_n; r0 += kWarps * kRowsPerIter) {
    float acc[kRowsPerIter][QB];
#pragma unroll
    for (int rr = 0; rr < kRowsPerIter; ++rr)
#pragma unroll
      for (int qi = 0; qi < QB; ++qi) acc[rr][qi] = 0.0f;
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
        for (int qi = 0; qi < QB; ++qi) acc[rr][qi] += dot8(x[rr], qs + qi * D + v * 8);
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerIter; ++rr) {
      const int r = r0 + rr;
#pragma unroll
      for (int qi = 0; qi < QB; ++qi) {
        float a = acc[rr][qi];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
        if (lane == 0 && r < tile_n) sc[qi * tile_n + r] = mtile[r] > 0 ? a : kNeg;
      }
    }
  }
  __syncthreads();

  // selection: G threads per query of the block
  const int G = kThreads / QB;
  const int qi = threadIdx.x / G;
  const int gt = threadIdx.x % G;
  float* s = sc + qi * tile_n;
  int* sel = ssel + qi * kLanes;
  int L = tile_n;
  if (GROUPED) {
    const int gs = tile_n / kLanes;
    for (int g = gt; g < kLanes; g += G) {
      float gmax = kNeg;
      int best_s = 0;
      for (int k = 0; k < gs; ++k) {
        const float x = s[k * kLanes + g];
        if (x > gmax) {
          gmax = x;
          best_s = k;
        }
      }
      // lane g's columns are read only by this thread, so the group max can
      // overwrite column g in place
      s[g] = gmax;
      sel[g] = best_s;
    }
    L = kLanes;
    __syncthreads();  // sel[] is read by the group's writer thread below
  }
  float bv;
  int bi;
  local_best(s, L, gt, G, bv, bi);
  const int b = b0 + qi;
  const size_t out0 = ((size_t)t * B + b) * m;
  for (int round = 0; round < m; ++round) {
    float mv = bv;
    int mi = bi;
    group_argmax(mv, mi, G, red_v, red_i);
    if (gt == 0 && b < B) {
      out_v[out0 + round] = mv;
      out_i[out0 + round] = (int)row0 + (GROUPED ? sel[mi] * kLanes + mi : mi);
    }
    if (mi % G == gt) {  // owner retires the column and rescans its share
      s[mi] = kNeg;
      local_best(s, L, gt, G, bv, bi);
    }
  }
}

template <int QB, bool GROUPED>
int launch(const void* q, const void* rows, const void* mask, void* vals, void* inds,
           int B, int N, int D, int tile_n, int m, cudaStream_t stream) {
  const size_t smem = (size_t)QB * D * 4 + (size_t)QB * tile_n * 4 + (size_t)QB * kLanes * 4;
  auto kernel = scan_topk_kernel<QB, GROUPED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / tile_n, (B + QB - 1) / QB);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint4*>(rows),
      static_cast<const int*>(mask), static_cast<float*>(vals), static_cast<int*>(inds),
      B, D, tile_n, m);
  return (int)cudaGetLastError();
}

template <bool GROUPED>
int dispatch(const void* q, const void* rows, const void* mask, void* vals, void* inds,
             int B, int N, int D, int tile_n, int m, int qb, cudaStream_t stream) {
  switch (qb) {
    case 8: return launch<8, GROUPED>(q, rows, mask, vals, inds, B, N, D, tile_n, m, stream);
    case 4: return launch<4, GROUPED>(q, rows, mask, vals, inds, B, N, D, tile_n, m, stream);
    case 2: return launch<2, GROUPED>(q, rows, mask, vals, inds, B, N, D, tile_n, m, stream);
    case 1: return launch<1, GROUPED>(q, rows, mask, vals, inds, B, N, D, tile_n, m, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared memory bytes one CTA needs for a query block of qb.
size_t cqs_scan_smem_bytes(int qb, int D, int tile_n) {
  return (size_t)qb * D * 4 + (size_t)qb * tile_n * 4 + (size_t)qb * kLanes * 4;
}

int cqs_scan_topk_loop_bf16(const void* q, const void* rows, const void* mask,
                            void* vals, void* inds, int B, int N, int D,
                            int tile_n, int m, int qb, void* stream) {
  return dispatch<false>(q, rows, mask, vals, inds, B, N, D, tile_n, m, qb,
                         static_cast<cudaStream_t>(stream));
}

int cqs_scan_topk_grouped_bf16(const void* q, const void* rows, const void* mask,
                               void* vals, void* inds, int B, int N, int D,
                               int tile_n, int m, int qb, void* stream) {
  return dispatch<true>(q, rows, mask, vals, inds, B, N, D, tile_n, m, qb,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
