// Grouped scan + per-tile top-m groups on Hopper's tensor cores (sm_90a).
//
// Replaces all three branches of the Pallas kernel body
// cqs_tpu/ops/topk.py::_scan_kernel_grouped (topk.py:183-255; branches
// :213-214 bf16 x bf16, :206-209 int8 x int8 -> int32, and :210-212 int8
// rows widened to bf16 against a bf16 query), reached through topk_pallas
// (pl.pallas_call at topk.py:145).
// Semantics, slot for slot: a tile of tile_n rows is folded into 128 group
// maxima (group lane g = rows g, 128+g, ...; masked rows are NEG; strict >,
// so a tie keeps the lower offset and a fully masked group offset 0); then
// m rounds take the lowest lane among the maxima, write its winning row and
// retire the group. Exhausted slots hold NEG and lane 0's winning row.
// Outputs are tile-major [num_tiles, B, m]; queries b >= B are not written.
//
// What bounds it: at B=128 on 1M x 1024 rows the scan is 275 GFLOP (or
// GOP) over 2 GiB (bf16) or 1 GiB (int8) of rows; read once, the int8 rows
// take 0.321 ms at 3.35 TB/s, the bf16 rows 0.641 ms. The CUDA-core kernels
// this replaces served 8 queries per CTA, so every row tile was read 16
// times at B=128, and did every multiply-add on CUDA cores (an f32 FMA, or
// a quarter __dp4a for int8 x int8). Here one CTA serves a query block of
// QB <= 64 queries (zero-padded past B), so a tile is read by at most two
// CTAs, and those two are adjacent in launch order (the query block is the
// fast grid index), so the second read mostly hits L2. What bounds it now
// is the work of each CTA, not the rows read from device memory (on an
// H100 B=64 takes half the time of B=128 at 1M x 1024): chiefly shared
// memory, where every warp reads the whole query block's B fragments, per
// 64-wide K-chunk about 80 KiB of operand reads against 24 KiB stored
// (bf16), or 40 KiB against 12 KiB (int8 x int8). wgmma, which reads its
// operands from shared memory once per warpgroup, is the next lever.
//
// Design: the score pass of scan_mma.cuh (8 warps, 128-row sub-tiles,
// rows and queries streamed along D through a cp.async ring, mma.sync on
// 16-byte fragment loads); its epilogue here folds each masked score into
// a running (max, offset) per owned (lane, query) in registers, so no score
// block exists. At the end the [QB, 128] maxima and byte offsets go to
// shared memory for the m selection rounds (G = 256 / QB threads a query,
// a shuffle reduction per round).
//
// Plain C ABI for ctypes: pointers and the stream as void*, returns a CUDA
// error code (0 = launched; cudaErrorInvalidValue for a query block, tile
// or shared-memory size the kernel does not take).

#include "scan_mma.cuh"

namespace {

using namespace cqs;

constexpr int kMaxSub = 256;         // winning offsets are kept in a byte

// Ring depth: 4 stages, two CTAs an SM. The int8 x int8 kernel at QB 8
// (B <= 8, solo queries) takes 6, the fastest at B=1 on an H100 (0.355
// against 0.381 ms with 4, 1M x 1024 rows, tile 2048); at QB 64, 4 stages
// beat both 3 stages with three CTAs an SM and 6 with one (PERF.md).
template <int KIND, int QB>
__host__ __device__ constexpr int ring_stages() {
  return KIND == kI8 && QB == 8 ? 6 : 4;
}

template <int KIND, int QB>
constexpr size_t mma_smem_bytes() {
  const size_t pipe = ring_stages<KIND, QB>() * stage_bytes<KIND, QB>();
  const size_t sel = (size_t)QB * kLanes * (sizeof(float) + 1);
  return pipe > sel ? pipe : sel;
}

// v with byte r replaced by the low byte of s
__device__ __forceinline__ uint32_t set_byte(uint32_t v, uint32_t s, int r) {
  return __byte_perm(v, s, r == 0 ? 0x3214u : r == 1 ? 0x3240u : r == 2 ? 0x3410u : 0x4210u);
}

// The grouped epilogue: each owned (lane, query) score folds into a running
// (max, sub-tile) in registers; strict >, so a tie keeps the lower offset.
template <int NT>
struct GroupFold {
  float gmax[NT][4];
  uint32_t offs[NT];  // byte r of offs[j]: the sub-tile of gmax[j][r]

  __device__ __forceinline__ GroupFold() {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      offs[j] = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r) gmax[j][r] = kNeg;
    }
  }
  __device__ __forceinline__ void score(int s, int j, int r, float v) {
    if (v > gmax[j][r]) {
      gmax[j][r] = v;
      offs[j] = set_byte(offs[j], (uint32_t)s, r);
    }
  }
  __device__ __forceinline__ void done(int) {}
};

template <int KIND, int QB>
__global__ void __launch_bounds__(kThreads, 2)
grouped_mma_kernel(const unsigned char* __restrict__ q,     // [B, D] bf16 bits or int8
                   const unsigned char* __restrict__ rows,  // [N, D] bf16 or int8
                   const int* __restrict__ mask,            // [N]
                   float* __restrict__ out_v,               // [tiles, B, m]
                   int* __restrict__ out_i,                 // [tiles, B, m]
                   int B, int D, int tile_n, int m, int nqb) {
  constexpr int NT = QB / 8;                   // n-tiles of 8 queries
  extern __shared__ __align__(128) unsigned char smem[];

  const int tile = blockIdx.x / nqb;
  const int b0 = (blockIdx.x % nqb) * QB;
  const int tid = threadIdx.x;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int la = (tid / 32) * 16 + g;
  const size_t row0 = (size_t)tile * tile_n;

  GroupFold<NT> fold;
  score_pass<KIND, QB, ring_stages<KIND, QB>()>(q, rows, mask, B, D, b0, row0, tile_n / kSub,
                                                smem, fold);
  cp_async_wait<0>();
  __syncthreads();
  float (&gmax)[NT][4] = fold.gmax;
  uint32_t (&offs)[NT] = fold.offs;

  // [QB, 128] group maxima and winning offsets, over the ring
  float* smax = reinterpret_cast<float*>(smem);
  unsigned char* ssel = smem + (size_t)QB * kLanes * sizeof(float);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = j * 8 + 2 * t + (r & 1);
      const int lane = la + (r < 2 ? 0 : 8);
      smax[qi * kLanes + lane] = gmax[j][r];
      ssel[qi * kLanes + lane] = (unsigned char)(offs[j] >> (8 * r));
    }
  }
  __syncthreads();

  // selection: G threads per query, G <= 32, so a group is inside a warp
  constexpr int G = kThreads / QB;
  static_assert(G >= 1 && G <= 32, "a query's selection group fits in a warp");
  const int qi = tid / G;
  const int gt = tid % G;
  float* sv = smax + qi * kLanes;
  float bv;
  int bi;
  local_best(sv, kLanes, gt, G, bv, bi);
  const int b = b0 + qi;
  const size_t out0 = ((size_t)tile * B + b) * m;
  for (int round = 0; round < m; ++round) {
    float mv = bv;
    int mi = bi;
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, mv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, mi, off);
      if (better(ov, oi, mv, mi)) {
        mv = ov;
        mi = oi;
      }
    }
    if (gt == 0 && b < B) {
      out_v[out0 + round] = mv;
      out_i[out0 + round] = (int)row0 + ssel[qi * kLanes + mi] * kLanes + mi;
    }
    if (mi % G == gt) {  // owner retires the group and rescans its share
      sv[mi] = kNeg;
      local_best(sv, kLanes, gt, G, bv, bi);
    }
  }
}

template <int KIND, int QB>
int launch(const void* q, const void* rows, const void* mask, void* vals, void* inds, int B,
           int N, int D, int tile_n, int m, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<KIND, QB>();
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)limit || tile_n % kSub || tile_n / kSub > kMaxSub || N % tile_n)
    return (int)cudaErrorInvalidValue;
  auto kernel = grouped_mma_kernel<KIND, QB>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nqb = (B + QB - 1) / QB;
  kernel<<<(N / tile_n) * nqb, kThreads, smem, stream>>>(
      static_cast<const unsigned char*>(q), static_cast<const unsigned char*>(rows),
      static_cast<const int*>(mask), static_cast<float*>(vals), static_cast<int*>(inds), B, D,
      tile_n, m, nqb);
  return (int)cudaGetLastError();
}

template <int KIND>
int dispatch(const void* q, const void* rows, const void* mask, void* vals, void* inds, int B,
             int N, int D, int tile_n, int m, int qb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (qb) {
    case 64: return launch<KIND, 64>(q, rows, mask, vals, inds, B, N, D, tile_n, m, s);
    case 32: return launch<KIND, 32>(q, rows, mask, vals, inds, B, N, D, tile_n, m, s);
    case 16: return launch<KIND, 16>(q, rows, mask, vals, inds, B, N, D, tile_n, m, s);
    case 8: return launch<KIND, 8>(q, rows, mask, vals, inds, B, N, D, tile_n, m, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int cqs_scan_topk_grouped_bf16(const void* q, const void* rows, const void* mask, void* vals,
                               void* inds, int B, int N, int D, int tile_n, int m, int qb,
                               void* stream) {
  return dispatch<kBf16>(q, rows, mask, vals, inds, B, N, D, tile_n, m, qb, stream);
}

int cqs_scan_topk_grouped_i8(const void* q, const void* rows, const void* mask, void* vals,
                             void* inds, int B, int N, int D, int tile_n, int m, int qb,
                             void* stream) {
  return dispatch<kI8>(q, rows, mask, vals, inds, B, N, D, tile_n, m, qb, stream);
}

int cqs_scan_topk_grouped_i8w(const void* q, const void* rows, const void* mask, void* vals,
                              void* inds, int B, int N, int D, int tile_n, int m, int qb,
                              void* stream) {
  return dispatch<kI8Widen>(q, rows, mask, vals, inds, B, N, D, tile_n, m, qb, stream);
}

}  // extern "C"
