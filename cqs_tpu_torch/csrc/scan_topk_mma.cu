// Grouped scan + per-tile top-m groups on Hopper's tensor cores (sm_90a).
//
// Replaces the bf16 and the int8-widened branches of the Pallas kernel body
// cqs_tpu/ops/topk.py::_scan_kernel_grouped (topk.py:183-255; branches
// :213-214 bf16 x bf16 and :210-212 int8 rows widened to bf16 against a
// bf16 query), reached through topk_pallas (pl.pallas_call at topk.py:145).
// Semantics, slot for slot: a tile of tile_n rows is folded into 128 group
// maxima (group lane g = rows g, 128+g, ...; masked rows are NEG; strict >,
// so a tie keeps the lower offset and a fully masked group offset 0); then
// m rounds take the lowest lane among the maxima, write its winning row and
// retire the group. Exhausted slots hold NEG and lane 0's winning row.
// Outputs are tile-major [num_tiles, B, m]; queries b >= B are not written.
//
// What bounds it: at B=128 on 1M x 1024 rows the scan is 275 GFLOP over
// 2 GiB (bf16) or 1 GiB (int8) of rows. The CUDA-core kernel this replaces
// served 8 queries per CTA, so every row tile was read 16 times, and did
// every multiply-add as an f32 FMA (plus, for int8, a conversion per query).
// Here one CTA serves a query block of QB <= 64 queries (zero-padded past
// B), so a tile is read by at most two CTAs, and those two are adjacent in
// launch order (the query block is the fast grid index), so the second read
// mostly hits L2. Scores come from mma.sync m16n8k16 bf16 -> f32. What bounds
// it now is the work of each CTA, not the rows read from device memory (on
// an H100 B=64 takes half the time of B=128 at 1M x 1024): chiefly shared
// memory, where every warp reads the whole query block's B fragments, about
// 80 KiB of operand reads per 64-wide K-chunk against 24 KiB stored. wgmma,
// which reads its operands from shared memory once per warpgroup, is the
// next lever.
//
// Design: 8 warps; the tile is walked in 128-row sub-tiles, sub-tile s holds
// row s*128 + g in group lane g, and warp w owns lanes 16w..16w+15 (the MMA's
// M) against all QB queries (N, QB/8 n-tiles). Rows (A) and queries (B)
// stream along D in 64-element K-chunks through a 4-stage ring of shared
// memory filled by cp.async (zero-fill past D and past B), so the next
// chunks load while the current one multiplies and shared memory stays
// bounded at every width. The dot product's K order is free, so each thread
// reads its A and B fragments as 16-byte vectors of neighbouring columns (no
// ldmatrix): thread (g, t) takes columns 8t..8t+7 (bf16) or 16t..16t+15
// (int8) of each 32- or 64-column slab, for rows g and g+8 and for query g
// of each n-tile; a per-row XOR swizzle of the 16-byte chunks keeps those
// reads free of bank conflicts. int8 row bytes become bf16 once per CTA, on
// their way into the A fragment (exact: |v| <= 128 has 8 significant bits).
// Each K-chunk's MMA sums are added into f32 sums once (the tensor cores'
// chained accumulation truncates; this keeps the error below the f32
// twin's). After a sub-tile's last chunk the f32 sums are masked and folded
// into a running (max, offset) per owned (lane, query) in registers; no
// score block exists. At the end the [QB, 128] maxima and byte offsets go
// to shared memory for the m selection rounds (G = 256 / QB threads a query,
// a shuffle reduction per round).
//
// Plain C ABI for ctypes: pointers and the stream as void*, returns a CUDA
// error code (0 = launched; cudaErrorInvalidValue for a query block, tile or
// shared-memory size the kernel does not take).

#include "scan_common.cuh"

namespace {

using namespace cqs;

constexpr int kSub = 128;            // rows per sub-tile: one per group lane
constexpr int kKC = 64;              // K elements per pipeline stage
constexpr int kStages = 4;
constexpr int kQRowBytes = kKC * 2;  // one query's bf16 K-chunk
constexpr int kMaxSub = 256;         // winning offsets are kept in a byte

// bytes of one row's K-chunk
template <int KIND>
__host__ __device__ constexpr int row_bytes() {
  return KIND == kBf16 ? kKC * 2 : kKC;
}

template <int KIND, int QB>
__host__ __device__ constexpr size_t stage_bytes() {
  return (size_t)kSub * row_bytes<KIND>() + (size_t)QB * kQRowBytes;
}

template <int KIND, int QB>
constexpr size_t mma_smem_bytes() {
  const size_t pipe = kStages * stage_bytes<KIND, QB>();
  const size_t sel = (size_t)QB * kLanes * (sizeof(float) + 1);
  return pipe > sel ? pipe : sel;
}

// 16-byte chunk c of row r as stored: bf16 rows (8 chunks a row) swap halves
// on odd rows; int8 rows (4 chunks, 64 bytes) need no swizzle.
template <int KIND>
__device__ __forceinline__ int row_chunk(int r, int c) {
  return KIND == kBf16 ? c ^ ((r & 1) << 2) : c;
}
// the same for query n's 8 chunks: the bf16 kernel reads chunk t of a half,
// the widening kernel the pair 2t, 2t+1
template <int KIND>
__device__ __forceinline__ int q_chunk(int n, int c) {
  return c ^ ((n & 1) * (KIND == kBf16 ? 4 : 1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint4 lds128(const unsigned char* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// D += A * B for one m16n8k16 tile, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Byte `sel & 3` of v (int8 values with the sign bit flipped, i.e. x + 128)
// as the exact f32 x: 2^23 + (x + 128) is built by placing the byte in the
// mantissa of 2^23, then 2^23 + 128 is subtracted.
__device__ __forceinline__ float biased_i8_to_f32(uint32_t v, uint32_t sel) {
  return __uint_as_float(__byte_perm(v, 0x4B00u, sel)) - 8388736.0f;
}

// Two signed bytes of w (bytes 0,1 if hi is false, else 2,3) as a bf16x2
// register, the lower byte in the lower half. Exact: the f32 values have 8
// significant bits, so their upper 16 bits are the bf16.
__device__ __forceinline__ uint32_t widen2(uint32_t biased, bool hi) {
  const float f0 = biased_i8_to_f32(biased, hi ? 0x5442u : 0x5440u);
  const float f1 = biased_i8_to_f32(biased, hi ? 0x5443u : 0x5441u);
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632u);
}

// v with byte r replaced by the low byte of s
__device__ __forceinline__ uint32_t set_byte(uint32_t v, uint32_t s, int r) {
  return __byte_perm(v, s, r == 0 ? 0x3214u : r == 1 ? 0x3240u : r == 2 ? 0x3410u : 0x4210u);
}

template <int KIND, int QB>
__global__ void __launch_bounds__(kThreads, 2)
grouped_mma_kernel(const uint16_t* __restrict__ q,          // [B, D] bf16 bits
                   const unsigned char* __restrict__ rows,  // [N, D] bf16 or int8
                   const int* __restrict__ mask,            // [N]
                   float* __restrict__ out_v,               // [tiles, B, m]
                   int* __restrict__ out_i,                 // [tiles, B, m]
                   int B, int D, int tile_n, int m, int nqb) {
  constexpr int NT = QB / 8;                   // n-tiles of 8 queries
  constexpr int RB = row_bytes<KIND>();        // bytes of one row's K-chunk
  constexpr int CPR = RB / 16;                 // 16-byte chunks of it
  constexpr int VE = KIND == kBf16 ? 8 : 16;   // row values per chunk
  constexpr int ES = KIND == kBf16 ? 2 : 1;    // row element bytes
  constexpr int RCH = kSub * CPR;              // row chunks per stage
  constexpr int QCH = QB * (kQRowBytes / 16);  // query chunks per stage
  constexpr size_t STAGE = stage_bytes<KIND, QB>();
  static_assert(RCH % kThreads == 0, "row chunks split evenly over the threads");
  extern __shared__ __align__(128) unsigned char smem[];

  const int tile = blockIdx.x / nqb;
  const int b0 = (blockIdx.x % nqb) * QB;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;                // MMA group id: row g, query g
  const int t = tid % 4;                       // thread in group: K columns
  const int la = warp * 16 + g;                // group lanes la and la + 8
  const size_t row0 = (size_t)tile * tile_n;
  const size_t pitch = (size_t)D * ES;
  const int nk = (D + kKC - 1) / kKC;          // K-chunks per sub-tile
  const int nsub = tile_n / kSub;
  const int total = nsub * nk;

  // cp.async of K-chunk c of sub-tile s into ring stage p % kStages
  auto load = [&](int p, int s, int c) {
    unsigned char* st = smem + (size_t)(p % kStages) * STAGE;
    const int k0 = c * kKC;
    const unsigned char* rbase = rows + (row0 + (size_t)s * kSub) * pitch;
#pragma unroll
    for (int i = 0; i < RCH / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / CPR, cc = e % CPR;
      const int col = k0 + cc * VE;
      const bool ok = col < D;
      cp_async16(st + r * RB + row_chunk<KIND>(r, cc) * 16,
                 ok ? rbase + r * pitch + (size_t)col * ES : rows, ok);
    }
    unsigned char* sq = st + kSub * RB;
#pragma unroll
    for (int i = 0; i < (QCH + kThreads - 1) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      if (QCH % kThreads == 0 || e < QCH) {
        const int n = e / 8, cc = e % 8;
        const int col = k0 + cc * 8;
        const bool ok = col < D && b0 + n < B;
        cp_async16(sq + n * kQRowBytes + q_chunk<KIND>(n, cc) * 16,
                   ok ? q + (size_t)(b0 + n) * D + col : q, ok);
      }
    }
  };

  float acc[NT][4];   // this K-chunk's MMA sums
  float sum[NT][4];   // the sub-tile's f32 sums of them
  float gmax[NT][4];
  uint32_t offs[NT];  // byte r of offs[j]: the sub-tile of gmax[j][r]
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    offs[j] = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      acc[j][r] = 0.0f;
      sum[j][r] = 0.0f;
      gmax[j][r] = kNeg;
    }
  }

  int ls = 0, lc = 0;  // sub-tile and K-chunk of the next load
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < total) {
      load(p, ls, lc);
      if (++lc == nk) lc = 0, ++ls;
    }
    cp_async_commit();
  }

  const int* mtile = mask + row0;
  int ma = 0, mb = 0;
  int s = 0, c = 0;  // sub-tile and K-chunk being multiplied
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk `it` is in; stage (it - 1) % kStages is free
    if (it + kStages - 1 < total) {
      load(it + kStages - 1, ls, lc);
      if (++lc == nk) lc = 0, ++ls;
    }
    cp_async_commit();
    if (c == 0) {  // this sub-tile's mask, read while it multiplies
      ma = mtile[s * kSub + la];
      mb = mtile[s * kSub + la + 8];
    }

    const unsigned char* sr = smem + (size_t)(it % kStages) * STAGE;
    const unsigned char* sq = sr + kSub * RB;
    if constexpr (KIND == kBf16) {
      // two 32-column slabs; thread t takes columns 8t..8t+7 of each, the
      // first four for one k16 step and the last four for the next
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        const int cc = 4 * sl + t;
        const uint4 x = lds128(sr + la * RB + row_chunk<KIND>(la, cc) * 16);
        const uint4 y = lds128(sr + (la + 8) * RB + row_chunk<KIND>(la + 8, cc) * 16);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = j * 8 + g;
          const uint4 qv = lds128(sq + n * kQRowBytes + q_chunk<KIND>(n, cc) * 16);
          mma_bf16(acc[j], x.x, y.x, x.y, y.y, qv.x, qv.y);
          mma_bf16(acc[j], x.z, y.z, x.w, y.w, qv.z, qv.w);
        }
      }
    } else {
      // one 64-column slab; thread t takes columns 16t..16t+15, four per
      // k16 step; the bytes are widened once, here
      const uint4 x = lds128(sr + la * RB + t * 16);
      const uint4 y = lds128(sr + (la + 8) * RB + t * 16);
      uint32_t a[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t wx = word(x, k) ^ 0x80808080u, wy = word(y, k) ^ 0x80808080u;
        a[k][0] = widen2(wx, false);
        a[k][1] = widen2(wy, false);
        a[k][2] = widen2(wx, true);
        a[k][3] = widen2(wy, true);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = j * 8 + g;
        const uint4 q0 = lds128(sq + n * kQRowBytes + q_chunk<KIND>(n, 2 * t) * 16);
        const uint4 q1 = lds128(sq + n * kQRowBytes + q_chunk<KIND>(n, 2 * t + 1) * 16);
        mma_bf16(acc[j], a[0][0], a[0][1], a[0][2], a[0][3], q0.x, q0.y);
        mma_bf16(acc[j], a[1][0], a[1][1], a[1][2], a[1][3], q0.z, q0.w);
        mma_bf16(acc[j], a[2][0], a[2][1], a[2][2], a[2][3], q1.x, q1.y);
        mma_bf16(acc[j], a[3][0], a[3][1], a[3][2], a[3][3], q1.z, q1.w);
      }
    }

    // this chunk's MMA sums into the f32 sums: a chain of MMAs into one
    // accumulator truncates at every step (3-4x the f32 twin's error at
    // D=4096); one f32 add per chunk rounds
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        sum[j][r] += acc[j][r];
        acc[j][r] = 0.0f;
      }
    if (++c == nk) {  // sub-tile done: mask and fold into the group maxima
      // accumulator r of n-tile j: lane la (r < 2) or la + 8, query j*8 + 2t + (r & 1)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float v = (r < 2 ? ma : mb) > 0 ? sum[j][r] : kNeg;
          if (v > gmax[j][r]) {  // strict: a tie keeps the lower offset
            gmax[j][r] = v;
            offs[j] = set_byte(offs[j], (uint32_t)s, r);
          }
          sum[j][r] = 0.0f;
        }
      }
      c = 0;
      ++s;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

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
      static_cast<const uint16_t*>(q), static_cast<const unsigned char*>(rows),
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

int cqs_scan_topk_grouped_i8w(const void* q, const void* rows, const void* mask, void* vals,
                              void* inds, int B, int N, int D, int tile_n, int m, int qb,
                              void* stream) {
  return dispatch<kI8Widen>(q, rows, mask, vals, inds, B, N, D, tile_n, m, qb, stream);
}

}  // extern "C"
