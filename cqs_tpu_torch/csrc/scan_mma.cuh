// The tensor-core score pass shared by the grouped kernel (scan_topk_mma.cu)
// and the split loop kernel (scan_loop_mma.cu), for sm_90a.
//
// A CTA of 8 warps walks rows row0 .. row0 + nsub*128 in 128-row sub-tiles
// against a query block of QB queries (b0 .. b0+QB-1, zero past B). Sub-tile
// s holds row s*128 + g in lane g, and warp w owns lanes 16w..16w+15 (the
// MMA's M) against all QB queries (N, QB/8 n-tiles). Rows (A) and queries
// (B) stream along D in K-chunks (64 elements; 128 for int8 x int8, so that
// every row gives 128 contiguous bytes a stage, whole L2 lines) through a
// ring of STAGES stages of shared memory filled by cp.async (zero-fill past
// D and past B), so the next chunks load while the current one multiplies
// and shared memory stays bounded at every width. The dot product's K order
// is free, so each thread reads its A and B fragments as 16-byte vectors of
// neighbouring columns (no ldmatrix): thread (g, t) takes columns 8t..8t+7
// (bf16) or 16t..16t+15 (int8) of each 32- or 64-column slab, for rows g
// and g+8 and for query g of each n-tile; a per-row XOR swizzle of the
// 16-byte chunks keeps those reads free of bank conflicts where a row or
// query holds 128 bytes of a K-chunk.
//   - bf16 x bf16: mma.sync m16n8k16 bf16 -> f32.
//   - int8 widened: int8 row bytes become bf16 once per CTA, on their way
//     into the A fragment (exact: |v| <= 128 has 8 significant bits), then
//     the bf16 MMA. Both float kinds add each K-chunk's MMA sums into f32
//     sums once (the tensor cores' chained accumulation truncates; this
//     keeps the error below the f32 twin's).
//   - int8 x int8: the query ring holds int8 chunks (64 bytes a query), and
//     mma.sync m16n8k32 s8 x s8 -> s32 accumulates exactly across all of D
//     (|sum| <= 128^2 * 4096 < 2^31); the sum becomes f32 once per sub-tile
//     with round-to-nearest, the reference's int32 -> f32 cast, so the
//     kernels equal their twins slot for slot.
// After a sub-tile's last chunk each score is masked (NEG) and handed to
// the kernel's epilogue, `epi.score(s, j, r, v)` for accumulator r of
// n-tile j (lane la (r < 2) or la + 8, query j*8 + 2t + (r & 1)), then
// `epi.done(s)`, called by every thread at the same point.

#pragma once

#include <type_traits>

#include "scan_common.cuh"

namespace cqs {

constexpr int kSub = 128;            // rows per sub-tile: one per lane
constexpr int kQRowBytes = 128;      // one query's K-chunk, every kind

// K elements per pipeline stage: 128 bytes of a bf16 query (or of an int8
// one against int8 rows)
template <int KIND>
__host__ __device__ constexpr int k_chunk() {
  return KIND == kI8 ? 128 : 64;
}
// bytes of one row's K-chunk
template <int KIND>
__host__ __device__ constexpr int row_bytes() {
  return KIND == kI8Widen ? 64 : 128;
}

template <int KIND, int QB>
__host__ __device__ constexpr size_t stage_bytes() {
  return (size_t)kSub * row_bytes<KIND>() + (size_t)QB * kQRowBytes;
}

// 16-byte chunk c of row r as stored: 128-byte rows (8 chunks) swap halves
// on odd rows; the widening kind's 64-byte rows (4 chunks) need no swizzle.
template <int KIND>
__device__ __forceinline__ int row_chunk(int r, int c) {
  return KIND == kI8Widen ? c : c ^ ((r & 1) << 2);
}
// the same for query n's 8 chunks: the bf16 and int8 kernels read chunk t
// of a half, the widening kernel the pair 2t, 2t+1
template <int KIND>
__device__ __forceinline__ int q_chunk(int n, int c) {
  return c ^ ((n & 1) * (KIND == kI8Widen ? 1 : 4));
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

// D += A * B for one m16n8k32 tile, s8 operands, exact s32 accumulators.
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
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

// The score pass over rows row0 .. row0 + nsub*128 (see the head of this
// file). Leaves cp.async groups to drain: the caller waits on
// cp_async_wait<0>() and a barrier before reusing the ring.
template <int KIND, int QB, int STAGES, class Epi>
__device__ __forceinline__ void score_pass(const unsigned char* __restrict__ q,
                                           const unsigned char* __restrict__ rows,
                                           const int* __restrict__ mask, int B, int D, int b0,
                                           size_t row0, int nsub, unsigned char* smem, Epi& epi) {
  // exact int32 sums for int8 x int8, f32 MMA sums otherwise
  using AccT = std::conditional_t<KIND == kI8, int, float>;
  constexpr int NT = QB / 8;                   // n-tiles of 8 queries
  constexpr int RB = row_bytes<KIND>();        // bytes of one row's K-chunk
  constexpr int CPR = RB / 16;                 // 16-byte chunks of it
  constexpr int VE = KIND == kBf16 ? 8 : 16;   // row values per chunk
  constexpr int ES = KIND == kBf16 ? 2 : 1;    // row element bytes
  constexpr int KC = k_chunk<KIND>();          // K elements per stage
  constexpr int QRB = kQRowBytes;              // bytes of one query's K-chunk
  constexpr int QES = KIND == kI8 ? 1 : 2;     // query element bytes
  constexpr int RCH = kSub * CPR;              // row chunks per stage
  constexpr int QCH = QB * (QRB / 16);         // query chunks per stage
  constexpr size_t STAGE = stage_bytes<KIND, QB>();
  static_assert(RCH % kThreads == 0, "row chunks split evenly over the threads");

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;                // MMA group id: row g, query g
  const int t = tid % 4;                       // thread in group: K columns
  const int la = warp * 16 + g;                // lanes la and la + 8
  const size_t pitch = (size_t)D * ES;
  const int nk = (D + KC - 1) / KC;            // K-chunks per sub-tile
  const int total = nsub * nk;

  // cp.async of K-chunk c of sub-tile s into ring stage p % STAGES
  auto load = [&](int p, int s, int c) {
    unsigned char* st = smem + (size_t)(p % STAGES) * STAGE;
    const int k0 = c * KC;
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
        const int n = e / (QRB / 16), cc = e % (QRB / 16);
        const int col = k0 + cc * (16 / QES);
        const bool ok = col < D && b0 + n < B;
        cp_async16(sq + n * QRB + q_chunk<KIND>(n, cc) * 16,
                   ok ? q + ((size_t)(b0 + n) * D + col) * QES : q, ok);
      }
    }
  };

  AccT acc[NT][4];    // MMA sums: this K-chunk's (float kinds) or the sub-tile's
  float sum[NT][4];   // the float kinds' sub-tile f32 sums of them
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      acc[j][r] = 0;
      sum[j][r] = 0.0f;
    }
  }

  int ls = 0, lc = 0;  // sub-tile and K-chunk of the next load
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < total) {
      load(p, ls, lc);
      if (++lc == nk) lc = 0, ++ls;
    }
    cp_async_commit();
  }

  const int* mrows = mask + row0;
  int ma = 0, mb = 0;
  int s = 0, c = 0;  // sub-tile and K-chunk being multiplied
  for (int it = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk `it` is in; stage (it - 1) % STAGES is free
    if (it + STAGES - 1 < total) {
      load(it + STAGES - 1, ls, lc);
      if (++lc == nk) lc = 0, ++ls;
    }
    cp_async_commit();
    if (c == 0) {  // this sub-tile's mask, read while it multiplies
      ma = mrows[s * kSub + la];
      mb = mrows[s * kSub + la + 8];
    }

    const unsigned char* sr = smem + (size_t)(it % STAGES) * STAGE;
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
          const uint4 qv = lds128(sq + n * QRB + q_chunk<KIND>(n, cc) * 16);
          mma_bf16(acc[j], x.x, y.x, x.y, y.y, qv.x, qv.y);
          mma_bf16(acc[j], x.z, y.z, x.w, y.w, qv.z, qv.w);
        }
      }
    } else if constexpr (KIND == kI8) {
      // two 64-column slabs; thread t takes columns 16t..16t+15 of each, of
      // rows and queries alike: words 0 and 1 (columns 16t..16t+7) feed one
      // k32 step as its K quarters t and 4+t, words 2 and 3 the next
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        const int cc = 4 * sl + t;
        const uint4 x = lds128(sr + la * RB + row_chunk<KIND>(la, cc) * 16);
        const uint4 y = lds128(sr + (la + 8) * RB + row_chunk<KIND>(la + 8, cc) * 16);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = j * 8 + g;
          const uint4 qv = lds128(sq + n * QRB + q_chunk<KIND>(n, cc) * 16);
          mma_s8(acc[j], x.x, y.x, x.y, y.y, qv.x, qv.y);
          mma_s8(acc[j], x.z, y.z, x.w, y.w, qv.z, qv.w);
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
        const uint4 q0 = lds128(sq + n * QRB + q_chunk<KIND>(n, 2 * t) * 16);
        const uint4 q1 = lds128(sq + n * QRB + q_chunk<KIND>(n, 2 * t + 1) * 16);
        mma_bf16(acc[j], a[0][0], a[0][1], a[0][2], a[0][3], q0.x, q0.y);
        mma_bf16(acc[j], a[1][0], a[1][1], a[1][2], a[1][3], q0.z, q0.w);
        mma_bf16(acc[j], a[2][0], a[2][1], a[2][2], a[2][3], q1.x, q1.y);
        mma_bf16(acc[j], a[3][0], a[3][1], a[3][2], a[3][3], q1.z, q1.w);
      }
    }

    if constexpr (KIND != kI8) {
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
    }
    if (++c == nk) {  // sub-tile done: mask and hand the scores on
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float score;
          if constexpr (KIND == kI8) {
            score = __int2float_rn(acc[j][r]);  // the reference's int32 -> f32 cast
            acc[j][r] = 0;
          } else {
            score = sum[j][r];
            sum[j][r] = 0.0f;
          }
          epi.score(s, j, r, (r < 2 ? ma : mb) > 0 ? score : kNeg);
        }
      }
      epi.done(s);
      c = 0;
      ++s;
    }
  }
}

}  // namespace cqs
