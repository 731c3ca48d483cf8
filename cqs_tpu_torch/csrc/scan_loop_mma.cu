// Exact per-tile top-m scan on Hopper's tensor cores, tiles split across
// CTAs (sm_90a).
//
// Replaces two branches of the Pallas kernel body
// cqs_tpu/ops/topk.py::_scan_kernel ("loop", topk.py:58-108; branches
// :79-80 bf16 x bf16 and :69-75 int8 x int8 -> int32), reached through
// topk_pallas (pl.pallas_call at topk.py:145). Semantics, slot for slot:
// for each tile of tile_n rows and each query, the m best (score, global
// row) slots, descending, ties to the lower row; masked rows score NEG;
// once a tile has no valid row left, the remaining slots hold NEG and the
// tile's first row. Outputs are tile-major [num_tiles, B, m], m <= 512.
//
// What bounds it: the rows, read once (a 4,096 x 1024 bf16 corpus is 8 MiB,
// 2.5 us at 3.35 TB/s; 1M x 1024 is 2 GiB, 0.64 ms), or at large B the
// 2*B*N*D tensor-core operations. The CUDA-core kernel this replaces ran one
// CTA per tile and query block of 8: two CTAs on 132 SMs at the repository
// corpus (4,096 rows, tile 2048), each streaming its tile alone and then
// spending m rounds of block-wide argmax; and at B=128 sixteen reads of each
// tile and every multiply-add an f32 FMA. Here:
//   - the score pass is the grouped kernel's (scan_mma.cuh): mma.sync
//     m16n8k16 bf16 with per-K-chunk f32 adds, or m16n8k32 s8 with exact
//     int32 sums and one __int2float_rn; one CTA serves up to 32 queries
//     (at 64 the ring and the lists leave room for one CTA an SM, and 32
//     measured faster at B 64 and 128: the second read of a row mostly
//     hits L2, its query blocks being adjacent in launch order);
//   - each tile is cut into `slices` row slices of tile_n / slices rows (a
//     multiple of 128; the wrapper picks the count so the grid fills the
//     card), one CTA per (tile, slice, query block);
//   - a CTA keeps, per query, a running top-L list (L = m rounded up to a
//     power of two, <= 512) in shared memory and folds each 128-row
//     sub-tile into it: the sub-tile's keys that beat the list's m-th are
//     packed (warp ballots) and padded with empty keys to a power of two
//     n; n >= L: sorted in runs of L (bitonic), the runs reduced pairwise
//     to the candidates' top L (A[i] = max(A[i], B[L-1-i]) leaves a bitonic
//     sequence holding the top L of A and B, a half-cleaner sorts it), and
//     the same step merges that run into the list; n < L: sorted, and the
//     same step on the list's last n keys, then one clean of the list. A
//     sub-tile none of whose keys enters is skipped. No [QB, tile_n] score
//     block:
//     shared memory holds the ring, 128 keys and L keys a query. Each query
//     is served by G = 256 / QB threads of one warp, so the selection syncs
//     with __syncwarp, not the block;
//   - with one slice the CTA writes the tile's slots; with more, it writes
//     its top m keys to a scratch buffer the wrapper allocates, and a
//     second kernel (merge_slices_kernel, one CTA per (tile, query)) merges
//     the slices' lists by the same pairwise reduction. A slice may hold
//     fewer rows than m (a 2,048-row tile in 128-row slices at m 500): its
//     list is its rows and empty keys (0), which lose to every real key,
//     NEG rows included, so the tile's m slots are real rows (m <= tile_n).
// A key is (score, row) as one 64-bit integer that orders like the
// reference's rounds: the score's bits made monotone (-0 folded into +0,
// which compare equal in the reference) above the row's complement, so a
// larger key is a higher score or, on a tie, the lower row. Masked rows
// keep their own rows under NEG; the slots that end on NEG take the tile's
// first row, as the reference's rounds leave them.
//
// Large m (128 < m <= 512: a shard's exact top-500 in the sharded programs).
//   - What bounds it is still the rows' bytes: a shard of 262,144 x 768 bf16
//     is 0.40 GB, 0.121 ms at 3.35 TB/s (x 1024 int8: 0.27 GB, 0.081 ms).
//     The m rounds of the CUDA-core template (scan_topk.cu) took 4.3-6.5x that
//     at m 500: each round a block-wide argmax with two __syncthreads.
//   - Folding a 128-row sub-tile into a 512-key list is one warp's bitonic
//     sort of at most 128 keys (28 stages of 2 compare-exchanges a thread)
//     and the merge into the list's tail, then one half-cleaner pass over
//     the 512 keys (9 stages of 8): about 150 compare-exchanges a thread
//     under __syncwarp in place of 500 block-wide rounds a tile. Sub-tiles
//     none of whose keys beat the list's m-th are skipped, as at small m.
//   - The wrapper takes a query block of 8 at m > 128 (a warp a query;
//     B=1 takes 8 anyway): 4 ring stages and 8 x 672 keys are 110 KiB, so
//     two CTAs share an SM and one streams rows while the other folds. The
//     wrapper cuts tiles into slices only while the grid stays one wave of
//     264 CTAs: at 262,144 rows and tile 2048, 2 slices of 1,024 rows (256
//     CTAs), whose later sub-tiles skip more of the folds than 512-row
//     slices can; the cp.async ring keeps the next chunks in flight while a
//     warp folds.
//   - Built: the bitonic lists of small m, widened, rather than a radix
//     select of the m-th key over a slice's scores: they reuse the exact
//     small-m code path (one kernel, one emulation, one set of tests) and
//     hold no [QB, rows] score block. On an H100 the same launch at m 4 and
//     m 500 shows the folds' share (PERF.md): a quarter to a third of the time
//     at B=1, where one warp of the CTA folds while seven wait at the next
//     barrier. A block-wide fold at B=1, or a radix select, is the next
//     step if that share matters.
//
// Plain C ABI for ctypes: pointers and the stream as void*, returns a CUDA
// error code (0 = launched; cudaErrorInvalidValue for a query block, m,
// tile, slice count or shared-memory size the kernel does not take).

#include "scan_mma.cuh"

namespace {

using namespace cqs;

using Key = unsigned long long;

constexpr int kMaxM = 512;           // per-tile k the kernel takes
constexpr int kMaxSlices = 16;       // slices a tile is cut into
constexpr int kMergeThreads = 128;  // merge threads, 512 above 2,048 keys a CTA
constexpr int kMergeThreadsWide = 512;

// Ring depth: 4 stages, or 3 at QB 32, where a stage holds 20 KiB, so two
// CTAs fit an SM at m <= 64.
template <int QB>
__host__ __device__ constexpr int loop_ring_stages() {
  return QB >= 32 ? 3 : 4;
}

// keys a query takes in shared memory: 128 of a sub-tile, L of its list,
// and G of padding, which staggers the queries of one warp across banks
template <int QB>
__host__ __device__ constexpr int key_stride(int lg) {
  return kSub + (1 << lg) + kThreads / QB;
}

template <int KIND, int QB>
size_t loop_smem_bytes(int lg) {
  return loop_ring_stages<QB>() * stage_bytes<KIND, QB>() +
         (size_t)QB * key_stride<QB>(lg) * sizeof(Key);
}

__device__ __forceinline__ Key make_key(float v, uint32_t row) {
  const uint32_t b = __float_as_uint(__fadd_rn(v, 0.0f));  // -0 -> +0
  const uint32_t o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((Key)o << 32) | (uint32_t)~row;
}
__device__ __forceinline__ float key_val(Key k) {
  const uint32_t o = (uint32_t)(k >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}
__device__ __forceinline__ int key_row(Key k) { return (int)~(uint32_t)k; }

struct WarpSync {
  __device__ __forceinline__ void operator()() const { __syncwarp(); }
};
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// lower index of compare-exchange c among pairs at distance j (a power of 2)
__device__ __forceinline__ int ce_lo(int c, int j) {
  return ((c & ~(j - 1)) << 1) | (c & (j - 1));
}
// a[i] >= a[l] afterwards
__device__ __forceinline__ void ce_desc(Key* a, int i, int l) {
  const Key x = a[i], y = a[l];
  if (x < y) {
    a[i] = y;
    a[l] = x;
  }
}

// Each run of L = 2^lg keys of a[0, n) into descending order (bitonic
// sort); thread id of nt takes every nt-th compare-exchange.
template <class Sync>
__device__ __forceinline__ void sort_runs(Key* a, int n, int lg, int id, int nt, Sync sync) {
  const int L = 1 << lg;
  for (int k = 2; k <= L; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int c = id; c < n / 2; c += nt) {
        const int i = ce_lo(c, j), l = i + j;
        const Key x = a[i], y = a[l];
        const bool desc = k == L || (i & k) == 0;  // the last merge: every run descending
        if (desc ? x < y : x > y) {
          a[i] = y;
          a[l] = x;
        }
      }
      sync();
    }
  }
}

// The bitonic run of 2^lg keys at a into descending (or ascending) order
// (half-cleaners).
template <class Sync>
__device__ __forceinline__ void clean_run(Key* a, int lg, int id, int nt, Sync sync,
                                          bool ascending = false) {
  for (int j = (1 << lg) >> 1; j > 0; j >>= 1) {
    for (int c = id; c < (1 << lg) / 2; c += nt) {
      const int i = ce_lo(c, j);
      if (ascending)
        ce_desc(a, i + j, i);
      else
        ce_desc(a, i, i + j);
    }
    sync();
  }
}

// a[0, nruns*L): nruns (a power of 2) descending runs of L = 2^lg keys.
// Leaves the top L of all of them, descending, in run 0: each round pairs
// run A with the run sb after it, A[i] = max(A[i], B[L-1-i]) (a bitonic
// sequence holding the top L of A and B), then half-cleaners.
template <class Sync>
__device__ __forceinline__ void reduce_runs(Key* a, int nruns, int lg, int id, int nt,
                                            Sync sync) {
  const int L = 1 << lg;
  for (int sb = 1; sb < nruns; sb <<= 1) {
    const int npairs = nruns / (2 * sb);
    for (int e = id; e < npairs * L; e += nt) {
      const int i = e & (L - 1);
      Key* A = a + (size_t)(e >> lg) * 2 * sb * L;
      const Key y = A[sb * L + L - 1 - i];
      if (A[i] < y) A[i] = y;
    }
    sync();
    for (int j = L >> 1; j > 0; j >>= 1) {
      for (int e = id; e < npairs * (L >> 1); e += nt) {
        const int i = (e / (L >> 1)) * 2 * sb * L + ce_lo(e % (L >> 1), j);
        ce_desc(a, i, i + j);
      }
      sync();
    }
  }
}

// a := the top L of a and b (two descending runs of L = 2^lg), descending.
template <class Sync>
__device__ __forceinline__ void merge_top(Key* a, const Key* b, int lg, int id, int nt,
                                          Sync sync) {
  const int L = 1 << lg;
  for (int i = id; i < L; i += nt) {
    const Key y = b[L - 1 - i];
    if (a[i] < y) a[i] = y;
  }
  sync();
  clean_run(a, lg, id, nt, sync);
}

// a (L = 2^lg, descending) := the top L of a and b (2^lb < L keys,
// descending): at most 2^lb keys of a leave, all from its tail, so the tail
// becomes the top 2^lb of tail and b (max step, then cleaned ascending),
// and the whole run, descending then ascending, is cleaned descending.
template <class Sync>
__device__ __forceinline__ void merge_short(Key* a, const Key* b, int lg, int lb, int id,
                                            int nt, Sync sync) {
  const int n = 1 << lb;
  Key* tail = a + (1 << lg) - n;
  for (int i = id; i < n; i += nt) {
    const Key y = b[n - 1 - i];
    if (tail[i] < y) tail[i] = y;
  }
  sync();
  clean_run(tail, lb, id, nt, sync, true);
  clean_run(a, lg, id, nt, sync);
}

// The epilogue: each sub-tile's masked scores become keys in shared memory
// (MMA layout), then each query's G threads fold them into its list.
template <int QB>
struct TopSelect {
  static constexpr int G = kThreads / QB;
  static_assert(G >= 1 && G <= 32, "a query's selection group fits in a warp");
  Key* keys;       // [QB][stride]: the sub-tile's 128 keys, then the list
  int stride, lg, m, B, b0;
  uint32_t row0;   // global row of the slice's first row

  __device__ __forceinline__ void score(int s, int j, int r, float v) {
    const int tid = threadIdx.x;
    const int qi = j * 8 + 2 * (tid % 4) + (r & 1);
    const int lane = (tid / 32) * 16 + (tid % 32) / 4 + (r < 2 ? 0 : 8);
    keys[qi * stride + lane] = make_key(v, row0 + (uint32_t)(s * kSub + lane));
  }

  __device__ __forceinline__ void done(int) {
    __syncthreads();  // the sub-tile's keys are in
    const int qi = threadIdx.x / G, gt = threadIdx.x % G;
    if (b0 + (threadIdx.x / 32) * (32 / G) >= B) return;  // the warp's queries are padding
    Key* nw = keys + qi * stride;
    Key* lst = nw + kSub;
    const Key kth = lst[m - 1];
    // the keys that beat the list's m-th, packed to the front of nw (a
    // round's writes land below the next round's reads)
    const int lane = threadIdx.x % 32;
    const unsigned group = G == 32 ? 0xffffffffu : ((1u << G) - 1) << (lane & ~(G - 1));
    int c = 0;
    for (int i0 = 0; i0 < kSub; i0 += G) {
      const Key k = nw[i0 + gt];
      const bool in = k > kth;
      const unsigned bal = __ballot_sync(0xffffffffu, in) & group;
      if (in) nw[c + __popc(bal & ((1u << lane) - 1))] = k;
      c += __popc(bal);
    }
    if (__reduce_max_sync(0xffffffffu, (unsigned)c) == 0) return;  // no key enters
    // the candidates padded with empty keys to a power of two n, the same
    // for every query of the warp; n >= L: sorted in runs of L, reduced to
    // their top L and merged; n < L: sorted and merged into the list's tail
    int n = 1;
    while (n < c) n <<= 1;
    n = (int)__reduce_max_sync(0xffffffffu, (unsigned)n);
    for (int i = c + gt; i < n; i += G) nw[i] = 0;
    __syncwarp();
    if (n >= (1 << lg)) {
      sort_runs(nw, n, lg, gt, G, WarpSync{});
      reduce_runs(nw, n >> lg, lg, gt, G, WarpSync{});
      merge_top(lst, nw, lg, gt, G, WarpSync{});
    } else {
      const int lb = __ffs(n) - 1;
      sort_runs(nw, n, lb, gt, G, WarpSync{});
      merge_short(lst, nw, lg, lb, gt, G, WarpSync{});
    }
  }
};

// m slots of one (tile, query) from a descending key list; the slots that
// end on NEG take the tile's first row
__device__ __forceinline__ void write_slots(const Key* lst, int m, int id, int nt, float* out_v,
                                            int* out_i, int first_row) {
  for (int i = id; i < m; i += nt) {
    const Key k = lst[i];
    const float v = key_val(k);
    out_v[i] = v;
    out_i[i] = v <= kNeg * 0.5f ? first_row : key_row(k);
  }
}

template <int KIND, int QB>
__global__ void __launch_bounds__(kThreads, 2)
loop_split_kernel(const unsigned char* __restrict__ q,     // [B, D] bf16 bits or int8
                  const unsigned char* __restrict__ rows,  // [N, D] bf16 or int8
                  const int* __restrict__ mask,            // [N]
                  float* __restrict__ out_v,               // [tiles, B, m]
                  int* __restrict__ out_i,                 // [tiles, B, m]
                  Key* __restrict__ part,                  // [tiles, B, slices, m]
                  int B, int D, int tile_n, int m, int lg, int slices, int nqb) {
  constexpr int STAGES = loop_ring_stages<QB>();
  constexpr int G = TopSelect<QB>::G;
  extern __shared__ __align__(128) unsigned char smem[];

  const int b0 = (blockIdx.x % nqb) * QB;
  const int sl = (blockIdx.x / nqb) % slices;
  const int tile = blockIdx.x / (nqb * slices);
  const int rows_per_slice = tile_n / slices;
  const size_t row0 = (size_t)tile * tile_n + (size_t)sl * rows_per_slice;

  TopSelect<QB> sel;
  sel.keys = reinterpret_cast<Key*>(smem + STAGES * stage_bytes<KIND, QB>());
  sel.stride = key_stride<QB>(lg);
  sel.lg = lg;
  sel.m = m;
  sel.B = B;
  sel.b0 = b0;
  sel.row0 = (uint32_t)row0;
  for (int e = threadIdx.x; e < (QB << lg); e += kThreads)  // empty lists: key 0 loses to all
    sel.keys[(e >> lg) * sel.stride + kSub + (e & ((1 << lg) - 1))] = 0;
  // the first barrier of the score pass orders these stores before any read
  score_pass<KIND, QB, STAGES>(q, rows, mask, B, D, b0, row0, rows_per_slice / kSub, smem, sel);
  cp_async_wait<0>();
  __syncthreads();

  const int qi = threadIdx.x / G, gt = threadIdx.x % G;
  const int b = b0 + qi;
  if (b >= B) return;
  const Key* lst = sel.keys + qi * sel.stride + kSub;
  if (slices == 1) {
    const size_t out0 = ((size_t)tile * B + b) * m;
    write_slots(lst, m, gt, G, out_v + out0, out_i + out0, tile * tile_n);
  } else {
    Key* dst = part + (((size_t)tile * B + b) * slices + sl) * m;
    for (int i = gt; i < m; i += G) dst[i] = lst[i];
  }
}

// One CTA per (tile, query): the slices' top-m lists -> the tile's m slots.
__global__ void __launch_bounds__(kMergeThreadsWide)
merge_slices_kernel(const Key* __restrict__ part,  // [tiles, B, slices, m]
                    float* __restrict__ out_v, int* __restrict__ out_i, int B, int tile_n,
                    int m, int lg, int slices) {
  extern __shared__ __align__(128) unsigned char smem[];
  Key* a = reinterpret_cast<Key*>(smem);       // [slices][L]
  const int pair = blockIdx.x;                 // tile * B + b
  const int L = 1 << lg;
  const Key* src = part + (size_t)pair * slices * m;
  const int nt = blockDim.x;
  for (int e = threadIdx.x; e < slices * L; e += nt) {
    const int i = e & (L - 1);
    a[e] = i < m ? src[(e >> lg) * m + i] : 0;
  }
  __syncthreads();
  reduce_runs(a, slices, lg, threadIdx.x, nt, BlockSync{});
  write_slots(a, m, threadIdx.x, nt, out_v + (size_t)pair * m, out_i + (size_t)pair * m,
              (pair / B) * tile_n);
}

template <int KIND, int QB>
int launch(const void* q, const void* rows, const void* mask, void* vals, void* inds,
           void* part, int B, int N, int D, int tile_n, int m, int slices,
           cudaStream_t stream) {
  if (m < 1 || m > kMaxM || tile_n % kSub || N % tile_n || slices < 1 ||
      slices > kMaxSlices || (slices & (slices - 1)) || tile_n % (slices * kSub) ||
      (slices > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  int lg = 0;
  while ((1 << lg) < m) ++lg;
  const size_t smem = loop_smem_bytes<KIND, QB>(lg);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  auto kernel = loop_split_kernel<KIND, QB>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nqb = (B + QB - 1) / QB;
  const int tiles = N / tile_n;
  kernel<<<tiles * slices * nqb, kThreads, smem, stream>>>(
      static_cast<const unsigned char*>(q), static_cast<const unsigned char*>(rows),
      static_cast<const int*>(mask), static_cast<float*>(vals), static_cast<int*>(inds),
      static_cast<Key*>(part), B, D, tile_n, m, lg, slices, nqb);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return (int)err;
  // slices x L keys: 64 KiB at 16 x 512, above the 48 KiB a launch gets
  // without the attribute
  const size_t merge_smem = ((size_t)slices << lg) * sizeof(Key);
  if (merge_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(merge_slices_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)merge_smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int merge_threads = (slices << lg) > 2048 ? kMergeThreadsWide : kMergeThreads;
  merge_slices_kernel<<<tiles * B, merge_threads, merge_smem, stream>>>(
      static_cast<const Key*>(part), static_cast<float*>(vals), static_cast<int*>(inds), B,
      tile_n, m, lg, slices);
  return (int)cudaGetLastError();
}

template <int KIND>
int dispatch(const void* q, const void* rows, const void* mask, void* vals, void* inds,
             void* part, int B, int N, int D, int tile_n, int m, int qb, int slices,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (qb) {
    case 32: return launch<KIND, 32>(q, rows, mask, vals, inds, part, B, N, D, tile_n, m, slices, s);
    case 16: return launch<KIND, 16>(q, rows, mask, vals, inds, part, B, N, D, tile_n, m, slices, s);
    case 8: return launch<KIND, 8>(q, rows, mask, vals, inds, part, B, N, D, tile_n, m, slices, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int cqs_scan_topk_loop_split_bf16(const void* q, const void* rows, const void* mask, void* vals,
                                  void* inds, void* part, int B, int N, int D, int tile_n, int m,
                                  int qb, int slices, void* stream) {
  return dispatch<kBf16>(q, rows, mask, vals, inds, part, B, N, D, tile_n, m, qb, slices, stream);
}

int cqs_scan_topk_loop_split_i8(const void* q, const void* rows, const void* mask, void* vals,
                                void* inds, void* part, int B, int N, int D, int tile_n, int m,
                                int qb, int slices, void* stream) {
  return dispatch<kI8>(q, rows, mask, vals, inds, part, B, N, D, tile_n, m, qb, slices, stream);
}

}  // extern "C"
