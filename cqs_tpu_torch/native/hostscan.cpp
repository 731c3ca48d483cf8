// Native CPU serving kernels for the host mirror of the hybrid device
// program (cqs_tpu/search/program.py::hybrid_query_host).
//
// Why native: CPU-fallback serving is memory-bound on the dense scan — the
// f32 widening of the bf16 index doubles the bytes streamed per query
// (32 MB vs 16 MB at 31k x 256). Scanning the bf16 rows directly (widen in
// registers, f32 FMA) halves the traffic, and batched queries amortize the
// single matrix pass across the whole micro-batch. The reference reaches
// its warm-daemon latency class with a native (Rust) scan too; this is the
// TPU-framework's host-runtime analog.
//
// Contracts (pinned by tests/test_native.py):
//  - bf16_matmul_masked: per-row dot of the bf16-storage row against an
//    f32 query (queries are pre-rounded through bf16, so every product is
//    exact in f32; only the f32 accumulation order differs from BLAS —
//    lane-blocked here, deterministic).
//  - csr_accumulate: BIT-IDENTICAL to the numpy fallback
//    (sparse_scores_csr): per-posting f32 multiply, f64 accumulation in
//    posting order per query term, query terms in given order.
//
// Build: g++ -O3 -march=native -shared -fPIC (build-on-demand, source-hash
// pinned — see cqs_tpu/native/__init__.py).

#include <cstdint>
#include <cstring>

namespace {

inline float bf16_to_f32(uint16_t u) {
    uint32_t v = static_cast<uint32_t>(u) << 16;
    float f;
    std::memcpy(&f, &v, 4);
    return f;
}

}  // namespace

extern "C" {

// mat: [n, d] bf16 (row-major, as uint16); q: [B, d] f32 (bf16-rounded);
// valid: [n] uint8 (0 = masked row); out: [B, n] f32 (masked rows = neg).
// One pass over the matrix serves all B queries: each row is widened to f32
// once and dotted against every query while it is hot in L1.
void bf16_matmul_masked(const uint16_t* mat, int64_t n, int32_t d,
                        const float* q, int32_t B, const uint8_t* valid,
                        float neg, float* out) {
    constexpr int LANES = 16;
    float buf[4096];  // d <= 4096 (model dims: 256..1024)
    if (d > 4096) return;
    const int32_t dv = d - (d % LANES);
    for (int64_t i = 0; i < n; ++i) {
        if (!valid[i]) {
            for (int32_t b = 0; b < B; ++b) out[b * n + i] = neg;
            continue;
        }
        const uint16_t* row = mat + i * d;
        for (int32_t j = 0; j < d; ++j) buf[j] = bf16_to_f32(row[j]);
        for (int32_t b = 0; b < B; ++b) {
            const float* qb = q + static_cast<int64_t>(b) * d;
            // lane-blocked reduction: deterministic order, vectorizable
            // without -ffast-math (each lane is an independent chain)
            float lanes[LANES] = {0};
            for (int32_t j = 0; j < dv; j += LANES)
                for (int32_t k = 0; k < LANES; ++k)
                    lanes[k] += buf[j + k] * qb[j + k];
            float acc = 0.f;
            for (int32_t k = 0; k < LANES; ++k) acc += lanes[k];
            for (int32_t j = dv; j < d; ++j) acc += buf[j] * qb[j];
            out[b * n + i] = acc;
        }
    }
}

// Int8 selection scan: the host twin of the device q8 program's candidate
// generation (cqs_tpu/search/program.py::hybrid_query_batch_q8). mat/q are
// int8 (rows unit-norm * 127, query likewise), accumulation is int32 —
// exact (|dot| <= d * 127^2 < 2^31 for d <= 4096). Half the memory traffic
// of the bf16 scan on a memory-bound path; selection-only (callers rescore
// the candidate union against the f32 rows for exact final ordering).
// g++ -O3 -march=native auto-vectorizes the i8 inner loop (VNNI where the
// host has it; widening madd otherwise).
void i8_matmul_masked(const int8_t* mat, int64_t n, int32_t d,
                      const int8_t* q, int32_t B, const uint8_t* valid,
                      float neg, float* out) {
    for (int64_t i = 0; i < n; ++i) {
        if (!valid[i]) {
            for (int32_t b = 0; b < B; ++b) out[b * n + i] = neg;
            continue;
        }
        const int8_t* row = mat + i * d;
        for (int32_t b = 0; b < B; ++b) {
            const int8_t* qb = q + static_cast<int64_t>(b) * d;
            int32_t acc = 0;
            for (int32_t j = 0; j < d; ++j)
                acc += static_cast<int32_t>(row[j]) * static_cast<int32_t>(qb[j]);
            out[b * n + i] = static_cast<float>(acc);
        }
    }
}

// Exact sparse scores for ONE query via the CSR inverted index — the native
// twin of sparse_scores_csr (walk each query term's posting list, accumulate
// w * qw). f32 multiply + f64 accumulate in posting order == np.bincount's
// arithmetic, so the two paths are bit-identical after the final f32 cast.
// acc: [n] f64, caller-zeroed. Returns the number of postings touched.
int64_t csr_accumulate(const int64_t* indptr, const int32_t* post_rows,
                       const float* post_w, const int32_t* q_ids,
                       const float* q_w, int32_t nterms,
                       double* acc, int64_t n) {
    (void)n;
    int64_t touched = 0;
    for (int32_t t = 0; t < nterms; ++t) {
        const float qw = q_w[t];
        if (qw <= 0.0f) continue;  // fixed-width padding terms
        const int64_t a = indptr[q_ids[t]], b = indptr[q_ids[t] + 1];
        for (int64_t p = a; p < b; ++p) {
            const float v = post_w[p] * qw;  // f32 multiply (numpy parity)
            acc[post_rows[p]] += static_cast<double>(v);
        }
        touched += b - a;
    }
    return touched;
}

}  // extern "C"
