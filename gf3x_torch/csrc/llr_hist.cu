// The diagnostics' |LLR| histogram (`DecodeDiag.llr_hist`): for each frame,
// from its scrambled wire-order LLRs (B, R) float32 and a sample table of
// positions in [0, R), 16 counts
//
//   hist[b, k] = #{ j : bucket(llr[b, index[j]]) = k },
//   bucket(x) = clamp(((bits(|x|) >> 23) & 0xFF) − 125, 0, 15)
//
// — bucket k ⇔ |x| ∈ [2^(k−2), 2^(k−1)), ±0 and denormals in 0, inf and NaN
// in 15: the exponent field of the float, as gf3x's `_hist16_of` reads it.
// The table is gf3x's every-8th coded-stream position, sorted: a count does
// not depend on the order of its samples, and sorted, a warp's 32 samples
// lie in about 8 sectors of the row instead of 32.
//
// It replaces no TPU kernel: gf3x leaves the histogram to XLA (a compare
// against 16 bins and a sum). The port ran it as about ten aten launches —
// a second gather, five elementwise passes, an int64 copy, a tensor of ones
// and a `scatter_add_` whose global atomics serialise on the two or three
// buckets nearly every LLR falls in.
//
// What bounds it on the card: bytes. The samples are read once (4 bytes
// each; at gf3-8192, B = 1024: 120 MB, 0.036 ms at 3.35 TB/s), but the
// sample set touches a quarter of each row's 32-byte sectors, four samples
// in each, so the card moves about 241 MB (0.072 ms). Here a thread keeps
// its counts in two 64-bit registers (eight 8-bit fields each) and loads
// kBatch samples at a time; every ≤ 255 samples, and at the end, each warp
// adds its lanes' fields (`__reduce_add_sync`) into the block's 16 counters
// in shared memory. A block owning a whole row stores its counts; where a
// row is split over blocks (few rows: the wrapper's `llr_hist_chunk`), each
// adds its 16 into the zeroed output. Integer sums: exact, in any order.
#include "common.cuh"

namespace {
constexpr int kThreads = 256;
constexpr int kMinBlocks = 8;     // all 2048 threads of an SM resident
constexpr int kBatch = 4;         // samples a thread loads before counting
constexpr int kBins = 16;
constexpr int kFieldMax = 255;    // what an 8-bit field holds

// Adds x's bucket to the packed counters: bins 0-7 in lo, 8-15 in hi.
__device__ __forceinline__ void count(float x, unsigned long long& lo,
                                      unsigned long long& hi) {
    const int e = static_cast<int>((__float_as_uint(x) << 1) >> 24);
    const int b = min(max(e - 125, 0), kBins - 1);
    const unsigned long long one = 1ull << ((b & 7) << 3);
    if (b < 8) {
        lo += one;
    } else {
        hi += one;
    }
}

// Adds the warp's packed counters into the block's; every lane calls it.
__device__ __forceinline__ void flush(unsigned long long lo,
                                      unsigned long long hi,
                                      unsigned* s_hist) {
    const bool lead = (threadIdx.x & 31) == 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
        const unsigned a = __reduce_add_sync(
            0xffffffffu, static_cast<unsigned>(lo >> (8 * b)) & 0xFFu);
        const unsigned c = __reduce_add_sync(
            0xffffffffu, static_cast<unsigned>(hi >> (8 * b)) & 0xFFu);
        if (lead && a) atomicAdd(s_hist + b, a);
        if (lead && c) atomicAdd(s_hist + 8 + b, c);
    }
}

// Block (row, c) of a grid of B · chunks counts samples [c·chunk,
// min((c + 1)·chunk, n)) of the table in row `row`.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
llr_hist_kernel(const float* __restrict__ llr, const int* __restrict__ index,
                int* __restrict__ hist, long long ld, int n, int chunk,
                int chunks) {
    __shared__ unsigned s_hist[kBins];
    if (threadIdx.x < kBins) s_hist[threadIdx.x] = 0u;
    __syncthreads();
    const long long row = blockIdx.x / chunks;
    const int begin = (blockIdx.x % chunks) * chunk;
    const int end = min(begin + chunk, n);
    const float* src = llr + row * ld;

    unsigned long long lo = 0ull, hi = 0ull;
    int held = 0;   // samples a lane's fields may hold: the same in every lane
    for (int base = begin; base < end; base += kThreads * kBatch) {
        int ix[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
            const int j = base + k * kThreads + threadIdx.x;
            ix[k] = j < end ? __ldg(index + j) : -1;
        }
        float v[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
            v[k] = ix[k] >= 0 ? __ldg(src + ix[k]) : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
            if (ix[k] >= 0) count(v[k], lo, hi);
        }
        held += kBatch;
        if (held + kBatch > kFieldMax) {
            flush(lo, hi, s_hist);
            lo = hi = 0ull;
            held = 0;
        }
    }
    flush(lo, hi, s_hist);
    __syncthreads();
    if (threadIdx.x < kBins) {
        int* dst = hist + row * kBins + threadIdx.x;
        const int got = static_cast<int>(s_hist[threadIdx.x]);
        if (chunks == 1) {
            *dst = got;
        } else if (got) {
            atomicAdd(dst, got);
        }
    }
}
}  // namespace

// llr (B, ·) float32 rows `ld` floats apart, index (n,) int32 in [0, row
// length), hist (B, 16) int32 — zeroed by the caller where chunk < n; a
// block counts `chunk` samples of one row.
GF3X_EXPORT int gf3x_llr_hist(const float* llr, const int* index, int* hist,
                              long long B, long long ld, int n, int chunk,
                              void* stream) {
    if (n <= 0 || chunk <= 0 || ld < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int chunks = (n + chunk - 1) / chunk;
    if (B > 0) {
        llr_hist_kernel<<<static_cast<unsigned>(B * chunks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
            llr, index, hist, ld, n, chunk, chunks);
    }
    return static_cast<int>(cudaGetLastError());
}
