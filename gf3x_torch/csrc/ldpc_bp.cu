// Layered normalised min-sum decoding of the QC-LDPC family (24 block
// columns, rates 1/2 to 5/6) in two passes: a check pass over every
// codeword, then a decode pass over the codewords that fail it.
//
// Replaces gf3x/ops/pallas/ldpc_bp.py:minsum_totals_tpu. It must be
// bit-identical to LdpcCode._minsum_xla (gf3x/fec/ldpc.py:301) and to the
// plain PyTorch version beside its wrapper: the same block-row order,
// argmin ties broken by the first edge, m2 over the other edges,
// new = (α·(prod·sgn))·mins with α = 0.8, delta = new − c2v, c2v += delta,
// and the freeze rule (a codeword whose hard decisions satisfy every check
// before a sweep stops updating; passes count the sweeps it ran). Every
// rounding is written out with __fmul_rn/__fadd_rn/__fsub_rn, and the
// library is built with --fmad=false, so no multiply-add is contracted.
//
// The split rests on the freeze rule: each codeword decodes independently
// of the rest of the batch, so decoding only the codewords that fail the
// first check, and writing their results in place, gives the same totals,
// unsat flags and passes as decoding the whole batch.
//
// Check pass (minsum_check_kernel), a warp per codeword. What bounds it:
// bytes, the LLRs once in and the totals (a copy of the LLRs) once out,
// 75.5 MB at 4096 × 2304 (0.0225 ms at 3.35 TB/s). The lanes move them as
// 16-byte vectors and keep only the hard decisions, a byte each (2.3 KB a
// codeword), in shared memory, so many codewords are resident per SM.
// Where z % 32 = 0 it packs them into bit words and finds a block row's 32
// checks at once (row_word_bad): one check per lane left about 10 µs of
// unhidden syndrome work at 4096 codewords. A codeword that satisfies
// every check is final (passes 0, unsat 0); one that fails is appended to
// a device work list, or, with iters = 0, is final with unsat 1. At 20 dB,
// the main paths' case, that is the whole function.
//
// Decode pass (minsum_decode_kernel), a persistent grid of resident blocks
// that pull codewords from the work list through a device counter, so the
// call needs no host synchronisation and an empty list costs one wave of
// blocks that exit. A block decodes one codeword at a time with one thread
// per check of a block row (z threads); the c2v messages (E·z floats, 29
// KB at rate 1/2, z = 96) and the column totals (24·z floats) stay in
// shared memory for all sweeps. What bounds it: the serial layer schedule.
// Each block row depends on the totals the previous row wrote, so a sweep
// is mb rounds separated by __syncthreads(), and their shared-memory
// traffic and instruction issue (about 15 warps fit an SM, by shared
// memory). A row's update is compiled for its exact degree (a switch over
// 1 ≤ d ≤ kMaxDeg): a thread issues all of its d total and message loads
// before the min search, keeps them and their addresses in registers for
// the update, finds (min, first argmin, second min) by a tree of pairwise
// combines (the same values as the sequential scan, in log2 d steps) and
// takes the sign product as a parity of sign bits (exact: a product of
// ±1). The edge tables (block column × z, shift) sit in the kernels'
// parameter bank, where the constant cache broadcasts the entry every
// thread reads, not in shared memory; the first check is the check pass's,
// and the check after each sweep packs the totals' signs by ballots and
// takes a block row's 32 checks per thread where z % 32 = 0.
// Within a block row each circulant column appears once, so thread c reads
// and writes total (c + s) mod z of each column it touches and no two
// threads of a row collide.
//
// Every lift z ≥ 1 runs, as gf3x's kernel and XLA twin do. The layouts
// above are those of z ≤ 512 (one check a thread, everything in shared
// memory; decode layout 0) and z ≤ 1076 (eight codewords a check block).
// Past them the wrapper (ops/kernels/ldpc_bp.py: decode_geometry,
// check_warps) picks, and the entries take, these:
// - decode layout 1 (z > 512): a block of T ≤ 512 threads (a multiple of
//   32), thread t taking checks t, t + T, ... of each block row. The rows
//   of a block row are independent and each is updated by the same code,
//   so the layer order and every rounding are layout 0's: the same bits.
// - decode layout 2: where (E + 24)·z floats and the bit words no longer
//   fit a block's 227 KB (z > 576 at rate 1/2, 647 at 2/3, 633 at 3/4,
//   619 at 5/6), the totals stay in shared memory and the c2v messages go
//   to a global scratch, one slice of E·z floats per resident block (the
//   wrapper allocates grid × slice on the caller's stream; only check c
//   ever reads or writes its messages, so they need no barrier of their
//   own).
// - decode layout 3: where the totals and bit words no longer fit either
//   (z ≥ 2348), the totals are the codeword's row of the output, which the
//   check pass has filled with its LLRs, and the bit words join c2v in the
//   scratch slice.
// - check pass: fewer codewords a block where eight warps' hard decisions
//   exceed 227 KB, down to one (z ≤ 8609); past that one warp reads the
//   hard decisions as the signs of the totals it has just written to
//   global memory.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBlockCols = 24;
constexpr int kMaxRows = 12;     // block rows at rate 1/2
constexpr int kMaxEdges = 96;    // edges of a base matrix: 76 at most
constexpr int kMaxDeg = 18;      // the largest block-row degree over RATES
constexpr int kCheckWarps = 8;   // codewords per block of the check pass
constexpr int kChunk = 18;       // 16-byte loads a lane keeps in flight
constexpr int kLaneChecks = 3;   // checks of a block row per lane, in turn
constexpr int kMaxThreads = 512; // the decode pass's block: at most 512
// the largest lift whose indices fit an int: a scratch slice of
// (kMaxEdges + 1)·z floats, 27·z bytes of hard decisions
constexpr int kMaxLift = 0x7fffffff / 128;
constexpr float kAlpha = 0.8f;
constexpr float kBig = 1e30f;

// The lifted code's edges, row-major as build_H_blocks orders them, passed
// by value into the kernels' parameter bank.
struct Code {
    int mb, E, z;
    int row_ptr[kMaxRows + 1];   // first edge of each block row
    int colz[kMaxEdges];         // block column × z of each edge
    int shift[kMaxEdges];        // circulant shift of each edge
};

// The work list: work[0] counts the queued codewords, work[1] is the
// decode pass's next index into them, work[2 ...] are their indices.

// v mod z for 0 ≤ v < 2z
__device__ __forceinline__ int wrap(int v, int z) {
    return static_cast<int>(min(static_cast<unsigned>(v),
                                static_cast<unsigned>(v - z)));
}

__device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Four hard-decision bytes (each 0 or 1, little-endian in x) as bits 0-3:
// the multiply puts byte k at bit 21 + k with no carry into bits 21-24.
__device__ __forceinline__ unsigned pack4(unsigned x) {
    return ((x * 0x00204081u) >> 21) & 0xFu;
}

// Sixteen hard-decision bytes as bits 0-15.
__device__ __forceinline__ unsigned pack16(uint4 q) {
    return pack4(q.x) | pack4(q.y) << 4 | pack4(q.z) << 8 | pack4(q.w) << 12;
}

// Where z % 32 = 0 the hard decisions are also kept as bit words, word k
// holding variables 32k ... 32k + 31, and block row i's checks c0 ...
// c0 + 31 (c0 a multiple of 32) are one word: the XOR over its edges of
// the column's bits from (c0 + s) mod z on, which a funnel shift of two
// neighbouring words gives (the column's last word wraps to its first).
// True where any of the 32 checks is violated.
__device__ __forceinline__ bool row_word_bad(const unsigned* words,
                                             const Code& code, int i, int c0,
                                             int z) {
    const int cw_words = z >> 5;
    unsigned par = 0;
    for (int e = code.row_ptr[i]; e < code.row_ptr[i + 1]; ++e) {
        const int p = wrap(c0 + code.shift[e], z), q = p >> 5;
        const unsigned* col = words + (code.colz[e] >> 5);
        par ^= __funnelshift_r(col[q], col[q + 1 == cw_words ? 0 : q + 1],
                               p & 31);
    }
    return par != 0;
}

// Shared memory per warp of the check pass: the hard decisions as bytes
// (24·z), then as bit words (3·z bytes), rounded up to 16 bytes.
__host__ __device__ __forceinline__ int check_stride(int z) {
    return (27 * z + 15) & ~15;
}

// The check pass's layouts: eight warps a block with the hard decisions in
// shared memory (z ≤ 1076), fewer warps a block (blockDim.x / 32), or one
// warp reading them from the totals it wrote (kCheckGlobal).
enum CheckLayout { kCheckEight, kCheckFew, kCheckGlobal };

template <int kLayout>
__global__ void __launch_bounds__(32 * kCheckWarps)
minsum_check_kernel(const float* __restrict__ lam, float* __restrict__ totals,
                    unsigned char* __restrict__ unsat,
                    int* __restrict__ passes, int* __restrict__ work,
                    const __grid_constant__ Code code, long long L,
                    int iters) {
    extern __shared__ __align__(16) unsigned char hard_sm[];
    const int z = code.z, n = kBlockCols * z, n4 = n / 4;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int warps = kLayout == kCheckEight ? kCheckWarps
                                             : static_cast<int>(blockDim.x >> 5);
    const long long cw = static_cast<long long>(blockIdx.x) * warps + w;
    if (cw >= L) return;   // the whole warp
    if constexpr (kLayout == kCheckGlobal) {
        // the LLRs to the totals, then the hard decisions as their signs
        const float* src = lam + cw * n;
        float* dst = totals + cw * n;
        for (int i = lane; i < n; i += 32) dst[i] = src[i];
        __syncwarp();
        int bad = 0;
        for (int i = 0; i < code.mb; ++i) {
            for (int c = lane; c < z; c += 32) {
                int par = 0;
                for (int e = code.row_ptr[i]; e < code.row_ptr[i + 1]; ++e)
                    par ^= dst[code.colz[e] + wrap(c + code.shift[e], z)] < 0.0f
                               ? 1 : 0;
                bad |= par;
            }
        }
        bad = __any_sync(0xffffffffu, bad);
        if (lane == 0) {
            unsat[cw] = bad ? 1 : 0;
            passes[cw] = 0;
            if (bad && iters > 0) work[2 + atomicAdd(work, 1)] = static_cast<int>(cw);
        }
        return;
    }
    // the warp's hard decisions: n bytes, then n / 32 bit words
    unsigned char* hard = hard_sm + static_cast<size_t>(w) * check_stride(z);
    const float* src = lam + cw * n;
    float* dst = totals + cw * n;   // rows of 96·z bytes: 16-byte aligned
    if (aligned16(lam)) {
        const float4* s4 = reinterpret_cast<const float4*>(src);
        float4* d4 = reinterpret_cast<float4*>(dst);
        uchar4* h4 = reinterpret_cast<uchar4*>(hard);
        for (int base = 0; base < n4; base += 32 * kChunk) {
            float4 v[kChunk];
#pragma unroll
            for (int j = 0; j < kChunk; ++j) {
                const int i = base + 32 * j + lane;
                if (i < n4) v[j] = s4[i];
            }
#pragma unroll
            for (int j = 0; j < kChunk; ++j) {
                const int i = base + 32 * j + lane;
                if (i < n4) {
                    d4[i] = v[j];
                    h4[i] = make_uchar4(v[j].x < 0.0f, v[j].y < 0.0f,
                                        v[j].z < 0.0f, v[j].w < 0.0f);
                }
            }
        }
    } else {
        for (int i = lane; i < n; i += 32) {
            const float v = src[i];
            dst[i] = v;
            hard[i] = v < 0.0f;
        }
    }
    __syncwarp();
    // check c of block row i reads variable (c + s) mod z of each column
    int bad = 0;
    if ((z & 31) == 0) {
        unsigned* words = reinterpret_cast<unsigned*>(hard + n);
        for (int k = lane; k < n / 32; k += 32) {
            const uint4* b = reinterpret_cast<const uint4*>(hard + 32 * k);
            words[k] = pack16(b[0]) | pack16(b[1]) << 16;
        }
        __syncwarp();
        const int items = code.mb * (z >> 5);   // (row, 32 checks)
        for (int t = lane; t < items; t += 32) {
            const int i = t / (z >> 5);
            bad |= row_word_bad(words, code, i, 32 * (t - i * (z >> 5)), z);
        }
    } else {
        // a lane takes checks lane, lane + 32, lane + 64 of a row at a time
        for (int c0 = lane; c0 < z; c0 += 32 * kLaneChecks) {
            for (int i = 0; i < code.mb; ++i) {
                int par[kLaneChecks] = {};
                for (int e = code.row_ptr[i]; e < code.row_ptr[i + 1]; ++e) {
                    const unsigned char* hc = hard + code.colz[e];
                    const int s = code.shift[e];
#pragma unroll
                    for (int t = 0; t < kLaneChecks; ++t) {
                        const int c = c0 + 32 * t;
                        if (c < z) par[t] ^= hc[wrap(c + s, z)];
                    }
                }
#pragma unroll
                for (int t = 0; t < kLaneChecks; ++t) bad |= par[t];
            }
        }
    }
    bad = __any_sync(0xffffffffu, bad);
    if (lane == 0) {
        unsat[cw] = bad ? 1 : 0;
        passes[cw] = 0;
        if (bad && iters > 0) work[2 + atomicAdd(work, 1)] = static_cast<int>(cw);
    }
}

// True for every thread of the block when any parity check of the current
// hard decisions is violated. Where z % 32 = 0 each warp packs its share
// of the totals' signs into bit words by ballots, and a thread takes a
// (row, 32 checks) word; otherwise thread c takes check c of every row
// (kOneRow: the block has z threads) or checks c, c + blockDim.x, ...
template <bool kOneRow>
__device__ __forceinline__ bool unsatisfied(const float* tot, unsigned* words,
                                            const Code& code, int z) {
    const int c = threadIdx.x;
    int bad = 0;
    if ((z & 31) == 0) {
        const int lane = c & 31, nk = kBlockCols * z / 32;
        for (int k = c >> 5; k < nk; k += blockDim.x >> 5) {
            const unsigned b = __ballot_sync(0xffffffffu,
                                             tot[32 * k + lane] < 0.0f);
            if (lane == 0) words[k] = b;
        }
        __syncthreads();
        const int items = code.mb * (z >> 5);
        for (int t = c; t < items; t += blockDim.x) {
            const int i = t / (z >> 5);
            bad |= row_word_bad(words, code, i, 32 * (t - i * (z >> 5)), z);
        }
    } else {
        for (int r = c; r < z; r += blockDim.x) {
            for (int i = 0; i < code.mb; ++i) {
                int par = 0;
                for (int e = code.row_ptr[i]; e < code.row_ptr[i + 1]; ++e)
                    par ^= tot[code.colz[e] + wrap(r + code.shift[e], z)] < 0.0f ? 1 : 0;
                bad |= par;
            }
            if (kOneRow) break;   // blockDim.x = z
        }
    }
    return __syncthreads_or(bad) != 0;
}

// The sequential scan's (min, first argmin, min over the others) of
// mag[LO, LO + N), by a tree: a pair (a, b), b after a, combines to b's
// minimum only where it is strictly smaller, so ties keep the first edge,
// and every value is one of the inputs.
struct MinSearch {
    float m1, m2;
    int am;
};

template <int LO, int N>
__device__ __forceinline__ MinSearch min_search(const float* mag) {
    if constexpr (N == 1) {
        return MinSearch{mag[LO], kBig, LO};
    } else {
        const MinSearch a = min_search<LO, N / 2>(mag);
        const MinSearch b = min_search<LO + N / 2, N - N / 2>(mag);
        return b.m1 < a.m1 ? MinSearch{b.m1, fminf(a.m1, b.m2), b.am}
                           : MinSearch{a.m1, fminf(a.m2, b.m1), a.am};
    }
}

// One block row of degree D, edges e0 ..., updated by thread c: the
// loads first, then the min search and the update on registers. The
// message is (α·(prod·sgn))·mins; prod·sgn is ±1, so it equals
// (±α)·mins with the sign taken from the parity of the negative v2c.
template <int D>
__device__ __forceinline__ void update_row(float* tot, float* c2v,
                                           const Code& code, int e0, int c,
                                           int z) {
    int ti[D];
    float tt[D], old[D], mag[D];
    float* cv = c2v + e0 * z + c;
#pragma unroll
    for (int k = 0; k < D; ++k) {
        ti[k] = code.colz[e0 + k] + wrap(c + code.shift[e0 + k], z);
        tt[k] = tot[ti[k]];
        old[k] = cv[k * z];
    }
    unsigned neg = 0;   // bit k: v2c k < 0
#pragma unroll
    for (int k = 0; k < D; ++k) {
        const float v = __fsub_rn(tt[k], old[k]);
        mag[k] = fabsf(v);
        neg |= (v < 0.0f ? 1u : 0u) << k;
    }
    const MinSearch ms = min_search<0, D>(mag);
    const unsigned prod_neg = __popc(neg) & 1u;
#pragma unroll
    for (int k = 0; k < D; ++k) {
        const float mins = k == ms.am ? ms.m2 : ms.m1;
        const float a = ((neg >> k) & 1u) != prod_neg ? -kAlpha : kAlpha;
        const float delta = __fsub_rn(__fmul_rn(a, mins), old[k]);
        cv[k * z] = __fadd_rn(old[k], delta);
        tot[ti[k]] = __fadd_rn(tt[k], delta);
    }
}

#define GF3X_ROW(D)                                             \
    case D:                                                     \
        if (kOneRow) {                                          \
            update_row<D>(tot, c2v, code, e0, c, z);            \
        } else {                                                \
            for (int r = c; r < z; r += blockDim.x)             \
                update_row<D>(tot, c2v, code, e0, r, z);        \
        }                                                       \
        break;

// One sweep's block rows, each compiled for its degree; thread c updates
// check c of each (kOneRow) or checks c, c + blockDim.x, ...
template <bool kOneRow>
__device__ __forceinline__ void sweep(float* tot, float* c2v, const Code& code,
                                      int c, int z) {
    for (int i = 0; i < code.mb; ++i) {
        const int e0 = code.row_ptr[i];
        switch (code.row_ptr[i + 1] - e0) {
            GF3X_ROW(1) GF3X_ROW(2) GF3X_ROW(3) GF3X_ROW(4) GF3X_ROW(5)
            GF3X_ROW(6) GF3X_ROW(7) GF3X_ROW(8) GF3X_ROW(9) GF3X_ROW(10)
            GF3X_ROW(11) GF3X_ROW(12) GF3X_ROW(13) GF3X_ROW(14)
            GF3X_ROW(15) GF3X_ROW(16) GF3X_ROW(17) GF3X_ROW(18)
            default: break;   // make_code refuses a degree above kMaxDeg
        }
        __syncthreads();
    }
}

#undef GF3X_ROW

// The decode pass's layouts (see the top of the file).
enum DecodeLayout { kOneCheck, kRowsShared, kC2vGlobal, kAllGlobal };

// Dynamic shared memory: the totals (24·z floats), c2v (E·z), then the
// hard decisions' bit words (24·z / 32, used where z % 32 = 0); with
// kC2vGlobal the totals and the bit words (c2v in the block's slice of
// `scratch`); with kAllGlobal none (c2v, then the bit words, in the slice;
// the totals in place in the output row).
template <int kLayout>
__global__ void __launch_bounds__(kMaxThreads)
minsum_decode_kernel(const float* __restrict__ lam, float* __restrict__ totals,
                     unsigned char* __restrict__ unsat,
                     int* __restrict__ passes_out, int* __restrict__ work,
                     float* __restrict__ scratch,
                     unsigned long long* __restrict__ counts,
                     const __grid_constant__ Code code, int iters) {
    constexpr bool kOneRow = kLayout == kOneCheck;
    extern __shared__ __align__(16) float sm[];
    __shared__ int s_cw;
    const int z = code.z, n = kBlockCols * z, n4 = n / 4, ez = code.E * z;
    float* slice = kLayout < kC2vGlobal ? nullptr
        : scratch + static_cast<size_t>(blockIdx.x) *
                        (kLayout == kAllGlobal ? ez + n / 32 + 1 : ez);
    float* tot = sm;
    float* c2v = kLayout >= kC2vGlobal ? slice : sm + n;
    unsigned* words = reinterpret_cast<unsigned*>(
        kLayout == kAllGlobal ? slice + ez
                              : (kLayout == kC2vGlobal ? sm + n : c2v + ez));
    const int c = threadIdx.x;
    const bool vec = aligned16(lam);
    long long swept = 0;   // thread 0: the passes of this block's codewords
    for (;;) {
        if (c == 0) {
            const int i = atomicAdd(work + 1, 1);
            s_cw = i < work[0] ? work[2 + i] : -1;
        }
        __syncthreads();
        const long long cw = s_cw;
        if (cw < 0) {   // every thread read the same s_cw
            if (counts != nullptr && c == 0) {
                if (blockIdx.x == 0)
                    atomicAdd(counts, static_cast<unsigned long long>(work[0]));
                if (swept > 0)
                    atomicAdd(counts + 1, static_cast<unsigned long long>(swept));
            }
            return;
        }
        if constexpr (kLayout == kAllGlobal) {
            // the check pass copied the LLRs into the totals
            tot = totals + cw * n;
        } else if (vec) {
            const float4* s4 = reinterpret_cast<const float4*>(lam + cw * n);
            for (int i = c; i < n4; i += blockDim.x)
                reinterpret_cast<float4*>(tot)[i] = s4[i];
        } else {
            for (int i = c; i < n; i += blockDim.x) tot[i] = lam[cw * n + i];
        }
        for (int i = c; i < ez; i += blockDim.x) c2v[i] = 0.0f;
        __syncthreads();

        // the check pass found this codeword unsatisfied, and iters > 0
        int passes = 0;
        bool bad = true;
        while (bad && passes < iters) {
            sweep<kOneRow>(tot, c2v, code, c, z);
            ++passes;
            bad = unsatisfied<kOneRow>(tot, words, code, z);
        }
        if constexpr (kLayout != kAllGlobal) {
            float4* d4 = reinterpret_cast<float4*>(totals + cw * n);
            for (int i = c; i < n4; i += blockDim.x)
                d4[i] = reinterpret_cast<const float4*>(tot)[i];
        }
        if (c == 0) {
            unsat[cw] = bad ? 1 : 0;
            passes_out[cw] = passes;
            swept += passes;
        }
        // tot and the slice are rewritten only after the next pull's barrier
    }
}

// The code from the host's edge tables; false where it exceeds the
// parameter bank's arrays, a block-row degree is outside 1 ... kMaxDeg or
// z is outside 1 ... kMaxLift.
bool make_code(const int* row_ptr, const int* col, const int* shift, int mb,
               int E, int z, Code* code) {
    if (mb < 1 || mb > kMaxRows || E < 1 || E > kMaxEdges || z < 1
        || z > kMaxLift || row_ptr[0] != 0
        || row_ptr[mb] != E)
        return false;
    code->mb = mb;
    code->E = E;
    code->z = z;
    for (int i = 0; i <= mb; ++i) {
        code->row_ptr[i] = row_ptr[i];
        const int d = i > 0 ? row_ptr[i] - row_ptr[i - 1] : 1;
        if (d < 1 || d > kMaxDeg) return false;
    }
    for (int e = 0; e < E; ++e) {
        code->colz[e] = col[e] * z;
        code->shift[e] = shift[e];
    }
    return true;
}

const void* decode_kernel(int layout) {
    switch (layout) {
    case kOneCheck: return reinterpret_cast<const void*>(minsum_decode_kernel<kOneCheck>);
    case kRowsShared: return reinterpret_cast<const void*>(minsum_decode_kernel<kRowsShared>);
    case kC2vGlobal: return reinterpret_cast<const void*>(minsum_decode_kernel<kC2vGlobal>);
    case kAllGlobal: return reinterpret_cast<const void*>(minsum_decode_kernel<kAllGlobal>);
    default: return nullptr;
    }
}

const void* check_kernel(int layout) {
    switch (layout) {
    case kCheckEight: return reinterpret_cast<const void*>(minsum_check_kernel<kCheckEight>);
    case kCheckFew: return reinterpret_cast<const void*>(minsum_check_kernel<kCheckFew>);
    case kCheckGlobal: return reinterpret_cast<const void*>(minsum_check_kernel<kCheckGlobal>);
    default: return nullptr;
    }
}

}  // namespace

// The check pass: `warps` codewords a block (8 where z ≤ 1076; the wrapper's
// check_warps), 0 for one warp with the hard decisions in global memory.
GF3X_EXPORT int gf3x_minsum_check(const float* lam, float* totals,
                                  unsigned char* unsat, int* passes,
                                  int* work, const int* row_ptr,
                                  const int* col, const int* shift,
                                  long long L, int mb, int E, int z,
                                  int iters, int warps, void* stream) {
    Code code;
    if (!make_code(row_ptr, col, shift, mb, E, z, &code) || warps < 0
        || warps > kCheckWarps)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(work, 0, 2 * sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int layout = warps == 0 ? kCheckGlobal
                                  : (warps == kCheckWarps ? kCheckEight : kCheckFew);
    const int per_block = warps == 0 ? 1 : warps;
    const size_t smem = static_cast<size_t>(warps) * check_stride(z);
    static size_t smem_set[3][kMaxDevices] = {};
    err = gf3x_allow_smem(check_kernel(layout), smem, smem_set[layout]);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (L > 0) {
        const long long blocks = (L + per_block - 1) / per_block;
        const dim3 grid(static_cast<unsigned>(blocks)), block(32 * per_block);
        switch (layout) {
        case kCheckEight:
            minsum_check_kernel<kCheckEight><<<grid, block, smem, s>>>(
                lam, totals, unsat, passes, work, code, L, iters);
            break;
        case kCheckFew:
            minsum_check_kernel<kCheckFew><<<grid, block, smem, s>>>(
                lam, totals, unsat, passes, work, code, L, iters);
            break;
        default:
            minsum_check_kernel<kCheckGlobal><<<grid, block, smem, s>>>(
                lam, totals, unsat, passes, work, code, L, iters);
            break;
        }
    }
    return static_cast<int>(cudaGetLastError());
}

// Blocks of the decode kernel of `layout` (threads, smem bytes) resident
// on the current device at once, into out[0]: the wrapper's grid is the
// smaller of this and the codewords, and the scratch has a slice per block.
GF3X_EXPORT int gf3x_minsum_decode_blocks(int* out, int layout, int threads,
                                          int smem, void* stream) {
    (void)stream;
    const void* fn = decode_kernel(layout);
    if (fn == nullptr || threads < 1 || threads > kMaxThreads || smem < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    static size_t smem_set[4][kMaxDevices] = {};
    err = gf3x_allow_smem(fn, smem, smem_set[layout]);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = sms * (per_sm > 0 ? per_sm : 1);
    return 0;
}

// The decode pass over the check pass's work list: `grid` blocks of
// `threads` in `layout` with `smem` bytes (the wrapper's decode_geometry
// and gf3x_minsum_decode_blocks), c2v (and, kAllGlobal, the bit words) in
// `scratch`, a slice per block. `counts`, null or two 64-bit counters the
// launch adds to: block 0 the codewords queued (work[0]), each block the
// passes of the codewords it decoded, one atomic each as it exits; null,
// the kernel counts nothing and its work and outputs are the same.
GF3X_EXPORT int gf3x_minsum_decode(const float* lam, float* totals,
                                   unsigned char* unsat, int* passes,
                                   int* work, float* scratch,
                                   long long* counts,
                                   const int* row_ptr, const int* col,
                                   const int* shift, long long L, int mb,
                                   int E, int z, int iters, int layout,
                                   int threads, int smem, int grid,
                                   void* stream) {
    Code code;
    const void* fn = decode_kernel(layout);
    if (!make_code(row_ptr, col, shift, mb, E, z, &code) || fn == nullptr
        || threads < 1 || threads > kMaxThreads || smem < 0 || grid < 0
        || (layout == kOneCheck && threads != z)
        || (layout != kOneCheck && threads % 32 != 0)
        || (layout >= kC2vGlobal && grid > 0 && scratch == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    static size_t smem_set[4][kMaxDevices] = {};
    const cudaError_t err = gf3x_allow_smem(fn, smem, smem_set[layout]);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (grid > 0) {
        switch (layout) {
        case kOneCheck:
            minsum_decode_kernel<kOneCheck><<<grid, threads, smem, s>>>(
                lam, totals, unsat, passes, work, scratch,
                reinterpret_cast<unsigned long long*>(counts), code, iters);
            break;
        case kRowsShared:
            minsum_decode_kernel<kRowsShared><<<grid, threads, smem, s>>>(
                lam, totals, unsat, passes, work, scratch,
                reinterpret_cast<unsigned long long*>(counts), code, iters);
            break;
        case kC2vGlobal:
            minsum_decode_kernel<kC2vGlobal><<<grid, threads, smem, s>>>(
                lam, totals, unsat, passes, work, scratch,
                reinterpret_cast<unsigned long long*>(counts), code, iters);
            break;
        default:
            minsum_decode_kernel<kAllGlobal><<<grid, threads, smem, s>>>(
                lam, totals, unsat, passes, work, scratch,
                reinterpret_cast<unsigned long long*>(counts), code, iters);
            break;
        }
    }
    return static_cast<int>(cudaGetLastError());
}
