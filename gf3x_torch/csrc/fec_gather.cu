// The FEC gather: scrambled wire-order LLRs (B, raw_bits) → descrambled LLRs
// in codeword order (B, used), used = n_codewords · n, in one pass:
//
//   out[b, j] = llr[b, index[j]] · (1 − 2·scramble[j])
//
// `index` is the deinterleaver's first `used` entries (int32) and `scramble`
// the descrambler's bits, one byte each, in codeword order.
//
// Replaces no TPU kernel: gf3x leaves this to XLA as one static gather times
// the sign (gf3x/models/modem.py:332-369). The port ran it as aten's index
// kernel and a separate multiply, two passes over the LLRs.
//
// What bounds it on the card: bytes, 8·B·used (at gf3-8192, B = 1024: 1.93
// GB, 0.575 ms at 3.35 TB/s). Both kernels write in codeword order, so
// neighbouring threads store neighbouring outputs, and flip the sign by an
// XOR of the sign bit: exact, bit for bit the plain version's multiply by
// ±1.0.
//
// - `fec_gather_kernel`, any index: a block walks `chunk` outputs of one
//   row, a thread four at a time (one 16-byte load of their indices, one
//   4-byte load of their sign bytes, one 16-byte store); the reads follow
//   the permutation. Where neighbouring outputs read far-apart inputs, each
//   4-byte read costs a 32-byte sector: on an H100 at gf3-8192 it took 2.06
//   ms at the best chunk, the cost of aten's index kernel.
// - `fec_gather_tile_kernel`, where the index is the reversal of three axes
//   — input (D, B2, A2) read as output (A2, B2, D), which is what gf3x's
//   interleaver inverts to (symbol d, bin-scatter row b2, column a2) — a
//   block moves one tile, 16 columns by TB rows by all D symbols, through
//   shared memory: it reads D·TB runs of 16 contiguous inputs (64 bytes, on
//   a 64-byte boundary at gf3-8192) and writes 16 runs of TB·D contiguous
//   outputs. Every input byte is read once. Where D, A2 and used are
//   multiples of 4 (gf3-8192, not config 5) it moves float4s both ways; a
//   column's pitch of 4 mod 32 floats keeps the float4 reads aligned and
//   the transposing stores at most two to a bank. At gf3-8192, B = 1024 it
//   took 669 µs on an H100 (1.16 × the bound; one float at a time 851, with
//   a division per element 1286).
//
// The wrapper (ops/kernels/fec_gather.py) picks the kernel and its grid from
// the shapes: `fec_gather_chunk` and `fec_gather_tiles` spread each row over
// as many blocks as fill the card, for one recording and for 1024.
#include <cstdint>

#include "common.cuh"

namespace {
constexpr int kThreads = 256;
constexpr int kVec = 4;                      // outputs a thread stores at once
constexpr int kPass = kThreads * kVec;       // outputs a block covers a pass
constexpr int kLoads = 4;                    // a tile thread's loads in flight
constexpr int kTileA = 16;                   // a tile's columns: 64-byte runs

__device__ __forceinline__ float flip(float v, unsigned s) {
    return __uint_as_float(__float_as_uint(v) ^ ((s & 1u) << 31));
}

__global__ void __launch_bounds__(kThreads)
fec_gather_kernel(const float* __restrict__ llr, const int* __restrict__ index,
                  const unsigned char* __restrict__ scramble,
                  float* __restrict__ out, long long ld, int used, int chunk,
                  int chunks) {
    const long long row = blockIdx.x / chunks;
    const int begin = (blockIdx.x % chunks) * chunk;
    const int end = min(begin + chunk, used);
    const float* src = llr + row * ld;
    float* dst = out + row * used;
#pragma unroll 4
    for (int j = begin + threadIdx.x * kVec; j < end; j += kPass) {
        const int4 ix = __ldg(reinterpret_cast<const int4*>(index + j));
        const unsigned s =
            __ldg(reinterpret_cast<const unsigned*>(scramble + j));
        float4 v;
        v.x = flip(__ldg(src + ix.x), s);
        v.y = flip(__ldg(src + ix.y), s >> 8);
        v.z = flip(__ldg(src + ix.z), s >> 16);
        v.w = flip(__ldg(src + ix.w), s >> 24);
        *reinterpret_cast<float4*>(dst + j) = v;
    }
}

// Block (row, ta, tb) of a grid of B · ceil(A2/16) · ceil(B2/TB): columns
// a0 = ta·16 .. +16, rows b0 = tb·TB .. +TB, every symbol d. Staged as
// tile[a][j], j = b·D + d: column a's output run, `pitch` floats apart.
// kVec (D, A2 and used multiples of 4, rows 16-byte aligned): a thread
// loads four neighbouring columns as one float4 and stores four outputs as
// one; else one float at a time. A thread keeps its columns and steps
// through j by a fixed stride, carrying (b, d) and, storing, (c, j) by
// one compare: no division in the loops.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
fec_gather_tile_kernel(const float* __restrict__ llr,
                       const unsigned char* __restrict__ scramble,
                       float* __restrict__ out, long long ld, int used, int D,
                       int B2, int A2, int TB, int tiles_a, int tiles_b,
                       int pitch) {
    extern __shared__ float tile[];          // [kTileA][pitch]
    constexpr int kW = kVec ? 4 : 1;         // columns a thread loads
    constexpr int kLanes = kTileA / kW;      // threads across a tile's row
    constexpr int kStep = kThreads / kLanes; // j a thread steps by, loading
    const int per_row = tiles_a * tiles_b;
    const long long row = blockIdx.x / per_row;
    const int t = blockIdx.x % per_row;
    const int a0 = (t % tiles_a) * kTileA, b0 = (t / tiles_a) * TB;
    const int na = min(kTileA, A2 - a0), nb = min(TB, B2 - b0);
    const int run = nb * D;                  // contiguous outputs per column
    const long long R = static_cast<long long>(B2) * A2;
    const int a = (threadIdx.x % kLanes) * kW;
    // inputs (d, b0 + b, a0 + a ..): D·nb runs of na, kLoads loads in
    // flight a thread before their stores
    if (a < na) {
        const float* src = llr + row * ld + static_cast<long long>(b0) * A2
                           + a0 + a;
        const int sb = kStep / D, sd = kStep % D;
        int j = threadIdx.x / kLanes;
        int b = j / D, d = j % D;
        while (j < run) {
            float v[kLoads][kW];
            int at[kLoads];
#pragma unroll
            for (int k = 0; k < kLoads; ++k) {
                at[k] = -1;
                if (j < run) {
                    at[k] = j;
                    const float* p = src + d * R + b * A2;
                    if constexpr (kVec) {
                        const float4 x =
                            __ldg(reinterpret_cast<const float4*>(p));
                        v[k][0] = x.x;
                        v[k][1] = x.y;
                        v[k][2] = x.z;
                        v[k][3] = x.w;
                    } else {
                        v[k][0] = __ldg(p);
                    }
                    j += kStep;
                    b += sb;
                    d += sd;
                    if (d >= D) {
                        d -= D;
                        ++b;
                    }
                }
            }
#pragma unroll
            for (int k = 0; k < kLoads; ++k) {
                if (at[k] >= 0) {
#pragma unroll
                    for (int w = 0; w < kW; ++w) {
                        tile[(a + w) * pitch + at[k]] = v[k][w];
                    }
                }
            }
        }
    }
    __syncthreads();
    // outputs (a0 + c, b0 + b, d): na runs of nb·D, each below `used`
    float* dst = out + row * used + static_cast<long long>(b0) * D;
    const unsigned char* sgn = scramble + static_cast<long long>(b0) * D;
    const long long col = static_cast<long long>(B2) * D;
    constexpr int kOut = kThreads * kW;      // j a thread steps by, storing
    const int sc = kOut / run, sj = kOut % run;
    int c = threadIdx.x * kW / run, j = threadIdx.x * kW % run;
    while (c < na) {
        const long long o = (a0 + c) * col + j;
        if (o + static_cast<long long>(b0) * D < used) {
            const float* x = tile + c * pitch + j;
            if constexpr (kVec) {
                const float4 y = *reinterpret_cast<const float4*>(x);
                const unsigned s = *reinterpret_cast<const unsigned*>(sgn + o);
                *reinterpret_cast<float4*>(dst + o) = make_float4(
                    flip(y.x, s), flip(y.y, s >> 8), flip(y.z, s >> 16),
                    flip(y.w, s >> 24));
            } else {
                dst[o] = flip(*x, sgn[o]);
            }
        }
        c += sc;
        j += sj;
        if (j >= run) {
            j -= run;
            ++c;
        }
    }
}
}  // namespace

// llr: B rows of `ld` floats; index (used,) int32 in [0, ld), 16-byte
// aligned; scramble (≥ used,) bytes of 0 or 1, 4-byte aligned; out (B, used)
// float32, 16-byte aligned; used and chunk multiples of 4.
GF3X_EXPORT int gf3x_fec_gather(const float* llr, const int* index,
                                const unsigned char* scramble, float* out,
                                long long B, long long ld, int used, int chunk,
                                void* stream) {
    if (chunk <= 0 || chunk % kVec != 0 || used % kVec != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int chunks = (used + chunk - 1) / chunk;
    const long long nblocks = B * chunks;
    if (nblocks > 0) {
        fec_gather_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
            llr, index, scramble, out, ld, used, chunk, chunks);
    }
    return static_cast<int>(cudaGetLastError());
}

// The same function where index[c] for c = (a·B2 + b)·D + d is
// (d·B2 + b)·A2 + a: llr rows of ld ≥ D·B2·A2 floats, used ≤ D·B2·A2,
// scramble (≥ used,) bytes of 0 or 1; tiles of 16 columns by TB rows by
// D symbols, whose 16 · pitch floats of shared memory (pitch ≥ TB·D)
// must fit 48 KB.
GF3X_EXPORT int gf3x_fec_gather_tile(const float* llr,
                                     const unsigned char* scramble,
                                     float* out, long long B, long long ld,
                                     int used, int D, int B2, int A2, int TB,
                                     int pitch, void* stream) {
    const long long smem = 4LL * kTileA * pitch;
    const long long frame = static_cast<long long>(D) * B2 * A2;
    if (TB <= 0 || D <= 0 || B2 <= 0 || A2 <= 0
        || pitch < static_cast<long long>(TB) * D || smem > 48 * 1024
        || used > frame) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int tiles_a = (A2 + kTileA - 1) / kTileA;
    const int tiles_b = (B2 + TB - 1) / TB;
    const long long nblocks = B * tiles_a * tiles_b;
    // float4 loads and stores where every run starts on 16 bytes
    const bool vec = D % 4 == 0 && A2 % 4 == 0 && used % 4 == 0
                     && ld % 4 == 0 && pitch % 4 == 0
                     && reinterpret_cast<uintptr_t>(llr) % 16 == 0
                     && reinterpret_cast<uintptr_t>(out) % 16 == 0
                     && reinterpret_cast<uintptr_t>(scramble) % 4 == 0;
    if (nblocks > 0 && used > 0) {
        auto kernel = vec ? fec_gather_tile_kernel<true>
                          : fec_gather_tile_kernel<false>;
        kernel<<<static_cast<unsigned>(nblocks), kThreads,
                 static_cast<size_t>(smem),
                 static_cast<cudaStream_t>(stream)>>>(
            llr, scramble, out, ld, used, D, B2, A2, TB, tiles_a, tiles_b,
            pitch);
    }
    return static_cast<int>(cudaGetLastError());
}
