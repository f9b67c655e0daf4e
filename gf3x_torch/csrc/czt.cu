// The clock-offset route's δ-warped used-band DFT as a chirp-z transform,
//
//   X[m] = Σ_n x[n]·e^{−iα·n·(k_lo + m)},  α = 2π(1 + δ)/N,  m < M,
//
// by Bluestein's identity n·m = (n² + m² − (m − n)²)/2 as
//
//   X[m] = post[m] · IFFT_L(FFT_L(x·pre) · H)[m]
//
// with pre[n] = e^{−iα(n·k_lo + n²/2)}, post[m] = e^{−iα·m²/2} and H the
// spectrum of the chirp filter e^{+iα·j²/2} (ops/ofdm.py builds the three
// tables per call, from the device scalar δ, in float64).
//
// Replaces no TPU kernel: gf3x's warped DFT is XLA's dense matmul over
// cos/sin tables (gf3x/ops/ofdm.py). The port ran it as two full-float32
// GEMMs a transform, O(N·M) operations at 25.5 TFLOP/s on the H100; the
// chirp-z form is O(L log L) a row.
//
// Two routes, chosen by shape alone (ops/kernels/czt.py `takes_fused`):
//
// `czt_fused_kernel`, at L = 6144, 12 288 and 24 576 (gf3-4096, gf3-8192,
// gf3-16384), where N ≤ 2L/3 and M ≤ L/3: the whole transform of one row
// in one block, the row's L complex values in shared memory; no L-long
// row touches device memory. The forward FFT decimates in frequency over
// radices 3, then 2^(log2(L/3) mod 4) where that is not 1, then 16
// (3·8·16·16, 3·16·16·16, 3·2·16·16·16), leaving the spectrum in
// digit-reversed order; the inverse decimates in time over the same
// radices in reverse, digit-reversed in, natural order out.
// - The first two stages in registers (`load_first`): a thread reads the
//   N real samples of its radix-3 groups at the cut's strides (row stride
//   N + CP, no copy) times pre[n]; their third inputs are the zero
//   padding and are never loaded; it then runs the second stage's groups
//   on the radix-3 outputs it holds.
// - The stages inside each span of 256 points (`middle`), a warp taking
//   two spans, with __syncwarp between them and no block barrier: the
//   forward stage of span 256; the last forward stage, the product with H
//   and the first inverse stage, all of span 16, on the same 16 points in
//   registers (H read in `filter_table`'s order: digit-reversed, and laid
//   out so that a warp's 16-byte loads are contiguous); the inverse stage
//   of span 256.
// - The last two inverse stages in registers (`store_last`), pruned to
//   the outputs m < M (2240 of 12 288 at gf3-8192): of the radix-3 stage
//   only its first output, whose sum is stored times post[m], (rows, M)
//   contiguous. No scale: 1/(L·ofdm_scale) is in H.
// Twiddles: from tables rounded once from float64 and copied into shared
// memory — ω_L^e as coarse[e >> 6]·fine[e & 63] (64 + L/64 entries; the
// fine run rotated per 16 so that a half-warp's lookups spread over the
// banks) and ω_256^{kq} at [k][q] — at each power of two k; at any other
// k the product of two of them. The constants inside a butterfly are
// exactly rounded floats; complex products use fused multiply-adds
// (__fmaf_rn, which --fmad=false leaves alone). −131 to −133 dB against
// float64 in the plain version and on the card, about 3 dB from the cuFFT
// chain's −134 (CPU) and −129 (card). Shared memory pads one slot after
// every 16 points, which keeps each stage's accesses (runs of 16 along a
// half-warp, or 16 points a lane at stride 1) on distinct banks.
// What bounds it: 1.25 GB a call at gf3-8192, B = 1024 (0.81 GB of real
// samples in, 0.44 GB of bins out: 0.37 ms at 3.35 TB/s) against the
// chain's 18.6 GB; then the SM's shared memory, 128 bytes a cycle: the
// row crosses it about eight times (0.8 MB a row) beside the twiddle
// lookups; and float32 work, about 2.5 MFLOP a row. A block holds
// (L + L/16 + 64 + L/64 + 256)·8 bytes: 54 KB at 6144, 109 KB at 12 288
// (two blocks an SM), 215 KB at 24 576 (one, 512 threads); the launch
// bound keeps two blocks an SM of 256 threads at the two shorter lengths.
//
// `czt_pre_kernel` and `czt_post_kernel`, every other L (a band wider
// than gf3-16384, or an L given by the caller): the two pointwise passes
// around cuFFT (`czt_pre` → torch.fft.fft → the product with H →
// torch.fft.ifft → `czt_post`). What bounds each pass: bytes.
// - `czt_pre_kernel` reads the CP-stripped real symbols straight from the
//   cut's strided view (row stride N + CP, no contiguous copy), multiplies
//   by the pre-chirp and writes complex64 rows of length L, zeros past N,
//   in one pass: 4·N bytes in, 8·L out a row (0.81 + 2.42 GB at gf3-8192,
//   B = 1024, L = 12 288: 0.96 ms at 3.35 TB/s). The 64 KB table stays in
//   L1/L2.
// - `czt_post_kernel` reads the first M entries of each inverse-FFT row
//   and writes them times the post-chirp, (rows, M) contiguous: 8·M bytes
//   each way a row (0.44 + 0.44 GB, 0.26 ms).
// A thread moves two neighbouring complex values at a time (8-byte real
// loads, 16-byte complex loads and stores) where the strides and
// addresses allow it, else one. The products are the plain version's:
// x·pre is x·re, x·im (torch's real-by-complex product adds exact zeros),
// and with --fmad=false a complex product rounds each of its four
// multiplies before the sum.
#include <cstdint>

#include "common.cuh"

namespace {
constexpr int kThreads = 256;
constexpr int kChunk = 2048;   // complex outputs a block covers of one row

// Block (row r, chunk c): outputs c·kChunk .. +kChunk of row r; row r reads
// symbol (r / S, r % S) at x + (r / S)·sa + (r % S)·ss.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
czt_pre_kernel(const float* __restrict__ x, const float2* __restrict__ pre,
               float2* __restrict__ out, int S, long long sa, long long ss,
               int N, int L) {
    const long long r = blockIdx.x;
    const float* src = x + (r / S) * sa + (r % S) * ss;
    float2* dst = out + r * L;
    const int begin = blockIdx.y * kChunk;
    const int end = min(begin + kChunk, L);
    if constexpr (kVec) {
        // N and L even: a pair is all below N or all at or past it
        for (int j = begin + 2 * threadIdx.x; j < end; j += 2 * kThreads) {
            float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
            if (j < N) {
                const float2 v =
                    __ldg(reinterpret_cast<const float2*>(src + j));
                const float4 p =
                    __ldg(reinterpret_cast<const float4*>(pre + j));
                o = make_float4(v.x * p.x, v.x * p.y, v.y * p.z, v.y * p.w);
            }
            *reinterpret_cast<float4*>(dst + j) = o;
        }
    } else {
        for (int j = begin + threadIdx.x; j < end; j += kThreads) {
            float2 o = make_float2(0.f, 0.f);
            if (j < N) {
                const float v = __ldg(src + j);
                const float2 p = __ldg(pre + j);
                o = make_float2(v * p.x, v * p.y);
            }
            dst[j] = o;
        }
    }
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Block (row r, chunk c): outputs c·kChunk .. +kChunk of row r's M.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
czt_post_kernel(const float2* __restrict__ z, const float2* __restrict__ post,
                float2* __restrict__ out, int L, int M) {
    const long long r = blockIdx.x;
    const float2* src = z + r * L;
    float2* dst = out + r * M;
    const int begin = blockIdx.y * kChunk;
    const int end = min(begin + kChunk, M);
    if constexpr (kVec) {
        // M and L even: every pair starts on 16 bytes
        for (int j = begin + 2 * threadIdx.x; j < end; j += 2 * kThreads) {
            const float4 a =
                __ldg(reinterpret_cast<const float4*>(src + j));
            const float4 p =
                __ldg(reinterpret_cast<const float4*>(post + j));
            const float2 lo =
                cmul(make_float2(a.x, a.y), make_float2(p.x, p.y));
            const float2 hi =
                cmul(make_float2(a.z, a.w), make_float2(p.z, p.w));
            *reinterpret_cast<float4*>(dst + j) =
                make_float4(lo.x, lo.y, hi.x, hi.y);
        }
    } else {
        for (int j = begin + threadIdx.x; j < end; j += kThreads) {
            dst[j] = cmul(__ldg(src + j), __ldg(post + j));
        }
    }
}

bool aligned(const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
}
}  // namespace

// x: A·S symbol rows of N floats, row (a, s) at x + a·sa + s·ss (floats);
// pre (N,) complex64; out (A·S, L) complex64, L ≥ N.
GF3X_EXPORT int gf3x_czt_pre(const float* x, const float2* pre, float2* out,
                             long long A, long long S, long long sa,
                             long long ss, int N, int L, void* stream) {
    if (N <= 0 || L < N || S <= 0 || S > INT32_MAX) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long rows = A * S;
    const unsigned chunks = static_cast<unsigned>((L + kChunk - 1) / kChunk);
    const bool vec = N % 2 == 0 && L % 2 == 0 && sa % 2 == 0 && ss % 2 == 0
                     && aligned(x, 8) && aligned(pre, 16) && aligned(out, 16);
    if (rows > 0) {
        const dim3 grid(static_cast<unsigned>(rows), chunks);
        auto kernel = vec ? czt_pre_kernel<true> : czt_pre_kernel<false>;
        kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            x, pre, out, static_cast<int>(S), sa, ss, N, L);
    }
    return static_cast<int>(cudaGetLastError());
}

// z (R, L) complex64 rows; post (M,) complex64, M ≤ L; out (R, M) complex64.
GF3X_EXPORT int gf3x_czt_post(const float2* z, const float2* post,
                              float2* out, long long R, int L, int M,
                              void* stream) {
    if (M <= 0 || L < M) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const unsigned chunks = static_cast<unsigned>((M + kChunk - 1) / kChunk);
    const bool vec = M % 2 == 0 && L % 2 == 0 && aligned(z, 16)
                     && aligned(post, 16) && aligned(out, 16);
    if (R > 0) {
        const dim3 grid(static_cast<unsigned>(R), chunks);
        auto kernel = vec ? czt_post_kernel<true> : czt_post_kernel<false>;
        kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            z, post, out, L, M);
    }
    return static_cast<int>(cudaGetLastError());
}

namespace {
// ---- czt_fused_kernel: the whole chirp-z transform of a row in a block

// shared-memory slot of point p: one pad slot after every 16
__host__ __device__ constexpr int slot(int p) { return p + (p >> 4); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
    return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
    return make_float2(a.x - b.x, a.y - b.y);
}

// a·b, each component one multiply and one fused multiply-add
__device__ __forceinline__ float2 fmul(float2 a, float2 b) {
    return make_float2(__fmaf_rn(a.x, b.x, -(a.y * b.y)),
                       __fmaf_rn(a.x, b.y, a.y * b.x));
}

// The shared twiddle tables, each entry rounded once from float64: fine
// ω_L^f (f < 64) at fine_slot(f), coarse ω_L^{64c} (c < L/64), and
// ω_256^{kq} at [k][q] (k, q < 16).
template <int L> constexpr int kTwiddles = 64 + L / 64 + 256;

// Where fine entry f lies: each run of 16 rotated by 3 per run, so that a
// half-warp's lookups of f = (e·k) & 63 at neighbouring e, for k = 1, 2, 4
// and 8, fall on few banks
__device__ __forceinline__ int fine_slot(int f) {
    return (f & ~15) | ((f + 3 * (f >> 4)) & 15);
}

// ω_L^e (kInv: its conjugate): coarse[e >> 6]·fine[e & 63]
template <bool kInv>
__device__ __forceinline__ float2 twiddle(const float2* tw, int e) {
    const float2 w = fmul(tw[64 + (e >> 6)], tw[fine_slot(e & 63)]);
    return kInv ? make_float2(w.x, -w.y) : w;
}

// k's highest power of two
__host__ __device__ constexpr int top_bit(int k) {
    return (k & (k - 1)) ? top_bit(k & (k - 1)) : k;
}

// w[k] = ω_S^{qk} (kInv: conjugated) for 0 < k < R, e = (L/S)·q: at each
// power of two k from the tables (at S = 256 the ω_256 table, else
// ω_L^{e·k} from the two-level tables), at every other k the product
// w[k − h]·w[h], h = top_bit(k)
template <int R, int S, int L, bool kInv>
__device__ __forceinline__ void stage_twiddles(const float2* tw, int q,
                                               float2 (&w)[R]) {
#pragma unroll
    for (int k = 1; k < R; ++k) {
        const int h = top_bit(k);
        if (h != k) {
            w[k] = fmul(w[k - h], w[h]);
        } else if constexpr (S == 256) {
            const float2 v = tw[64 + L / 64 + 16 * k + q];
            w[k] = kInv ? make_float2(v.x, -v.y) : v;
        } else {
            w[k] = twiddle<kInv>(tw, (L / S) * q * k);
        }
    }
}

// cos(2πk/16), exactly rounded
__device__ __forceinline__ float cos16(int k) {
    constexpr float c1 = 0.92387953251128674f, c2 = 0.70710678118654752f,
                    c3 = 0.38268343236508977f;
    switch (k & 15) {
    case 0: return 1.f;
    case 1: case 15: return c1;
    case 2: case 14: return c2;
    case 3: case 13: return c3;
    case 4: case 12: return 0.f;
    case 5: case 11: return -c3;
    case 6: case 10: return -c2;
    case 7: case 9: return -c1;
    default: return -1.f;
    }
}

// v·ω_16^k (forward, ω = e^{−2πi/16}) or v·ω_16^{−k} (kInv), k < 8; ±1 and
// ∓i exact
template <bool kInv>
__device__ __forceinline__ float2 rot16(float2 v, int k) {
    if (k == 0) return v;
    if (k == 4) return kInv ? make_float2(-v.y, v.x) : make_float2(v.y, -v.x);
    const float c = cos16(k), sn = cos16(k + 12);   // sin(2πk/16)
    return fmul(v, make_float2(c, kInv ? sn : -sn));
}

// k's lowest log2(R) bits reversed
__host__ __device__ constexpr int bit_reverse(int k, int R) {
    return R > 1 ? ((k & 1) * (R / 2)) | bit_reverse(k >> 1, R / 2) : 0;
}

// One level of a radix-2 decimation-in-frequency network over R points:
// butterflies of span 2H, the difference times ω_{2H}^j = ω_16^{j·8/H}.
template <int R, int H, bool kInv>
__device__ __forceinline__ void dft_level(float2 (&a)[R]) {
#pragma unroll
    for (int b = 0; b < R; b += 2 * H) {
#pragma unroll
        for (int j = 0; j < H; ++j) {
            const float2 u = a[b + j], v = a[b + j + H];
            a[b + j] = cadd(u, v);
            a[b + j + H] = rot16<kInv>(csub(u, v), j * (8 / H));
        }
    }
    if constexpr (H > 1) dft_level<R, H / 2, kInv>(a);
}

// The R-point DFT of a[] in place, R = 2, 4, 8 or 16, natural order in and
// out: b[k] = Σ_j a[j]·ω_R^{±jk}. The network's bit-reversed output is a
// renaming of registers.
template <int R, bool kInv>
__device__ __forceinline__ void dft(float2 (&a)[R]) {
    dft_level<R, R / 2, kInv>(a);
    float2 t[R];
#pragma unroll
    for (int k = 0; k < R; ++k) t[k] = a[bit_reverse(k, R)];
#pragma unroll
    for (int k = 0; k < R; ++k) a[k] = t[k];
}

constexpr float kSin3 = 0.86602540378443865f;   // sin(2π/3)

// The forward 3-point DFT (b0, b1, b2) of (a0, a1, 0): the radix-3 stage's
// third input is the zero padding
__device__ __forceinline__ void dft3_padded(float2 a0, float2 a1, float2& b0,
                                            float2& b1, float2& b2) {
    b0 = cadd(a0, a1);
    const float2 m = make_float2(a0.x - 0.5f * a1.x, a0.y - 0.5f * a1.y);
    const float2 r = make_float2(kSin3 * a1.y, -kSin3 * a1.x);  // −i·sin·a1
    b1 = cadd(m, r);
    b2 = csub(m, r);
}

// The first two forward stages in registers: radix 3 over stride
// s = L/3, whose third input is the zero padding (N ≤ 2L/3) and whose first
// two are x·pre, read at the cut's strides (zero at or past N); then radix
// R over stride
// s2 = s/R within each third. A thread takes q0 < s2: the R radix-3
// groups q = q0 + s2·j, then for each third t the R-point DFT of their
// outputs t (times ω_L^{qt}), output k times ω_{L/3}^{q0·k}, stored at
// t·s + q0 + s2·k.
template <int R, int L, int T>
__device__ __forceinline__ void load_first(float2* sm, const float2* tw,
                                           const float* __restrict__ src,
                                           const float2* __restrict__ pre,
                                           int N) {
    constexpr int s = L / 3, s2 = s / R, step = s2 + s2 / 16;
    static_assert(s2 % 64 == 0, "the radix-3 twiddles' fine factor");
#pragma unroll 1
    for (int q0 = threadIdx.x; q0 < s2; q0 += T) {
        float2 a0[R], a1[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const int n = q0 + s2 * j;
            a0[j] = a1[j] = make_float2(0.f, 0.f);
            if (n < N) {
                const float v = __ldg(src + n);
                const float2 p = __ldg(pre + n);
                a0[j] = make_float2(v * p.x, v * p.y);
            }
            if (n + s < N) {
                const float v = __ldg(src + n + s);
                const float2 p = __ldg(pre + n + s);
                a1[j] = make_float2(v * p.x, v * p.y);
            }
        }
        float2 w[R];
        stage_twiddles<R, L / 3, L, false>(tw, q0, w);
#pragma unroll
        for (int t = 0; t < 3; ++t) {
            // ω_L^{t·q}: s2·j is a multiple of 64, so the fine factor is
            // the same for every j and the coarse index moves by t·s2·j/64
            const float2 f = tw[fine_slot((t * q0) & 63)];
            const float2* c = tw + 64 + ((t * q0) >> 6);
            float2 b[R];
#pragma unroll
            for (int j = 0; j < R; ++j) {
                float2 b0, b1, b2;
                dft3_padded(a0[j], a1[j], b0, b1, b2);
                b[j] = t == 0 ? b0
                     : fmul(t == 1 ? b1 : b2,
                            fmul(c[t * (s2 / 64) * j], f));
            }
            dft<R, false>(b);
#pragma unroll
            for (int k = 1; k < R; ++k) b[k] = fmul(b[k], w[k]);
            float2* row = sm + slot(t * s + q0);
#pragma unroll
            for (int k = 0; k < R; ++k) row[k * step] = b[k];
        }
    }
}

// A stage of radix R and span S on the group of the R points q + j·s
// (s = S/R) from `base` = the block's first point + q. Forward (decimation
// in frequency): the R-point DFT, then output k times ω_S^{qk}. Inverse
// (decimation in time, the forward's inverse unscaled): input k times
// ω_S^{−qk}, then the inverse DFT; ω_S^{qk} from `stage_twiddles`.
template <int R, int S, int L, bool kInv>
__device__ __forceinline__ void group(float2* sm, const float2* tw, int base,
                                      int q) {
    constexpr int s = S / R;
    static_assert(s % 16 == 0, "a group's points lie whole pad runs apart");
    constexpr int step = s + s / 16;     // slot(p + s) − slot(p)
    float2* row = sm + slot(base);
    float2 a[R], w[R];
#pragma unroll
    for (int j = 0; j < R; ++j) a[j] = row[j * step];
    stage_twiddles<R, S, L, kInv>(tw, q, w);
    if constexpr (kInv) {
#pragma unroll
        for (int k = 1; k < R; ++k) a[k] = fmul(a[k], w[k]);
    }
    dft<R, kInv>(a);
    if constexpr (!kInv) {
#pragma unroll
        for (int k = 1; k < R; ++k) a[k] = fmul(a[k], w[k]);
    }
#pragma unroll
    for (int j = 0; j < R; ++j) row[j * step] = a[j];
}

// Every group of a stage of radix R and span S, spread over the block
template <int R, int S, int L, int T, bool kInv>
__device__ __forceinline__ void stage(float2* sm, const float2* tw) {
    constexpr int s = S / R;
#pragma unroll 1
    for (int i = threadIdx.x; i < L / R; i += T) {
        const int q = i & (s - 1);
        group<R, S, L, kInv>(sm, tw, (i - q) * R + q, q);
    }
}

// The stages inside each span of 256 points, a warp taking two spans at a
// time (a half-warp each), so that only __syncwarp separates them: the
// forward stage of span 256; the last forward stage (span 16), the product
// with H in the same digit-reversed order and the first inverse stage
// (span 16), on the same 16 points in registers (H in `filter_table`'s
// order, so that each of a lane's eight 16-byte loads is a warp's 512
// contiguous bytes); the inverse stage of span 256.
template <int L, int T>
__device__ __forceinline__ void middle(float2* sm, const float2* tw,
                                       const float2* __restrict__ hr) {
    const int lane = threadIdx.x & 31, q = lane & 15;
#pragma unroll 1
    for (int b = 2 * (threadIdx.x >> 5); b < L / 256; b += 2 * (T / 32)) {
        const int span = b + (lane >> 4);
        const bool live = span < L / 256;
        if (live) group<16, 256, L, false>(sm, tw, 256 * span + q, q);
        __syncwarp();
        if (live) {
            const int g = 16 * span + q;          // = 16·b + lane
            float2* row = sm + 17 * g;            // slot(16·g)
            float2 a[16];
#pragma unroll
            for (int j = 0; j < 16; ++j) a[j] = row[j];
            dft<16, false>(a);
            // points 16g + 2k, 16g + 2k + 1 of H at float4 (g/32, k, g%32)
            const float4* h = reinterpret_cast<const float4*>(hr)
                              + 256 * (g >> 5) + (g & 31);
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                const float4 v = __ldg(h + 32 * k);
                a[2 * k] = fmul(a[2 * k], make_float2(v.x, v.y));
                a[2 * k + 1] = fmul(a[2 * k + 1], make_float2(v.z, v.w));
            }
            dft<16, true>(a);
#pragma unroll
            for (int j = 0; j < 16; ++j) row[j] = a[j];
        }
        __syncwarp();
        if (live) group<16, 256, L, true>(sm, tw, 256 * span + q, q);
    }
}

// The last two inverse stages in registers, pruned to the outputs
// m < M ≤ L/3: for q0 < s2 = s/R (s = L/3) and each third t, the inverse
// stage of radix R over stride s2 (inputs k times ω_{L/3}^{−q0·k}, the
// inverse DFT), whose output j is point q = q0 + s2·j of third t; of the
// last stage, radix 3 over stride s, only output 0: the sum over t of
// those points times ω_L^{−qt}, stored times post[q] for q < M.
template <int R, int L, int T>
__device__ __forceinline__ void store_last(const float2* sm,
                                           const float2* tw,
                                           const float2* __restrict__ post,
                                           float2* __restrict__ dst, int M) {
    constexpr int s = L / 3, s2 = s / R, step = s2 + s2 / 16;
#pragma unroll 1
    for (int q0 = threadIdx.x; q0 < s2; q0 += T) {
        float2 w[R], acc[R];
        stage_twiddles<R, L / 3, L, true>(tw, q0, w);
#pragma unroll
        for (int t = 0; t < 3; ++t) {
            // ω_L^{−t·q} as in load_first
            const float2 f = tw[fine_slot((t * q0) & 63)];
            const float2* c = tw + 64 + ((t * q0) >> 6);
            const float2* row = sm + slot(t * s + q0);
            float2 a[R];
#pragma unroll
            for (int k = 0; k < R; ++k) a[k] = row[k * step];
#pragma unroll
            for (int k = 1; k < R; ++k) a[k] = fmul(a[k], w[k]);
            dft<R, true>(a);
#pragma unroll
            for (int j = 0; j < R; ++j) {
                const int q = q0 + s2 * j;
                if (t == 0) {
                    acc[j] = a[j];
                } else if (q < M) {
                    const float2 v = fmul(c[t * (s2 / 64) * j], f);
                    acc[j] = cadd(acc[j], fmul(a[j], make_float2(v.x, -v.y)));
                }
            }
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const int q = q0 + s2 * j;
            if (q < M) dst[q] = fmul(acc[j], __ldg(post + q));
        }
    }
}

// The radix-16 stages of span S down to 4096 (forward) or up from 4096 to
// S (inverse), between the first (or last) two stages and the middle
template <int S, int L, int T>
__device__ __forceinline__ void forward16(float2* sm, const float2* tw) {
    if constexpr (S > 256) {
        stage<16, S, L, T, false>(sm, tw);
        __syncthreads();
        forward16<S / 16, L, T>(sm, tw);
    }
}

template <int S, int Top, int L, int T>
__device__ __forceinline__ void inverse16(float2* sm, const float2* tw) {
    if constexpr (S <= Top) {
        stage<16, S, L, T, true>(sm, tw);
        __syncthreads();
        inverse16<S * 16, Top, L, T>(sm, tw);
    }
}

__host__ __device__ constexpr int fused_log2(int n) {
    return n > 1 ? 1 + fused_log2(n / 2) : 0;
}

// threads a block and the launch bound's blocks an SM at each L
template <int L> constexpr int kFusedThreads = L > 12288 ? 512 : 256;
template <int L> constexpr int kFusedBlocks = L > 12288 ? 1 : 2;

// Block r: row r, symbol (r / S, r % S) at x + (r / S)·sa + (r % S)·ss,
// written to out + r·M.
template <int L>
__global__ void __launch_bounds__(kFusedThreads<L>, kFusedBlocks<L>)
czt_fused_kernel(const float* __restrict__ x,
                 const float2* __restrict__ pre,
                 const float2* __restrict__ hr,
                 const float2* __restrict__ post,
                 const float2* __restrict__ tw_g, float2* __restrict__ out,
                 int S, long long sa, long long ss, int N, int M) {
    constexpr int T = kFusedThreads<L>;
    constexpr int a = fused_log2(L / 3);
    // the radix after the 3: 2^(a mod 4), or 16; then radix 16 to the end
    constexpr int R = a % 4 ? 1 << (a % 4) : 16;
    extern __shared__ float2 sm[];
    float2* tw = sm + slot(L);
    for (int i = threadIdx.x; i < kTwiddles<L>; i += T) tw[i] = __ldg(tw_g + i);
    __syncthreads();
    const long long r = blockIdx.x;
    load_first<R, L, T>(sm, tw, x + (r / S) * sa + (r % S) * ss, pre, N);
    __syncthreads();
    forward16<L / 3 / R, L, T>(sm, tw);
    middle<L, T>(sm, tw, hr);
    __syncthreads();
    inverse16<4096, L / 3 / R, L, T>(sm, tw);
    store_last<R, L, T>(sm, tw, post, out + r * M, M);
}

template <int L>
cudaError_t launch_fused(const float* x, const float2* pre, const float2* hr,
                         const float2* post, const float2* tw, float2* out,
                         long long rows, int S, long long sa, long long ss,
                         int N, int M, cudaStream_t stream) {
    static size_t smem_set[kMaxDevices] = {};
    constexpr int T = kFusedThreads<L>;
    constexpr size_t smem = sizeof(float2) * (slot(L) + kTwiddles<L>);
    const cudaError_t e = gf3x_allow_smem(czt_fused_kernel<L>, smem,
                                          smem_set);
    if (e != cudaSuccess) return e;
    czt_fused_kernel<L><<<static_cast<unsigned>(rows), T, smem, stream>>>(
        x, pre, hr, post, tw, out, S, sa, ss, N, M);
    return cudaGetLastError();
}
}  // namespace

// x: A·S symbol rows of N floats, row (a, s) at x + a·sa + s·ss (floats);
// pre (N,), hr (L,) (H in filter_table's order), post (M,) and tw
// (64 + L/64 + 256,) complex64 (the twiddle tables); out (A·S, M)
// complex64. L is 6144, 12 288 or 24 576, N ≤ 2L/3, M ≤ L/3; hr on 16
// bytes.
GF3X_EXPORT int gf3x_czt_fused(const float* x, const float2* pre,
                               const float2* hr, const float2* post,
                               const float2* tw, float2* out, long long A,
                               long long S, long long sa, long long ss, int N,
                               int L, int M, void* stream) {
    if (N <= 0 || 3 * N > 2 * L || M <= 0 || 3 * M > L || S <= 0
        || S > INT32_MAX || !aligned(hr, 16)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long rows = A * S;
    if (rows <= 0) return static_cast<int>(cudaGetLastError());
    auto st = static_cast<cudaStream_t>(stream);
    const int s = static_cast<int>(S);
    switch (L) {
    case 6144:
        return static_cast<int>(launch_fused<6144>(x, pre, hr, post, tw, out,
                                                   rows, s, sa, ss, N, M, st));
    case 12288:
        return static_cast<int>(launch_fused<12288>(x, pre, hr, post, tw,
                                                    out, rows, s, sa, ss, N,
                                                    M, st));
    case 24576:
        return static_cast<int>(launch_fused<24576>(x, pre, hr, post, tw,
                                                    out, rows, s, sa, ss, N,
                                                    M, st));
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
}
