// The chirp-z transform's two pointwise passes around cuFFT: the
// clock-offset route's δ-warped used-band DFT
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
// chirp-z form is O(L log L) a row and moves bytes only.
//
// What bounds each pass on the card: bytes.
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
