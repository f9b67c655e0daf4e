// The ISI profile's anchor (ops/chanest.py `isi_anchor`): for each frame,
// from h (B, n) complex64, the band-limited impulse response of its raw Ĥ
// under a Hann taper sampled every D taps, and gf3x's anchor a0 = ŝ − t0
// (whole taps), the tap the profile moves to tap 0:
//
//   e[i] = |h[i]|², P = max e, at = the first i holding it;
//   thr = max(peak_share · P, noise_coef · noise_var);
//   j = the first of 0..span with e[(at − span + j) mod n] ≥ thr;
//   onset = (at − span + j) · D;
//   anchor = wrap(onset − g) where j exists and wrap(onset − a0) < 0, else a0
//
// with wrap(x) = ((x + N/2) mod N) − N/2. It replaces no TPU kernel: gf3x
// anchors at ŝ − t0 alone. In torch the same is about thirty launches of
// (B,)-sized work; here one block a frame does it in one launch, reading
// each row once for the peak and the span again (from L2).
//
// |h|² is re·re + im·im rounded as two products and a sum (the build has
// --fmad=false), as the plain version (ops/kernels/isi_onset.py) forms it,
// so the two find the same peak and the same onset.
#include "common.cuh"

namespace {
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float energy(float2 v) {
    return __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
}

// (e, i) beats (best, at): larger, or as large and earlier.
__device__ __forceinline__ bool beats(float e, int i, float best, int at) {
    return e > best || (e == best && i < at);
}

__global__ void __launch_bounds__(kThreads)
isi_onset_kernel(const float2* __restrict__ h,
                 const float* __restrict__ anchor0,
                 const float* __restrict__ noise_var,
                 float* __restrict__ anchor, int n, int D, int span, int g,
                 int N, float peak_share, float noise_coef) {
    __shared__ float s_best[kWarps];
    __shared__ int s_at[kWarps];
    __shared__ int s_first[kWarps];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float2* row = h + static_cast<long long>(blockIdx.x) * n;

    float best = -1.0f;
    int at = 0;
    for (int i = threadIdx.x; i < n; i += kThreads) {
        const float e = energy(row[i]);
        if (e > best) {
            best = e;
            at = i;
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, o);
        const int oa = __shfl_xor_sync(0xffffffffu, at, o);
        if (beats(ob, oa, best, at)) {
            best = ob;
            at = oa;
        }
    }
    if (lane == 0) {
        s_best[warp] = best;
        s_at[warp] = at;
    }
    __syncthreads();
    best = s_best[0];
    at = s_at[0];
    for (int w = 1; w < kWarps; ++w) {
        if (beats(s_best[w], s_at[w], best, at)) {
            best = s_best[w];
            at = s_at[w];
        }
    }
    const float thr = fmaxf(peak_share * best,
                            noise_coef * noise_var[blockIdx.x]);

    int first = span + 1;
    for (int j = threadIdx.x; j <= span; j += kThreads) {
        int i = at - span + j;
        if (i < 0) i += n;
        if (energy(row[i]) >= thr) {
            first = j;
            break;
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        first = min(first, __shfl_xor_sync(0xffffffffu, first, o));
    }
    if (lane == 0) s_first[warp] = first;
    __syncthreads();
    if (threadIdx.x != 0) return;
    for (int w = 1; w < kWarps; ++w) first = min(first, s_first[w]);
    const int a0 = __float2int_rn(anchor0[blockIdx.x]);
    int out = a0;
    if (first <= span) {
        const int onset = (at - span + first) * D;
        const auto wrap = [N](int x) {
            int r = (x + N / 2) % N;
            if (r < 0) r += N;
            return r - N / 2;
        };
        if (wrap(onset - a0) < 0) out = wrap(onset - g);
    }
    anchor[blockIdx.x] = static_cast<float>(out);
}
}  // namespace

// h (B, n) complex64 rows, anchor0 / noise_var / anchor (B,) float32;
// 0 ≤ span < n.
GF3X_EXPORT int gf3x_isi_onset(const float2* h, const float* anchor0,
                               const float* noise_var, float* anchor,
                               long long B, int n, int D, int span, int g,
                               int N, float peak_share, float noise_coef,
                               void* stream) {
    if (n <= 0 || span < 0 || span >= n || N <= 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (B > 0) {
        isi_onset_kernel<<<static_cast<unsigned>(B), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
            h, anchor0, noise_var, anchor, n, D, span, g, N, peak_share,
            noise_coef);
    }
    return static_cast<int>(cudaGetLastError());
}
