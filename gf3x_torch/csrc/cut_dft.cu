// Fused frame cut + used-band DFT + deroll ramp.
//
// Replaces gf3x/ops/pallas/cut_dft.py:cut_dft_tpu. For row b, symbol s and
// used bin k ∈ [bin_lo, bin_lo + n_used):
//
//   Y[b,s,k] = inv_scale · Σ_n x[n]·e^{−2πi·k·n/N} · e^{+2πi·k·roll_b/N}
//
// with x[n] = rx[b, q_b·block + body_off + s·sym_len + cp + n], samples at
// or past `valid` reading as zero (kernel 1's `gather_cut` semantics). The
// segment after the S symbols (present when sc_off >= 0) copies the
// Schmidl–Cox window at q_b·block + sc_off, as kernel 1 does; with
// sc_off < 0 nothing is written there.
//
// The TPU kernel runs the DFT as bf16x3 MXU dots against resident tables
// and writes a group-major layout; both are TPU artefacts. Here the DFT is
// a radix-2 FFT in shared memory, in float32: the N real samples are packed
// as N/2 complex points z[m] = x[2m] + i·x[2m+1], one block transforms
// them (decimation in time, bit-reversed load, one butterfly per thread per
// stage), and each used bin is unpacked from Z[k] and Z[N/2 − k], derolled
// and scaled. Every twiddle is read from one N-entry cos/sin table of
// 2πj/N (built in float64 on the host, so exactly rounded) at an index
// computed in integer arithmetic: p·(N/len) for a butterfly, k for the
// unpacking, (k·roll) mod N for the deroll. Y lands as (B, S, n_used)
// complex64, the layout the channel estimate and kernels 2/A take.
//
// What bounds it on the card: bytes. Per step at config 5 it reads
// 100.7 MB of symbol windows (+ 4.2 MB of SC windows) and writes 55.1 MB
// of spectra (+ 4.2 MB); the FFT is ≈ 5·N·log2(N)/2 flops per symbol,
// far below the card's float32 rate. The symbol matrix never reaches
// device memory, which is the point of the fusion. Design: one block per
// (row, segment), N/4 threads, (N/2 + N/32) complex floats of shared
// memory (one padding slot per 16 keeps the bit-reversed scatter and the
// unpacking gathers off a single bank); loads of neighbouring threads are
// neighbouring sample pairs, so they coalesce.
#include "common.cuh"

// shared-memory slot of complex point i: one pad slot after every 16
__device__ __forceinline__ int cut_dft_slot(int i) { return i + (i >> 4); }

__global__ void cut_dft_kernel(const float* __restrict__ rx,
                               const int* __restrict__ q,
                               const int* __restrict__ roll,
                               const float* __restrict__ tw,
                               float2* __restrict__ Y,
                               float* __restrict__ scw, long long T,
                               long long valid, int block, int S, int n_fft,
                               int log2m, int body_off, int sym_len, int cp,
                               int sc_off, int bin_lo, int n_used,
                               float inv_scale) {
    extern __shared__ float2 z[];
    const int nseg = S + (sc_off >= 0 ? 1 : 0);
    const long long row = blockIdx.x / nseg;
    const int s = static_cast<int>(blockIdx.x % nseg);
    const float* src = rx + row * T;
    const long long w0 = static_cast<long long>(q[row]) * block;
    if (s == S) {  // the SC window: a copy, as kernel 1 makes it
        const long long base = w0 + sc_off;
        float* dst = scw + row * n_fft;
        for (int i = threadIdx.x; i < n_fft; i += blockDim.x) {
            const long long t = base + i;
            dst[i] = t < valid ? src[t] : 0.0f;
        }
        return;
    }
    const int M = n_fft >> 1;
    const long long base =
        w0 + body_off + static_cast<long long>(s) * sym_len + cp;
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
        const long long t = base + 2 * m;
        const float re = t < valid ? src[t] : 0.0f;
        const float im = t + 1 < valid ? src[t + 1] : 0.0f;
        const int r = static_cast<int>(__brev(static_cast<unsigned>(m)) >>
                                       (32 - log2m));
        z[cut_dft_slot(r)] = make_float2(re, im);
    }
    __syncthreads();

    const float* cosT = tw;
    const float* sinT = tw + n_fft;
    for (int len = 2; len <= M; len <<= 1) {
        const int half = len >> 1;
        const int stride = n_fft / len;
        for (int j = threadIdx.x; j < (M >> 1); j += blockDim.x) {
            const int p = j & (half - 1);
            const int i0 = ((j - p) << 1) + p;
            const int i1 = i0 + half;
            const float c = __ldg(cosT + p * stride);
            const float sn = __ldg(sinT + p * stride);
            const float2 a = z[cut_dft_slot(i0)];
            const float2 b = z[cut_dft_slot(i1)];
            // t = b·e^{−2πi·p/len} = b·(c − i·sn)
            const float tr = c * b.x + sn * b.y;
            const float ti = c * b.y - sn * b.x;
            z[cut_dft_slot(i1)] = make_float2(a.x - tr, a.y - ti);
            z[cut_dft_slot(i0)] = make_float2(a.x + tr, a.y + ti);
        }
        __syncthreads();
    }

    const int r = roll[row];
    float2* out = Y + (row * S + s) * n_used;
    for (int u = threadIdx.x; u < n_used; u += blockDim.x) {
        const int k = bin_lo + u;
        const float2 a = z[cut_dft_slot(k & (M - 1))];
        const float2 b = z[cut_dft_slot((M - k) & (M - 1))];
        // even part E = (Z[k] + conj Z[M−k])/2, odd part O = (Z[k] −
        // conj Z[M−k])/(2i), X[k] = E + e^{−2πik/N}·O
        const float er = 0.5f * (a.x + b.x);
        const float ei = 0.5f * (a.y - b.y);
        const float o_r = 0.5f * (a.y + b.y);
        const float o_i = -0.5f * (a.x - b.x);
        const float c = __ldg(cosT + k);
        const float sn = __ldg(sinT + k);
        const float xr = er + (c * o_r + sn * o_i);
        const float xi = ei + (c * o_i - sn * o_r);
        // deroll: X[k]·e^{+2πi·k·roll/N}
        const int ridx = (k * r) & (n_fft - 1);
        const float cr = __ldg(cosT + ridx);
        const float sr = __ldg(sinT + ridx);
        out[u] = make_float2((xr * cr - xi * sr) * inv_scale,
                             (xr * sr + xi * cr) * inv_scale);
    }
}

GF3X_EXPORT int gf3x_cut_dft(const float* rx, const int* q, const int* roll,
                             const float* tw, float* Y, float* scw,
                             long long B, long long T, long long valid,
                             int block, int S, int n_fft, int body_off,
                             int sym_len, int cp, int sc_off, int bin_lo,
                             int n_used, float inv_scale, void* stream) {
    int log2m = 0;
    while ((2 << log2m) < n_fft) ++log2m;  // n_fft = 2^(log2m + 1)
    const long long nblocks = B * (S + (sc_off >= 0 ? 1 : 0));
    const int M = n_fft / 2;
    const size_t smem = static_cast<size_t>(M + M / 16) * sizeof(float2);
    if (nblocks > 0) {
        cut_dft_kernel<<<static_cast<unsigned>(nblocks), n_fft / 4, smem,
                         static_cast<cudaStream_t>(stream)>>>(
            rx, q, roll, tw, reinterpret_cast<float2*>(Y), scw, T, valid,
            block, S, n_fft, log2m, body_off, sym_len, cp, sc_off, bin_lo,
            n_used, inv_scale);
    }
    return static_cast<int>(cudaGetLastError());
}
