// Fused frame cut + cyclic-prefix strip.
//
// Replaces gf3x/ops/pallas/gather_cut.py:cut_symbols_tpu. Row i's symbol s
// is rx[i, q[i]·block + body_off + s·sym_len + cp :][:n_fft]; the segment
// after the S symbols (present when sc_off >= 0) is the Schmidl–Cox window
// at q[i]·block + sc_off. Samples at or past `valid` (the whole-block prefix
// floor(T/block)·block) read as zero: the `gather_cut` semantics the JAX
// CPU path runs (gf3x/ops/sync.py:274-351).
//
// The TPU kernel stages a span of each 8..32-row group through VMEM with
// one DMA and clamps starts into that span (`_cut_qqb`). A GPU has nothing
// to stage: each block reads its own window straight from device memory.
// The two agree on every start that respects the span bound.
//
// What bounds it on the card: bytes. It is a pure copy, about
// B·(S+1)·n_fft·4 bytes read and as many written (≈ 200 MB per step at
// B = 1024), so it can only approach the HBM rate. Design: one block per
// (row, segment); neighbouring threads copy neighbouring samples, so both
// the loads (whose row base is not 16-byte aligned for odd T) and the
// stores coalesce; no shared memory.
#include "common.cuh"

__global__ void cut_symbols_kernel(const float* __restrict__ rx,
                                   const int* __restrict__ q,
                                   float* __restrict__ syms,
                                   float* __restrict__ scw,
                                   long long T, long long valid, int block,
                                   int S, int n_fft, int body_off,
                                   int sym_len, int cp, int sc_off) {
    const int nseg = S + (sc_off >= 0 ? 1 : 0);
    const long long row = blockIdx.x / nseg;
    const int s = static_cast<int>(blockIdx.x % nseg);
    const long long base = static_cast<long long>(q[row]) * block +
                           (s < S ? body_off + s * sym_len + cp : sc_off);
    const float* src = rx + row * T;
    float* dst = s < S ? syms + (row * S + s) * n_fft : scw + row * n_fft;
    for (int i = threadIdx.x; i < n_fft; i += blockDim.x) {
        const long long t = base + i;
        dst[i] = t < valid ? src[t] : 0.0f;
    }
}

GF3X_EXPORT int gf3x_cut_symbols(const float* rx, const int* q, float* syms,
                                 float* scw, long long B, long long T,
                                 long long valid, int block, int S, int n_fft,
                                 int body_off, int sym_len, int cp,
                                 int sc_off, void* stream) {
    const long long nblocks = B * (S + (sc_off >= 0 ? 1 : 0));
    if (nblocks > 0) {
        cut_symbols_kernel<<<static_cast<unsigned>(nblocks), 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(
            rx, q, syms, scw, T, valid, block, S, n_fft, body_off, sym_len,
            cp, sc_off);
    }
    return static_cast<int>(cudaGetLastError());
}
