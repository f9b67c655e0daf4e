// The split EQ/demap tail: kernel A (eq_track) equalizes, tracks and
// derotates; kernel B (demap_bins) demaps every data bin at its own order.
//
// Replaces gf3x/ops/pallas/split_eq.py:eq_track_tpu (kernel A) and
// :demap_bins_tpu (kernel B). On the TPU the split exists because the
// fused kernel's 64-QAM state overflows scoped VMEM; here it is the tail
// of every bit-loaded config, and it takes uniform configs too. Both are
// held to the XLA twin (Modem._eq_tail, loaded_demap_llr at
// gf3x/models/frame.py:83-106), not to the Pallas kernels: atan2f instead
// of a polynomial, and nv_eff = nv_sym · 1/max(|H|², 1e-12) with no
// second clamp before the loading gain.
//
// Kernel A runs the fused kernel's EQ and tracking code (eq_demap.cuh), so
// its bins equal the fused kernel's internal ones bit for bit. It writes
// eq (B, D, U) complex64 and slope, cpe, nv_sym (B, D).
//
// Kernel B takes static per-data-bin tables (used-bin index, bits 0/2/4/6,
// offset of the bin's first bit within a symbol's R wire bits) and writes
// the twin's layout: scrambled, wire-order LLRs (B, D·R), plus per-(frame,
// symbol) partial sums of the EVM distances and of |llr|. One launch
// covers every loading group; a uniform config is one group with gain 1.
// The TPU kernel's bin chunking, per-group launches and plane-major sign
// rows are layouts of the TPU and are not carried over.
//
// What bounds them on the card: bytes. A reads U bins and writes U bins per
// data symbol; B reads them back and writes R LLRs. The intermediate eq is
// B·D·U·8 bytes (45.9 MB at B = 1024 and GF3 geometry), written once and
// read once: that round trip is the split's price against the fused
// kernel. Design: one block per (frame, data symbol) for both; in A one
// thread per used bin, in B one thread per data bin, with the PAM levels
// of the three orders staged from the kernel's parameter (constant) bank
// into shared memory.
#include "eq_demap.cuh"

namespace {

__global__ void eq_track_kernel(const __grid_constant__ TrackArgs a,
                                float2* eq, float* slope, float* cpe,
                                float* nv_sym) {
    extern __shared__ float sm[];
    const int b = blockIdx.x / a.D;
    const int d = blockIdx.x % a.D;
    const int k = threadIdx.x;
    const TrackedBin t = gf3x_eq_track_symbol(a, b, d, sm);
    const long long o = static_cast<long long>(b) * a.D + d;
    if (k < a.U) eq[o * a.U + k] = make_float2(t.xr, t.xi);
    if (k == 0) {
        slope[o] = t.slope;
        cpe[o] = t.cpe;
        nv_sym[o] = t.nv_sym;
    }
}

constexpr int kLevels = 2 + 4 + 8;   // PAM levels of QPSK, 16- and 64-QAM

struct DemapArgs {
    const float2* eq;    // (B, D, U) derotated equalized bins
    const float2* h;     // (B, U) channel estimate
    const float* nv_sym; // (B, D) per-symbol noise floor
    const int* used;     // (NB,) used-bin index of each data bin
    const int* bits;     // (NB,) 0, 2, 4 or 6
    const int* off;      // (NB,) first wire bit of the bin within R
    float* llr;          // (B, D·R)
    float* evm_part;     // (B, D) Σ over active bins of the min distances
    float* abs_part;     // (B, D) Σ |llr|
    int D, U, NB, R;
    float inv_gain, inv_gain2;   // 1/g and 1/g² of the loading boost
    float lv[kLevels];   // levels of order m at lv[2^m − 2 ...]
};

__global__ void demap_bins_kernel(DemapArgs a) {
    __shared__ float s_lv[kLevels];
    __shared__ float s_red[64];
    const int b = blockIdx.x / a.D;
    const int d = blockIdx.x % a.D;
    const int j = threadIdx.x;
    if (j < kLevels) s_lv[j] = a.lv[j];
    __syncthreads();

    const long long o = static_cast<long long>(b) * a.D + d;
    float md_sum = 0.0f, abs_sum = 0.0f;
    const int nbits = j < a.NB ? a.bits[j] : 0;
    if (nbits > 0) {
        const int k = a.used[j];
        const int m = nbits >> 1;
        const float2 e = a.eq[o * a.U + k];
        const float2 h = a.h[static_cast<long long>(b) * a.U + k];
        const float h2 = h.x * h.x + h.y * h.y;
        // loading: demap y/g with noise nv/g² (g = 1 when uniform)
        const float nv_eff = a.nv_sym[o] * (1.0f / fmaxf(h2, 1e-12f));
        const float nvc = fmaxf(nv_eff * a.inv_gain2, 1e-12f);
        gf3x_demap_bin(m, e.x * a.inv_gain, e.y * a.inv_gain,
                       s_lv + (1 << m) - 2, nvc, a.llr + o * a.R + a.off[j],
                       md_sum, abs_sum);
    }
    gf3x_block_sum2(md_sum, abs_sum, s_red);
    if (j == 0) {
        a.evm_part[o] = md_sum;
        a.abs_part[o] = abs_sum;
    }
}

}  // namespace

GF3X_EXPORT int gf3x_eq_track(
        const float* y, const float* h, const float* nv, const float* pv,
        float* eq, float* slope, float* cpe, float* nv_sym, long long B,
        int S, int K, int U, int P, int sp, int n_ladder, int q0,
        float base0, int q1, float base1, float mean_dk, void* stream) {
    TrackArgs a;
    a.y = reinterpret_cast<const float2*>(y);
    a.h = reinterpret_cast<const float2*>(h);
    a.nv = nv;
    a.pv = reinterpret_cast<const float2*>(pv);
    a.S = S;
    a.K = K;
    a.D = S - K;
    a.U = U;
    a.P = P;
    a.sp = sp;
    a.n_ladder = n_ladder;
    a.ladder_q[0] = q0;
    a.ladder_q[1] = q1;
    a.ladder_base[0] = base0;
    a.ladder_base[1] = base1;
    a.mean_dk = mean_dk;
    const long long nblocks = B * a.D;
    const int threads = ((U + 31) / 32) * 32;
    const size_t smem = gf3x_track_smem_floats(P) * sizeof(float);
    if (nblocks > 0) {
        eq_track_kernel<<<static_cast<unsigned>(nblocks), threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
            a, reinterpret_cast<float2*>(eq), slope, cpe, nv_sym);
    }
    return static_cast<int>(cudaGetLastError());
}

GF3X_EXPORT int gf3x_demap_bins(
        const float* eq, const float* h, const float* nv_sym, const int* used,
        const int* bits, const int* off, float* llr, float* evm_part,
        float* abs_part, long long B, int D, int U, int NB, int R,
        float inv_gain, float inv_gain2, const float* levels, void* stream) {
    DemapArgs a;
    a.eq = reinterpret_cast<const float2*>(eq);
    a.h = reinterpret_cast<const float2*>(h);
    a.nv_sym = nv_sym;
    a.used = used;
    a.bits = bits;
    a.off = off;
    a.llr = llr;
    a.evm_part = evm_part;
    a.abs_part = abs_part;
    a.D = D;
    a.U = U;
    a.NB = NB;
    a.R = R;
    a.inv_gain = inv_gain;
    a.inv_gain2 = inv_gain2;
    for (int i = 0; i < kLevels; ++i) a.lv[i] = levels[i];
    const long long nblocks = B * D;
    const int threads = ((NB + 31) / 32) * 32;
    if (nblocks > 0) {
        demap_bins_kernel<<<static_cast<unsigned>(nblocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
}
