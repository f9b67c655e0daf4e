// Fused one-tap EQ + CSI-weighted pilot phase tracking + per-symbol noise
// floor + max-log demap, QPSK to 64-QAM.
//
// Replaces gf3x/ops/pallas/fused_eq.py:fused_eq_demap_tpu. It is held to
// the XLA twin the JAX CPU path runs, not to the Pallas kernel:
// Modem._eq_tail (gf3x/models/modem.py:639-671), pilot_phase_correct
// (gf3x/ops/chanest.py:166-211) and Modem._xla_demap (modem.py:911-930).
// So angles come from atan2f (the Pallas kernel uses a polynomial), and the
// effective noise is nv_sym / max(|H|², 1e-12) (the twin's form). The EQ,
// tracking and demap code is shared with the split tail (eq_demap.cuh).
//
// Output is the twin's layout: scrambled, interleaved data-bin LLRs
// (B, D·R) in qam_demap_llr bit order (per data bin: m I-axis bits, then m
// Q-axis bits), slope and cpe (B, D), and per-(frame, symbol) partial sums
// of the EVM distances and of |llr| that the wrapper reduces over D.
//
// What bounds it on the card: bytes. Per data symbol it reads U complex
// bins (plus Ĥ, shared by the frame's D blocks through L2) and writes R
// LLRs; the arithmetic is a few dozen flops per bin. Design: one block per
// (frame, data symbol) with one thread per used bin, so loads of the
// interleaved (re, im) bins coalesce; the pilot fits are done by warp 0
// (eq_demap.cuh), so the block synchronises three times per symbol.
#include "eq_demap.cuh"

namespace {

constexpr int kMaxLevels = 8;   // 64-QAM: 8 PAM levels per axis

struct FusedArgs {
    TrackArgs t;
    float* llr;          // (B, D·R)
    float* slope;        // (B, D)
    float* cpe;          // (B, D)
    float* evm_part;     // (B, D) Σ over data bins of the min distances
    float* abs_part;     // (B, D) Σ |llr|
    int m, R;
    float lv[kMaxLevels];   // PAM level of each Gray label
};

__global__ void fused_eq_demap_kernel(const __grid_constant__ FusedArgs a) {
    extern __shared__ float sm[];
    __shared__ float s_lv[kMaxLevels];
    __shared__ float s_red[64];

    const int D = a.t.D;
    const int b = blockIdx.x / D;
    const int d = blockIdx.x % D;
    const int k = threadIdx.x;
    if (k < kMaxLevels) s_lv[k] = a.lv[k];
    const TrackedBin t = gf3x_eq_track_symbol(a.t, b, d, sm);

    // ---- max-log demap of the data bins
    float md_sum = 0.0f, abs_sum = 0.0f;
    if (k < a.t.U && k % a.t.sp != 0) {
        const int j = k - k / a.t.sp - 1;               // data-bin index
        const float nv_eff = t.nv_sym * (1.0f / fmaxf(t.h2, 1e-12f));
        const float nvc = fmaxf(nv_eff, 1e-12f);
        float* out = a.llr + (static_cast<long long>(b) * D + d) * a.R +
                     static_cast<long long>(j) * 2 * a.m;
        gf3x_demap_bin(a.m, t.xr, t.xi, s_lv, nvc, out, md_sum, abs_sum);
    }
    // ---- block sums of the EVM distances and |llr|
    gf3x_block_sum2(md_sum, abs_sum, s_red);
    if (k == 0) {
        const long long o = static_cast<long long>(b) * D + d;
        a.slope[o] = t.slope;
        a.cpe[o] = t.cpe;
        a.evm_part[o] = md_sum;
        a.abs_part[o] = abs_sum;
    }
}

}  // namespace

GF3X_EXPORT int gf3x_fused_eq_demap(
        const float* y, const float* h, const float* nv, const float* pv,
        float* llr, float* slope, float* cpe, float* evm_part,
        float* abs_part, long long B, int S, int K, int U, int P, int sp,
        int m, const float* levels, int n_ladder, int q0, float base0,
        int q1, float base1, float mean_dk, void* stream) {
    FusedArgs a;
    a.t.y = reinterpret_cast<const float2*>(y);
    a.t.h = reinterpret_cast<const float2*>(h);
    a.t.nv = nv;
    a.t.pv = reinterpret_cast<const float2*>(pv);
    a.t.S = S;
    a.t.K = K;
    a.t.D = S - K;
    a.t.U = U;
    a.t.P = P;
    a.t.sp = sp;
    a.t.n_ladder = n_ladder;
    a.t.ladder_q[0] = q0;
    a.t.ladder_q[1] = q1;
    a.t.ladder_base[0] = base0;
    a.t.ladder_base[1] = base1;
    a.t.mean_dk = mean_dk;
    a.llr = llr;
    a.slope = slope;
    a.cpe = cpe;
    a.evm_part = evm_part;
    a.abs_part = abs_part;
    a.m = m;
    a.R = (U - P) * 2 * m;
    for (int i = 0; i < kMaxLevels; ++i) a.lv[i] = i < (1 << m) ? levels[i] : 0.0f;
    const long long nblocks = B * a.t.D;
    const int threads = ((U + 31) / 32) * 32;
    const size_t smem = gf3x_track_smem_floats(P) * sizeof(float);
    if (nblocks > 0) {
        fused_eq_demap_kernel<<<static_cast<unsigned>(nblocks), threads, smem,
                                static_cast<cudaStream_t>(stream)>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
}
