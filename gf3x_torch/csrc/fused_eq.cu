// Fused one-tap EQ + CSI-weighted pilot phase tracking + per-symbol noise
// floor + max-log demap, QPSK to 64-QAM.
//
// Replaces gf3x/ops/pallas/fused_eq.py:fused_eq_demap_tpu. It is held to
// the XLA twin the JAX CPU path runs, not to the Pallas kernel:
// Modem._eq_tail (gf3x/models/modem.py:639-671), pilot_phase_correct
// (gf3x/ops/chanest.py:166-211) and Modem._xla_demap (modem.py:911-930).
// So angles come from atan2f (the Pallas kernel uses a polynomial), and the
// effective noise is nv_sym / max(|H|², 1e-12) (the twin's form).
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
// interleaved (re, im) bins coalesce; the pilot fits (35 pilots at GF3
// geometry) are short serial reductions done by warp 0 on values staged in
// shared memory, so the block synchronises three times per symbol.
#include "common.cuh"

namespace {

constexpr int kMaxLevels = 8;   // 64-QAM: 8 PAM levels per axis

struct EqArgs {
    const float2* y;     // (B, S, U) bins of every symbol
    const float2* h;     // (B, U) channel estimate
    const float* nv;     // (B,) LS noise variance
    const float2* pv;    // (P,) pilot values
    float* llr;          // (B, D·R)
    float* slope;        // (B, D)
    float* cpe;          // (B, D)
    float* evm_part;     // (B, D) Σ over data bins of the min distances
    float* abs_part;     // (B, D) Σ |llr|
    int S, K, D, U, P, sp, m, R;
    int n_ladder;        // refinement stages (≤ 2)
    int ladder_q[2];     // pilot lag of each stage
    float ladder_base[2];
    float mean_dk;       // mean pilot spacing in bins
    float lv[kMaxLevels];   // PAM level of each Gray label
};

// Σ_p z[p+lag]·conj(z[p]) over p < n − lag, summed by warp 0 (all lanes
// get the result).
__device__ __forceinline__ float2 lag_products(const float* zr, const float* zi,
                                               int n, int lag, int lane) {
    float cr = 0.0f, ci = 0.0f;
    for (int p = lane + lag; p < n; p += 32) {
        cr += zr[p] * zr[p - lag] + zi[p] * zi[p - lag];
        ci += zi[p] * zr[p - lag] - zr[p] * zi[p - lag];
    }
    return make_float2(gf3x_warp_sum(cr), gf3x_warp_sum(ci));
}

__global__ void fused_eq_demap_kernel(EqArgs a) {
    extern __shared__ float sm[];
    float* zr = sm;             // (P,) CSI-weighted pilot products
    float* zi = zr + a.P;
    float* dr = zi + a.P;       // (P,) derotated copies for the ladder
    float* di = dr + a.P;
    __shared__ float s_a, s_b, s_nv;
    __shared__ float s_red[2][32];

    const int b = blockIdx.x / a.D;
    const int d = blockIdx.x % a.D;
    const int k = threadIdx.x;
    const int lane = k & 31, warp = k >> 5;
    const bool bin = k < a.U;
    const bool pilot = bin && (k % a.sp == 0);

    // ---- one-tap EQ: X̂ = Y / Ĥ
    float er = 0.0f, ei = 0.0f, h2 = 0.0f;
    if (bin) {
        const float2 y = a.y[(static_cast<long long>(b) * a.S + a.K + d) * a.U + k];
        const float2 h = a.h[static_cast<long long>(b) * a.U + k];
        h2 = h.x * h.x + h.y * h.y;
        er = (y.x * h.x + y.y * h.y) / h2;
        ei = (y.y * h.x - y.x * h.y) / h2;
    }
    if (pilot) {
        // z = X̂_p · conj(p) · |Ĥ_p|²
        const int p = k / a.sp;
        const float2 pv = a.pv[p];
        zr[p] = (er * pv.x + ei * pv.y) * h2;
        zi[p] = (ei * pv.x - er * pv.y) * h2;
    }
    __syncthreads();

    // ---- slope (coarse + baseline ladder) and intercept, by warp 0
    if (warp == 0) {
        float2 inc = lag_products(zr, zi, a.P, 1, lane);
        float slope = atan2f(inc.y, inc.x) / a.mean_dk;
        for (int st = 0; st < a.n_ladder; ++st) {
            for (int p = lane; p < a.P; p += 32) {
                float s, c;
                sincosf(slope * static_cast<float>(p * a.sp), &s, &c);
                dr[p] = zr[p] * c + zi[p] * s;     // z·e^{−i·a·k}
                di[p] = zi[p] * c - zr[p] * s;
            }
            __syncwarp();
            const float2 corr = lag_products(dr, di, a.P, a.ladder_q[st], lane);
            slope = slope + atan2f(corr.y, corr.x) / a.ladder_base[st];
            __syncwarp();
        }
        float wr = 0.0f, wi = 0.0f;
        for (int p = lane; p < a.P; p += 32) {
            float s, c;
            sincosf(slope * static_cast<float>(p * a.sp), &s, &c);
            wr += zr[p] * c + zi[p] * s;
            wi += zi[p] * c - zr[p] * s;
        }
        wr = gf3x_warp_sum(wr);
        wi = gf3x_warp_sum(wi);
        if (lane == 0) {
            s_a = slope;
            s_b = atan2f(wi, wr);
        }
    }
    __syncthreads();

    // ---- derotate every used bin by e^{−i(a·k + b)}
    const float sl = s_a, ph0 = s_b;
    float xr = 0.0f, xi = 0.0f;
    if (bin) {
        float s, c;
        sincosf(sl * static_cast<float>(k) + ph0, &s, &c);
        xr = er * c + ei * s;
        xi = ei * c - er * s;
    }
    // ---- per-symbol noise floor σ̂² = Σ_p |Ĥ_p|²·|X̂_p − p|² / P
    if (pilot) {
        const int p = k / a.sp;
        const float2 pv = a.pv[p];
        const float ur = xr - pv.x, ui = xi - pv.y;
        zr[p] = h2 * (ur * ur + ui * ui);
    }
    __syncthreads();
    if (warp == 0) {
        float acc = 0.0f;
        for (int p = lane; p < a.P; p += 32) acc += zr[p];
        acc = gf3x_warp_sum(acc);
        if (lane == 0) s_nv = fmaxf(a.nv[b], acc / static_cast<float>(a.P));
    }
    __syncthreads();

    // ---- max-log demap of the data bins
    float md_sum = 0.0f, abs_sum = 0.0f;
    if (bin && !pilot) {
        const int j = k - k / a.sp - 1;                 // data-bin index
        const float nv_eff = s_nv * (1.0f / fmaxf(h2, 1e-12f));
        const float nvc = fmaxf(nv_eff, 1e-12f);
        const int M = 1 << a.m;
        float* out = a.llr + (static_cast<long long>(b) * a.D + d) * a.R +
                     static_cast<long long>(j) * 2 * a.m;
        for (int ax = 0; ax < 2; ++ax) {
            const float x = ax == 0 ? xr : xi;
            float d0[3] = {3.0e38f, 3.0e38f, 3.0e38f};
            float d1[3] = {3.0e38f, 3.0e38f, 3.0e38f};
            float md = 3.0e38f;
            for (int lbl = 0; lbl < M; ++lbl) {
                const float t = x - a.lv[lbl];
                const float dd = t * t;
                md = fminf(md, dd);
                for (int jj = 0; jj < a.m; ++jj) {
                    if ((lbl >> (a.m - 1 - jj)) & 1) d1[jj] = fminf(d1[jj], dd);
                    else d0[jj] = fminf(d0[jj], dd);
                }
            }
            md_sum += md;
            for (int jj = 0; jj < a.m; ++jj) {
                const float l = (d1[jj] - d0[jj]) / nvc;
                out[ax * a.m + jj] = l;
                abs_sum += fabsf(l);
            }
        }
    }
    // ---- block sums of the EVM distances and |llr|
    md_sum = gf3x_warp_sum(md_sum);
    abs_sum = gf3x_warp_sum(abs_sum);
    if (lane == 0) {
        s_red[0][warp] = md_sum;
        s_red[1][warp] = abs_sum;
    }
    __syncthreads();
    if (warp == 0) {
        const int nw = (blockDim.x + 31) >> 5;
        float e = lane < nw ? s_red[0][lane] : 0.0f;
        float s = lane < nw ? s_red[1][lane] : 0.0f;
        e = gf3x_warp_sum(e);
        s = gf3x_warp_sum(s);
        if (lane == 0) {
            const long long o = static_cast<long long>(b) * a.D + d;
            a.slope[o] = sl;
            a.cpe[o] = ph0;
            a.evm_part[o] = e;
            a.abs_part[o] = s;
        }
    }
}

}  // namespace

GF3X_EXPORT int gf3x_fused_eq_demap(
        const float* y, const float* h, const float* nv, const float* pv,
        float* llr, float* slope, float* cpe, float* evm_part,
        float* abs_part, long long B, int S, int K, int U, int P, int sp,
        int m, const float* levels, int n_ladder, int q0, float base0,
        int q1, float base1, float mean_dk, void* stream) {
    EqArgs a;
    a.y = reinterpret_cast<const float2*>(y);
    a.h = reinterpret_cast<const float2*>(h);
    a.nv = nv;
    a.pv = reinterpret_cast<const float2*>(pv);
    a.llr = llr;
    a.slope = slope;
    a.cpe = cpe;
    a.evm_part = evm_part;
    a.abs_part = abs_part;
    a.S = S;
    a.K = K;
    a.D = S - K;
    a.U = U;
    a.P = P;
    a.sp = sp;
    a.m = m;
    a.R = (U - P) * 2 * m;
    a.n_ladder = n_ladder;
    a.ladder_q[0] = q0;
    a.ladder_q[1] = q1;
    a.ladder_base[0] = base0;
    a.ladder_base[1] = base1;
    a.mean_dk = mean_dk;
    for (int i = 0; i < kMaxLevels; ++i) a.lv[i] = i < (1 << m) ? levels[i] : 0.0f;
    const long long nblocks = B * a.D;
    const int threads = ((U + 31) / 32) * 32;
    const size_t smem = 4 * static_cast<size_t>(P) * sizeof(float);
    if (nblocks > 0) {
        fused_eq_demap_kernel<<<static_cast<unsigned>(nblocks), threads, smem,
                                static_cast<cudaStream_t>(stream)>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
}
