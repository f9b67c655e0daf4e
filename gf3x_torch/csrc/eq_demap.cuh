// Device code shared by the fused EQ/demap kernel (fused_eq.cu) and the two
// kernels of the split tail (split_eq.cu), so that the tails cannot drift
// apart: the split's equalized bins are the fused kernel's internal ones,
// bit for bit, and both demap a bin with the same max-log code.
//
// gf3x_eq_track_symbol: one-tap EQ, CSI-weighted pilot phase tracking
// (coarse slope, baseline ladder, intercept), derotation and the
// per-symbol noise floor of one (frame, data symbol). It is held to the
// XLA twin the JAX CPU path runs, not to the Pallas kernels:
// Modem._eq_tail (gf3x/models/modem.py:639-671) and pilot_phase_correct
// (gf3x/ops/chanest.py:166-211), so angles come from atan2f (the Pallas
// kernels use a polynomial).
//
// Layout: one block per (frame, data symbol), thread k = used bin k. The
// pilot fits are short serial reductions over the P pilots (35 at GF3
// geometry) that depend on each other, so warp 0 runs them on products
// staged in shared memory while the block waits.
#pragma once

#include "common.cuh"

struct TrackArgs {
    const float2* y;     // (B, S, U) bins of every symbol
    const float2* h;     // (B, U) channel estimate
    const float* nv;     // (B,) LS noise variance
    const float2* pv;    // (P,) pilot values
    int S, K, D, U, P, sp;
    int n_ladder;        // refinement stages (≤ 2)
    int ladder_q[2];     // pilot lag of each stage
    float ladder_base[2];
    float mean_dk;       // mean pilot spacing in bins
};

// Dynamic shared memory gf3x_eq_track_symbol needs, in floats.
inline int gf3x_track_smem_floats(int P) { return 4 * P + 3; }

struct TrackedBin {
    float xr, xi;        // derotated equalized bin (0 beyond U)
    float h2;            // |Ĥ_k|²
    float nv_sym;        // per-symbol noise floor σ̂² (same on every thread)
    float slope, cpe;    // pilot phase fit a, b (same on every thread)
};

// Σ_p z[p+lag]·conj(z[p]) over p < n − lag, summed by warp 0 (all lanes
// get the result).
__device__ __forceinline__ float2 gf3x_lag_products(const float* zr,
                                                    const float* zi, int n,
                                                    int lag, int lane) {
    float cr = 0.0f, ci = 0.0f;
    for (int p = lane + lag; p < n; p += 32) {
        cr += zr[p] * zr[p - lag] + zi[p] * zi[p - lag];
        ci += zi[p] * zr[p - lag] - zr[p] * zi[p - lag];
    }
    return make_float2(gf3x_warp_sum(cr), gf3x_warp_sum(ci));
}

// Every thread of the block must call this (it synchronises the block);
// `sm` is gf3x_track_smem_floats(P) floats of shared scratch. The kernels
// declare their argument struct __grid_constant__, so `a` refers to the
// parameter bank itself and is not copied to a local stack frame.
__device__ __forceinline__ TrackedBin gf3x_eq_track_symbol(
        const TrackArgs& a, int b, int d, float* sm) {
    float* zr = sm;             // (P,) CSI-weighted pilot products
    float* zi = zr + a.P;
    float* dr = zi + a.P;       // (P,) derotated copies for the ladder
    float* di = dr + a.P;
    float* s_abn = di + a.P;    // slope, intercept, noise floor

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
        float2 inc = gf3x_lag_products(zr, zi, a.P, 1, lane);
        float slope = atan2f(inc.y, inc.x) / a.mean_dk;
        for (int st = 0; st < a.n_ladder; ++st) {
            for (int p = lane; p < a.P; p += 32) {
                float s, c;
                sincosf(slope * static_cast<float>(p * a.sp), &s, &c);
                dr[p] = zr[p] * c + zi[p] * s;     // z·e^{−i·a·k}
                di[p] = zi[p] * c - zr[p] * s;
            }
            __syncwarp();
            const float2 corr = gf3x_lag_products(dr, di, a.P, a.ladder_q[st], lane);
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
            s_abn[0] = slope;
            s_abn[1] = atan2f(wi, wr);
        }
    }
    __syncthreads();

    // ---- derotate every used bin by e^{−i(a·k + b)}
    TrackedBin t;
    t.slope = s_abn[0];
    t.cpe = s_abn[1];
    t.h2 = h2;
    t.xr = 0.0f;
    t.xi = 0.0f;
    if (bin) {
        float s, c;
        sincosf(t.slope * static_cast<float>(k) + t.cpe, &s, &c);
        t.xr = er * c + ei * s;
        t.xi = ei * c - er * s;
    }
    // ---- per-symbol noise floor σ̂² = Σ_p |Ĥ_p|²·|X̂_p − p|² / P
    if (pilot) {
        const int p = k / a.sp;
        const float2 pv = a.pv[p];
        const float ur = t.xr - pv.x, ui = t.xi - pv.y;
        zr[p] = h2 * (ur * ur + ui * ui);
    }
    __syncthreads();
    if (warp == 0) {
        float acc = 0.0f;
        for (int p = lane; p < a.P; p += 32) acc += zr[p];
        acc = gf3x_warp_sum(acc);
        if (lane == 0) s_abn[2] = fmaxf(a.nv[b], acc / static_cast<float>(a.P));
    }
    __syncthreads();
    t.nv_sym = s_abn[2];
    return t;
}

// Max-log LLRs of one PAM axis with 2^m levels `lv` (indexed by Gray
// label): m LLRs (d1 − d0)/nvc into out[0..m), the minimum distance (the
// hard decision's EVM term) into md_sum, Σ|llr| into abs_sum.
template <int m>
__device__ __forceinline__ void gf3x_demap_axis(float x, const float* lv,
                                                float nvc, float* out,
                                                float& md_sum, float& abs_sum) {
    float d0[m], d1[m];
#pragma unroll
    for (int j = 0; j < m; ++j) d0[j] = d1[j] = 3.0e38f;
    float md = 3.0e38f;
#pragma unroll
    for (int lbl = 0; lbl < (1 << m); ++lbl) {
        const float t = x - lv[lbl];
        const float dd = t * t;
        md = fminf(md, dd);
#pragma unroll
        for (int j = 0; j < m; ++j) {
            if ((lbl >> (m - 1 - j)) & 1) d1[j] = fminf(d1[j], dd);
            else d0[j] = fminf(d0[j], dd);
        }
    }
    md_sum += md;
#pragma unroll
    for (int j = 0; j < m; ++j) {
        const float l = (d1[j] - d0[j]) / nvc;
        out[j] = l;
        abs_sum += fabsf(l);
    }
}

// One QAM bin of 2m bits (m = 1, 2, 3): the m I-axis LLRs, then the m
// Q-axis LLRs, into out[0..2m) — qam_demap_llr's bit order.
__device__ __forceinline__ void gf3x_demap_bin(int m, float xr, float xi,
                                               const float* lv, float nvc,
                                               float* out, float& md_sum,
                                               float& abs_sum) {
    switch (m) {
    case 1:
        gf3x_demap_axis<1>(xr, lv, nvc, out, md_sum, abs_sum);
        gf3x_demap_axis<1>(xi, lv, nvc, out + 1, md_sum, abs_sum);
        break;
    case 2:
        gf3x_demap_axis<2>(xr, lv, nvc, out, md_sum, abs_sum);
        gf3x_demap_axis<2>(xi, lv, nvc, out + 2, md_sum, abs_sum);
        break;
    default:
        gf3x_demap_axis<3>(xr, lv, nvc, out, md_sum, abs_sum);
        gf3x_demap_axis<3>(xi, lv, nvc, out + 3, md_sum, abs_sum);
        break;
    }
}

// Block sums of two per-thread values into (e, s) on thread 0; `red` is
// 64 floats of shared memory.
__device__ __forceinline__ void gf3x_block_sum2(float& e, float& s,
                                                float* red) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    e = gf3x_warp_sum(e);
    s = gf3x_warp_sum(s);
    if (lane == 0) {
        red[warp] = e;
        red[32 + warp] = s;
    }
    __syncthreads();
    if (warp == 0) {
        const int nw = (blockDim.x + 31) >> 5;
        e = gf3x_warp_sum(lane < nw ? red[lane] : 0.0f);
        s = gf3x_warp_sum(lane < nw ? red[32 + lane] : 0.0f);
    }
}
