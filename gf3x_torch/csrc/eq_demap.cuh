// Device code shared by the fused EQ/demap kernel (fused_eq.cu) and the two
// kernels of the split tail (split_eq.cu), so that the tails cannot drift
// apart: the split's equalized bins are the fused kernel's internal ones,
// bit for bit, and both demap a bin with the same max-log code.
//
// One symbol's tracking is held to the XLA twin the JAX CPU path runs, not
// to the Pallas kernels: Modem._eq_tail (gf3x/models/modem.py:639-671) and
// pilot_phase_correct (gf3x/ops/chanest.py:166-211), so angles come from
// atan2f (the Pallas kernels use a polynomial). Its pieces:
//
// - the per-bin arithmetic (gf3x_eq_bin, gf3x_pilot_product,
//   gf3x_derotate, gf3x_pilot_residual);
// - gf3x_fit_pilots_warp: the CSI-weighted pilot phase fit (coarse slope,
//   baseline ladder, intercept) by ONE warp, pilot p on lane p mod 32,
//   synchronised by __syncwarp alone;
// - gf3x_noise_floor_warp: the per-symbol noise floor, likewise;
// - gf3x_track_symbol_warp: one data symbol's chain by one warp — EQ in
//   place, the pilots' products, the fit, the residuals and the noise
//   floor — on the symbol in the warp's shared buffer (fetched there by
//   gf3x_fetch_symbol with cp.async);
// - gf3x_fit_symbol_team: the same chain by a team of warps (TeamBins:
//   the symbol in global memory, Ĥ in shared or global memory), the same
//   bits.
//
// Kernels A and 2 run in one of three layouts (the wrappers' geometry picks
// one). Staged: a block per frame and a warp per data symbol; Ĥ, |Ĥ|² and
// the layout table sit in shared memory once, and each symbol is copied
// into its warp's shared buffer and equalized there
// (gf3x_track_symbol_warp). A then derotates every used bin, 2 derotates
// and demaps the data bins. Both run the same code in the same order, so
// slope, cpe, nv_sym and every derotated bin agree bit for bit.
//
// Teamed, for the wide bands: a team of T warps takes one data symbol and
// a frame's symbols are spread over several blocks (gf3x_fit_symbol_team).
// Every elementwise pass over the symbol's bins — the pilot products, the
// ladder's and the intercept's rotated terms, the residuals, then the data
// bins — is spread over the team's 32·T threads, which store each term to
// the team's one pilot scratch (4P floats) in shared memory; the
// reductions (gf3x_lag_products, the intercept's sum, the noise floor) stay
// on the team's first warp in the warp chain's order, lane p mod 32 adding
// its pilots' stored terms in ascending p. The build has --fmad=false, so
// a term stored and then added rounds as the inline expression does: the
// teamed layout gives the warp chain's bits. Spilled, past the pilot bound
// of shared memory: the teamed layout with each team's scratch in a global
// buffer and the pilot positions read from the table there.
//
#pragma once

#include "common.cuh"

struct TrackArgs {
    const float2* y;     // (B, S, U) bins of every symbol
    const float2* h;     // (B, U) channel estimate
    const float* nv;     // (B,) LS noise variance
    const float2* pv;    // (P,) pilot values
    const int* pos;      // (U,) P pilot positions, then U − P data positions
    int S, K, D, U, P;
    int n_ladder;        // refinement stages (≤ 2)
    int ladder_q[2];     // pilot lag of each stage
    float ladder_base[2];
    float mean_dk;       // mean pilot spacing in bins
};

// Σ_p z[p+lag]·conj(z[p]) over p < n − lag, summed by one warp (all lanes
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

// One-tap EQ of a bin: X̂ = Y / Ĥ, with h2 = |Ĥ|².
__device__ __forceinline__ float2 gf3x_eq_bin(float2 y, float2 h, float h2) {
    return make_float2((y.x * h.x + y.y * h.y) / h2,
                       (y.y * h.x - y.x * h.y) / h2);
}

// |Ĥ|² of a bin, and the clamped inverse the demap scales the noise by.
__device__ __forceinline__ float gf3x_abs2(float2 h) {
    return h.x * h.x + h.y * h.y;
}

__device__ __forceinline__ float gf3x_inv_csi(float h2) {
    return 1.0f / fmaxf(h2, 1e-12f);
}

// A pilot's CSI-weighted product z = X̂_p · conj(p) · |Ĥ_p|².
__device__ __forceinline__ float2 gf3x_pilot_product(float2 x, float2 pv,
                                                     float h2) {
    return make_float2((x.x * pv.x + x.y * pv.y) * h2,
                       (x.y * pv.x - x.x * pv.y) * h2);
}

// Bin k derotated by e^{−i(a·k + b)}.
__device__ __forceinline__ float2 gf3x_derotate(float2 x, float slope, int k,
                                                float cpe) {
    float s, c;
    sincosf(slope * static_cast<float>(k) + cpe, &s, &c);
    return make_float2(x.x * c + x.y * s, x.y * c - x.x * s);
}

// A derotated pilot's noise term |Ĥ_p|²·|X̂_p − p|².
__device__ __forceinline__ float gf3x_pilot_residual(float2 x, float2 pv,
                                                     float h2) {
    const float ur = x.x - pv.x, ui = x.y - pv.y;
    return h2 * (ur * ur + ui * ui);
}

// The pilot phase fit of one symbol by one warp (P ≥ 2): zr/zi hold the P
// CSI-weighted pilot products (visible to the whole warp), kp the pilot
// positions, dr/di are P floats each of scratch. Returns (slope, cpe) in
// every lane.
__device__ __forceinline__ float2 gf3x_fit_pilots_warp(const TrackArgs& a,
                                                       const int* kp,
                                                       const float* zr,
                                                       const float* zi,
                                                       float* dr, float* di,
                                                       int lane) {
    float2 inc = gf3x_lag_products(zr, zi, a.P, 1, lane);
    float slope = atan2f(inc.y, inc.x) / a.mean_dk;
    for (int st = 0; st < a.n_ladder; ++st) {
        for (int p = lane; p < a.P; p += 32) {
            float s, c;
            sincosf(slope * static_cast<float>(kp[p]), &s, &c);
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
        sincosf(slope * static_cast<float>(kp[p]), &s, &c);
        wr += zr[p] * c + zi[p] * s;
        wi += zi[p] * c - zr[p] * s;
    }
    wr = gf3x_warp_sum(wr);
    wi = gf3x_warp_sum(wi);
    return make_float2(slope, atan2f(wi, wr));
}

// The per-symbol noise floor σ̂² = max(nv, Σ_p r[p] / P) by one warp, from
// the P pilot residuals r (visible to the whole warp); every lane gets it.
__device__ __forceinline__ float gf3x_noise_floor_warp(const float* r, int P,
                                                       float nv, int lane) {
    float acc = 0.0f;
    for (int p = lane; p < P; p += 32) acc += r[p];
    acc = gf3x_warp_sum(acc);
    return fmaxf(nv, acc / static_cast<float>(P));
}

// Lane `lane`'s share (bins lane, lane + 32, ...) of data symbol d's bins
// into buf, as one cp.async group; an empty group when d ≥ D.
__device__ __forceinline__ void gf3x_fetch_symbol(const TrackArgs& a, int b,
                                                  int d, float2* buf,
                                                  int lane) {
    if (d < a.D) {
        const float2* src =
            a.y + (static_cast<long long>(b) * a.S + a.K + d) * a.U;
        for (int k = lane; k < a.U; k += 32) gf3x_cp_async8(buf + k, src + k);
    }
    gf3x_cp_async_commit();
}

struct SymbolFit {
    float slope, cpe;    // pilot phase fit a, b
    float nv_sym;        // per-symbol noise floor σ̂²
};

// One data symbol of frame b by one warp, staged: `cur` holds the symbol's
// U bins (the warp's own shared buffer, whose copy has landed) and is
// equalized in place against the frame's Ĥ and |Ĥ|² in shared memory (hs,
// h2s), then tracked: kp holds its P pilot positions in shared memory, zr,
// zi, dr, di P floats each of the warp's scratch. Synchronised by
// __syncwarp alone; every lane gets the fit and the noise floor (the caller
// derotates the bins it needs, where P ≥ 2); `cur` stays equalized but not
// derotated.
__device__ __forceinline__ SymbolFit gf3x_track_symbol_warp(
        const TrackArgs& a, int b, float2* cur, const float2* hs,
        const float* h2s, const int* kp, float* zr, float* zi, float* dr,
        float* di, int lane) {
    for (int k = lane; k < a.U; k += 32) cur[k] = gf3x_eq_bin(cur[k], hs[k], h2s[k]);
    __syncwarp();
    SymbolFit f;
    f.slope = 0.0f;
    f.cpe = 0.0f;
    f.nv_sym = a.nv[b];
    if (a.P == 0) return f;
    for (int p = lane; p < a.P; p += 32) {
        const int k = kp[p];
        const float2 z = gf3x_pilot_product(cur[k], a.pv[p], h2s[k]);
        zr[p] = z.x;
        zi[p] = z.y;
    }
    __syncwarp();
    const bool fit = a.P >= 2;
    if (fit) {
        const float2 sc = gf3x_fit_pilots_warp(a, kp, zr, zi, dr, di, lane);
        f.slope = sc.x;
        f.cpe = sc.y;
    }
    __syncwarp();
    // noise floor from the derotated pilots
    for (int p = lane; p < a.P; p += 32) {
        const int k = kp[p];
        const float2 x = cur[k];
        zr[p] = gf3x_pilot_residual(
            fit ? gf3x_derotate(x, f.slope, k, f.cpe) : x, a.pv[p], h2s[k]);
    }
    __syncwarp();
    f.nv_sym = gf3x_noise_floor_warp(zr, a.P, f.nv_sym, lane);
    return f;
}

// A team of T warps in a block of G teams: team g's warps are g·T ...
// g·T + T − 1; thread tt of the team's n = 32·T; its first warp (rank 0)
// runs the reductions. Synchronised by __syncwarp (T = 1) or by named
// barrier 1 + g over the team's threads (G ≤ 15 teams a block then).
struct Team {
    int T, g, rank, tt, n, lane;
    __device__ __forceinline__ Team(int T_)
        : T(T_), g(static_cast<int>(threadIdx.x) / (32 * T_)),
          rank((static_cast<int>(threadIdx.x) >> 5) % T_),
          tt(static_cast<int>(threadIdx.x) % (32 * T_)), n(32 * T_),
          lane(static_cast<int>(threadIdx.x) & 31) {}
    __device__ __forceinline__ void sync() const {
        if (T == 1) {
            __syncwarp();
        } else {
            asm volatile("bar.sync %0, %1;\n" :: "r"(1 + g), "r"(n)
                         : "memory");
        }
    }
    // v from the first warp's lane 0 (the reductions give every lane of
    // that warp the same value) to every thread of the team, through `slot`
    __device__ __forceinline__ float share(float v, float* slot) const {
        if (rank == 0 && lane == 0) *slot = v;
        sync();
        return *slot;
    }
};

// The teamed layout's bins by used-bin index: y from the symbol's row in
// global memory; Ĥ, |Ĥ|² and 1/max(|Ĥ|², 1e-12) staged in shared memory
// (kStageH) or read from global memory (through L2: 20 symbols a frame
// read one Ĥ row) and recomputed with the staging code's expressions.
template <bool kStageH>
struct TeamBins {
    const float2* y;
    const float2* h;     // shared (kStageH) or global
    const float* h2s;    // shared, kStageH only
    const float* invs;   // shared, kStageH and kernel 2 only
    __device__ __forceinline__ float2 hk(int k) const {
        if constexpr (kStageH) return h[k];
        else return __ldg(h + k);
    }
    __device__ __forceinline__ float h2(int k) const {
        if constexpr (kStageH) return h2s[k];
        else return gf3x_abs2(hk(k));
    }
    __device__ __forceinline__ float2 x(int k) const {
        return gf3x_eq_bin(__ldg(y + k), hk(k), h2(k));
    }
};

// One data symbol of frame b by a team, on its equalized bins `bins`: kp
// holds the P pilot positions, zr, zi, dr, di P floats each of the team's
// scratch, bc three floats of the team's. The same values as
// gf3x_track_symbol_warp, bit for bit: every term is the warp chain's
// expression, stored, and the first warp adds the stored terms in the warp
// chain's order. Every thread of the team gets the fit and the noise floor.
template <typename Bins>
__device__ __forceinline__ SymbolFit gf3x_fit_symbol_team(
        const TrackArgs& a, int b, const Bins& bins, const int* kp, float* zr,
        float* zi, float* dr, float* di, float* bc, const Team& tm) {
    SymbolFit f;
    f.slope = 0.0f;
    f.cpe = 0.0f;
    f.nv_sym = a.nv[b];
    const int P = a.P;
    if (P == 0) return f;
    for (int p = tm.tt; p < P; p += tm.n) {
        const int k = kp[p];
        const float2 z = gf3x_pilot_product(bins.x(k), a.pv[p], bins.h2(k));
        zr[p] = z.x;
        zi[p] = z.y;
    }
    tm.sync();
    const bool fit = P >= 2;
    if (fit) {
        float slope = 0.0f;
        if (tm.rank == 0) {
            const float2 inc = gf3x_lag_products(zr, zi, P, 1, tm.lane);
            slope = atan2f(inc.y, inc.x) / a.mean_dk;
        }
        slope = tm.share(slope, bc);
        for (int st = 0; st < a.n_ladder; ++st) {
            for (int p = tm.tt; p < P; p += tm.n) {
                float s, c;
                sincosf(slope * static_cast<float>(kp[p]), &s, &c);
                dr[p] = zr[p] * c + zi[p] * s;     // z·e^{−i·a·k}
                di[p] = zi[p] * c - zr[p] * s;
            }
            tm.sync();
            if (tm.rank == 0) {
                const float2 corr = gf3x_lag_products(dr, di, P,
                                                      a.ladder_q[st], tm.lane);
                slope = slope + atan2f(corr.y, corr.x) / a.ladder_base[st];
            }
            slope = tm.share(slope, bc);
        }
        // the intercept's terms, then the first warp's sum
        for (int p = tm.tt; p < P; p += tm.n) {
            float s, c;
            sincosf(slope * static_cast<float>(kp[p]), &s, &c);
            dr[p] = zr[p] * c + zi[p] * s;
            di[p] = zi[p] * c - zr[p] * s;
        }
        tm.sync();
        float cpe = 0.0f;
        if (tm.rank == 0) {
            float wr = 0.0f, wi = 0.0f;
            for (int p = tm.lane; p < P; p += 32) {
                wr += dr[p];
                wi += di[p];
            }
            wr = gf3x_warp_sum(wr);
            wi = gf3x_warp_sum(wi);
            cpe = atan2f(wi, wr);
        }
        f.slope = slope;
        f.cpe = tm.share(cpe, bc + 1);
    }
    // noise floor from the derotated pilots
    for (int p = tm.tt; p < P; p += tm.n) {
        const int k = kp[p];
        const float2 x = bins.x(k);
        zr[p] = gf3x_pilot_residual(
            fit ? gf3x_derotate(x, f.slope, k, f.cpe) : x, a.pv[p],
            bins.h2(k));
    }
    tm.sync();
    float nv_sym = f.nv_sym;
    if (tm.rank == 0) nv_sym = gf3x_noise_floor_warp(zr, P, nv_sym, tm.lane);
    f.nv_sym = tm.share(nv_sym, bc + 2);
    return f;
}

// The teamed layout's symbols: block `blk` of a frame's `blocks` takes a
// contiguous run of ⌈D / blocks⌉ of its data symbols, its team g symbols
// lo + g, lo + g + G, ... below hi (FusedGeometry.symbols).
struct TeamSymbols {
    int lo, hi;
    __device__ __forceinline__ TeamSymbols(int D, int blocks, int blk) {
        const int per = (D + blocks - 1) / blocks;
        lo = blk * per;
        hi = min(D, lo + per);
    }
};

// Team g of block `blk` of frame b's slice (zr, zi, dr, di: 4P floats) of
// the spilled layout's global pilot scratch: G teams a block, `blocks`
// blocks a frame.
__device__ __forceinline__ float* gf3x_spilled_scratch(float* scratch, int b,
                                                       int blocks, int blk,
                                                       int G, int g, int P) {
    return scratch +
           ((static_cast<size_t>(b) * blocks + blk) * G + g) * 4 * P;
}

// The frame's layout table (`pos`, n ints) into shared memory by the block.
__device__ __forceinline__ void gf3x_stage_layout(const TrackArgs& a,
                                                  int* s_pos, int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) s_pos[i] = a.pos[i];
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
