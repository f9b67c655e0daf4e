// Fused one-tap EQ + CSI-weighted pilot phase tracking + per-symbol noise
// floor + max-log demap, QPSK to 64-QAM, one warp per (frame, data symbol).
//
// Replaces gf3x/ops/pallas/fused_eq.py:fused_eq_demap_tpu. It is held to
// the XLA twin the JAX CPU path runs, not to the Pallas kernel:
// Modem._eq_tail (gf3x/models/modem.py:639-671), pilot_phase_correct
// (gf3x/ops/chanest.py:166-211) and Modem._xla_demap (modem.py:911-930).
// So angles come from atan2f (the Pallas kernel uses a polynomial), and the
// effective noise is nv_sym / max(|H|², 1e-12) (the twin's form). The EQ,
// tracking and noise-floor code is the split tail's (eq_demap.cuh), so the
// LLRs, slope and cpe equal kernels A + B's bit for bit on a uniform config.
//
// Output is the twin's layout: scrambled, interleaved data-bin LLRs
// (B, D·R) in qam_demap_llr bit order (per data bin: m I-axis bits, then m
// Q-axis bits), slope and cpe (B, D), and per frame the mean EVM distance
// over the data bins and the mean |llr|.
//
// What bounds it on the card: bytes. It reads the data symbols' bins, Ĥ and
// the noise floor and writes the LLRs and the diagnostics: 88.5 MB at
// config 5 (B = 1024, U = 280, QPSK), 176.8 MB at U = 560 — 0.026 and
// 0.053 ms at 3.35 TB/s. The arithmetic is a few dozen flops per bin. What
// kept the first design (one block per symbol, a thread per bin) at 11-13 %
// of that rate was latency: the pilot fit is a serial chain of warp
// reductions, atan2f and sincosf that one warp ran while the block's other
// warps waited at barriers, and at most 3-7 such blocks fit on an SM.
//
// Design: a block takes one frame. It stages Ĥ, |Ĥ|², 1/max(|Ĥ|², 1e-12)
// and the layout table (the pilot positions, then the used-bin index of
// each data bin) in shared memory once (one block barrier); its W warps
// then walk the frame's D data symbols, warp w taking symbols w, w + W,
// ... Each warp runs its symbol's whole chain (EQ, fit, noise floor,
// demap) synchronised by __syncwarp alone, and copies its next symbol's bins into its second
// shared-memory buffer with cp.async while it works on the current one. So
// every SM holds many independent chains instead of one per block. W and
// the shared-memory size come from the wrapper (fused_eq_geometry), which
// fits the batch's frames onto the SMs. A lane stores a data bin's 2m LLRs
// as vectors: one float2 (QPSK), one float4 (16-QAM), a float4 and a float2
// (64-QAM). The block reduces its symbols' EVM and |llr| sums in a fixed
// order and writes the frame's means itself.
//
// What held it back at the wide bands: each warp keeps its own pilot
// scratch (4P floats) and its symbol buffers, so an SM holds one
// block of 4-10 warps; each lane walks U/32 bins of a symbol in a row; and
// a block takes a whole frame, so a batch of 64 frames leaves half the SMs
// empty. The teamed layout (fused_eq_demap_team_kernel) answers the three: a
// team of T warps takes a symbol (eq_demap.cuh's gf3x_fit_symbol_team), one
// pilot scratch a team, every elementwise pass over the team's threads
// with each lane's loads batched kUnroll bins at a time; and the grid is
// (B, blocks), block `blk` taking a contiguous run of the frame's symbols,
// so B = 1 fills the card too. Ĥ, |Ĥ|², the clamped inverse and the layout
// table are staged in shared memory (kStageH) or read through L2. A thread
// keeps its EVM and |llr| sums over its bins of its symbols; the block adds
// its warps' sums in order, and with blocks > 1 writes them to `part`, and
// the frame's last block (a ticket after __threadfence) adds the blocks'
// in order. So llr, slope and cpe keep the other layouts' bits; evm and
// mean |llr| are summed in another order (with one team of one warp and
// one block a frame, the staged layout's order).
//
// Past the pilot bound of shared memory (one team's 4P floats, P > 11 621)
// the spilled layout is the teamed kernel with each team's pilot scratch in
// its own slice of a global buffer and the pilot positions read from the
// layout table in global memory (kSpilled).
#include <cstdint>

#include "eq_demap.cuh"

namespace {

constexpr int kMaxLevels = 8;   // 64-QAM: 8 PAM levels per axis
constexpr int kUnroll = 4;      // bins a lane loads before it computes them

struct FusedArgs {
    TrackArgs t;
    float* llr;          // (B, D·R)
    float* slope;        // (B, D)
    float* cpe;          // (B, D)
    float* evm;          // (B,) mean min distance over the data bins
    float* mabs;         // (B,) mean |llr|
    int R;               // LLRs per data symbol
    int warps;           // W warps a block
    int nbuf;            // symbol buffers per warp: 2 when W < D, else 1;
                         // 0 for the teamed layout
    int team;            // T warps a data symbol (teamed, spilled)
    int blocks;          // blocks a frame (teamed, spilled)
    float evm_div;       // D · n_data_bins
    float abs_div;       // D · R
    float* scratch;      // the spilled layout's pilot scratch, else null
    float* part;         // (B, blocks, 2) the blocks' sums when blocks > 1
    int* ticket;         // (B,) zeroed: blocks of the frame done
    float lv[kMaxLevels];   // PAM level of each Gray label
};

// A data bin's 2m LLRs as vector stores (`out` is 8-byte aligned; 16 when
// m = 2).
template <int m>
__device__ __forceinline__ void store_llrs(float* out, const float* l) {
    if constexpr (m == 1) {
        *reinterpret_cast<float2*>(out) = make_float2(l[0], l[1]);
    } else if constexpr (m == 2) {
        *reinterpret_cast<float4*>(out) = make_float4(l[0], l[1], l[2], l[3]);
    } else if ((reinterpret_cast<uintptr_t>(out) & 15) == 0) {
        *reinterpret_cast<float4*>(out) = make_float4(l[0], l[1], l[2], l[3]);
        *reinterpret_cast<float2*>(out + 4) = make_float2(l[4], l[5]);
    } else {
        *reinterpret_cast<float2*>(out) = make_float2(l[0], l[1]);
        *reinterpret_cast<float4*>(out + 2) = make_float4(l[2], l[3], l[4], l[5]);
    }
}

// One data bin: x derotated (where there is a fit), demapped at nv_sym ·
// inv, its 2m LLRs stored at out.
template <int m>
__device__ __forceinline__ void demap_bin(float2 x, float inv, int k,
                                          const SymbolFit& f, bool derotate,
                                          const float* lv, float* out,
                                          float& md_sum, float& abs_sum) {
    if (derotate) x = gf3x_derotate(x, f.slope, k, f.cpe);
    const float nv_eff = f.nv_sym * inv;
    const float nvc = fmaxf(nv_eff, 1e-12f);
    float l[2 * m];
    gf3x_demap_axis<m>(x.x, lv, nvc, l, md_sum, abs_sum);
    gf3x_demap_axis<m>(x.y, lv, nvc, l + m, md_sum, abs_sum);
    store_llrs<m>(out, l);
}

// The block's EVM and |llr| sums (its warps' in order) to the frame's
// means: written by the block itself when it is the frame's only one, else
// to `part`, and the frame's last block adds the blocks' in order. `red`
// holds 2·W floats of shared memory. Called by every thread.
__device__ __forceinline__ void frame_sums(const FusedArgs& a, int b, int blk,
                                           float md_sum, float abs_sum,
                                           float* red) {
    const int W = a.warps, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    md_sum = gf3x_warp_sum(md_sum);
    abs_sum = gf3x_warp_sum(abs_sum);
    if (lane == 0) {
        red[w] = md_sum;
        red[W + w] = abs_sum;
    }
    __syncthreads();
    if (threadIdx.x != 0) return;
    float e = 0.0f, s = 0.0f;
    for (int v = 0; v < W; ++v) {
        e += red[v];
        s += red[W + v];
    }
    if (a.blocks > 1) {
        float* mine = a.part + (static_cast<size_t>(b) * a.blocks + blk) * 2;
        mine[0] = e;
        mine[1] = s;
        __threadfence();
        if (atomicAdd(a.ticket + b, 1) != a.blocks - 1) return;
        __threadfence();
        const float* all = a.part + static_cast<size_t>(b) * a.blocks * 2;
        e = 0.0f;
        s = 0.0f;
        for (int j = 0; j < a.blocks; ++j) {
            e += __ldcg(all + 2 * j);
            s += __ldcg(all + 2 * j + 1);
        }
    }
    a.evm[b] = e / a.evm_div;
    a.mabs[b] = s / a.abs_div;
}

// The staged layout. Dynamic shared memory, in floats (the wrapper's
// fused_eq_geometry computes the same): Ĥ (2U) | W·nbuf symbol buffers (2U
// each) | |Ĥ|² (U) | 1/max(|Ĥ|², 1e-12) (U) | W pilot scratches (4P each) |
// the W warps' two sums | the layout table (U ints: P pilot positions,
// U − P data positions).
template <int m>
__global__ void __launch_bounds__(1024, 1)
fused_eq_demap_kernel(const __grid_constant__ FusedArgs a) {
    extern __shared__ __align__(16) float sm[];
    const TrackArgs& t = a.t;
    const int U = t.U, P = t.P, D = t.D, W = a.warps;
    const int b = blockIdx.x;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const size_t rows = 4 * U + 2 * U * W * a.nbuf;
    float2* hs = reinterpret_cast<float2*>(sm);
    float2* buf = hs + U + static_cast<size_t>(w) * a.nbuf * U;
    float* h2s = sm + 2 * U + 2 * U * W * a.nbuf;
    float* inv_csi = h2s + U;
    float* zr = sm + rows + 4 * P * w;
    float* zi = zr + P;
    float* dr = zi + P;
    float* di = dr + P;
    float* red = sm + rows + 4 * P * W;
    int* s_pos = reinterpret_cast<int*>(red + 2 * W);
    const int* kp = s_pos;
    const int* dpos = kp + P;
    const float2* hrow = t.h + static_cast<long long>(b) * U;

    // the warp's first symbol is in flight while the block stages Ĥ
    gf3x_fetch_symbol(t, b, w, buf, lane);
    for (int k = threadIdx.x; k < U; k += blockDim.x) {
        const float2 h = hrow[k];
        const float h2 = gf3x_abs2(h);
        hs[k] = h;
        h2s[k] = h2;
        inv_csi[k] = gf3x_inv_csi(h2);
    }
    gf3x_stage_layout(t, s_pos, U);
    __syncthreads();

    float lv[kMaxLevels];
#pragma unroll
    for (int i = 0; i < kMaxLevels; ++i) lv[i] = a.lv[i];
    const int nd = U - P;
    const bool derotate = P >= 2;
    float md_sum = 0.0f, abs_sum = 0.0f;
    for (int d = w, i = 0; d < D; d += W, ++i) {
        float2* cur = buf + (i & (a.nbuf - 1)) * U;
        gf3x_fetch_symbol(t, b, d + W, buf + ((i + 1) & (a.nbuf - 1)) * U,
                          lane);
        gf3x_cp_async_wait_all_but_newest();
        __syncwarp();
        const SymbolFit f = gf3x_track_symbol_warp(t, b, cur, hs, h2s, kp, zr,
                                                   zi, dr, di, lane);

        // derotate and demap the data bins
        const long long o = static_cast<long long>(b) * D + d;
        float* row = a.llr + o * a.R;
        for (int j = lane; j < nd; j += 32) {
            const int k = dpos[j];
            demap_bin<m>(cur[k], inv_csi[k], k, f, derotate, lv,
                         row + 2 * m * j, md_sum, abs_sum);
        }
        if (lane == 0) {
            a.slope[o] = f.slope;
            a.cpe[o] = f.cpe;
        }
        __syncwarp();   // cur and the scratch are rewritten next
    }
    frame_sums(a, b, 0, md_sum, abs_sum, red);
}

// The teamed layout (kSpilled: its pilot scratch in a.scratch), grid (B,
// blocks), G = W / T teams a block. Dynamic shared memory, in floats (the
// wrapper's fused_eq_geometry computes the same): kStageH: Ĥ (2U) | |Ĥ|²
// (U) | 1/max(|Ĥ|², 1e-12) (U) | the layout table (U ints); then, unless
// kSpilled, the G teams' pilot scratch (4P each) | the G teams' three
// shared values (4 each) | the W warps' two sums | unless kStageH or
// kSpilled, the P pilot positions (ints). Data positions are read from
// the layout table in global memory unless staged.
template <int m, bool kStageH, bool kSpilled>
__global__ void __launch_bounds__(1024, 1)
fused_eq_demap_team_kernel(const __grid_constant__ FusedArgs a) {
    extern __shared__ __align__(16) float sm[];
    const TrackArgs& t = a.t;
    const int U = t.U, P = t.P, D = t.D, W = a.warps;
    const int b = blockIdx.x, blk = blockIdx.y;
    const Team tm(a.team);
    const int G = W / a.team;
    float* stage = sm;
    float* scr = stage + (kStageH ? 5 * U : 0);
    float* bc = scr + (kSpilled ? 0 : 4 * P * G);
    float* red = bc + 4 * G;
    int* s_pos = reinterpret_cast<int*>(kStageH ? stage + 4 * U : red + 2 * W);
    float* zr = kSpilled ? gf3x_spilled_scratch(a.scratch, b, a.blocks, blk,
                                                G, tm.g, P)
                         : scr + 4 * P * tm.g;
    float* zi = zr + P;
    float* dr = zi + P;
    float* di = dr + P;
    const float2* hrow = t.h + static_cast<long long>(b) * U;
    float2* hs = reinterpret_cast<float2*>(stage);
    float* h2s = stage + 2 * U;
    float* invs = stage + 3 * U;

    if constexpr (kStageH) {
        for (int k = threadIdx.x; k < U; k += blockDim.x) {
            const float2 h = hrow[k];
            const float h2 = gf3x_abs2(h);
            hs[k] = h;
            h2s[k] = h2;
            invs[k] = gf3x_inv_csi(h2);
        }
        gf3x_stage_layout(t, s_pos, U);
    } else if constexpr (!kSpilled) {
        gf3x_stage_layout(t, s_pos, P);
    }
    __syncthreads();
    const int* kp = kSpilled ? t.pos : s_pos;
    const int* dpos = kStageH ? s_pos + P : t.pos + P;

    float lv[kMaxLevels];
#pragma unroll
    for (int i = 0; i < kMaxLevels; ++i) lv[i] = a.lv[i];
    const int nd = U - P;
    const bool derotate = P >= 2;
    float md_sum = 0.0f, abs_sum = 0.0f;
    const TeamSymbols run(D, a.blocks, blk);
    for (int d = run.lo + tm.g; d < run.hi; d += G) {
        const float2* yrow = t.y + (static_cast<long long>(b) * t.S + t.K + d) * U;
        const TeamBins<kStageH> bins{yrow, kStageH ? hs : hrow, h2s, invs};
        const SymbolFit f = gf3x_fit_symbol_team(t, b, bins, kp, zr, zi, dr,
                                                 di, bc + 4 * tm.g, tm);
        const long long o = static_cast<long long>(b) * D + d;
        float* row = a.llr + o * a.R;
        for (int j0 = tm.tt; j0 < nd; j0 += kUnroll * tm.n) {
            int k[kUnroll];
            float2 y[kUnroll], h[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int j = j0 + u * tm.n;
                k[u] = j < nd ? dpos[j] : 0;
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                y[u] = __ldg(yrow + k[u]);
                h[u] = bins.hk(k[u]);
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int j = j0 + u * tm.n;
                if (j >= nd) break;
                float h2, inv;
                if constexpr (kStageH) {
                    h2 = h2s[k[u]];
                    inv = invs[k[u]];
                } else {
                    h2 = gf3x_abs2(h[u]);
                    inv = gf3x_inv_csi(h2);
                }
                demap_bin<m>(gf3x_eq_bin(y[u], h[u], h2), inv, k[u], f,
                             derotate, lv, row + 2 * m * j, md_sum, abs_sum);
            }
        }
        if (tm.tt == 0) {
            a.slope[o] = f.slope;
            a.cpe[o] = f.cpe;
        }
    }
    frame_sums(a, b, blk, md_sum, abs_sum, red);
}

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, size_t (&smem_set)[kMaxDevices],
                          const FusedArgs& a, long long B, int smem,
                          cudaStream_t stream) {
    const cudaError_t e = gf3x_allow_smem(kernel, smem, smem_set);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(static_cast<unsigned>(B), static_cast<unsigned>(a.blocks)),
             32 * a.warps, smem, stream>>>(a);
    return cudaGetLastError();
}

template <int m>
cudaError_t launch_staged(const FusedArgs& a, long long B, int smem,
                          cudaStream_t stream) {
    static size_t smem_set[kMaxDevices] = {};
    return launch_kernel(fused_eq_demap_kernel<m>, smem_set, a, B, smem,
                         stream);
}

template <int m, bool kStageH, bool kSpilled>
cudaError_t launch_team(const FusedArgs& a, long long B, int smem,
                        cudaStream_t stream) {
    static size_t smem_set[kMaxDevices] = {};
    return launch_kernel(fused_eq_demap_team_kernel<m, kStageH, kSpilled>,
                         smem_set, a, B, smem, stream);
}

// The layout: spilled where there is a global pilot scratch, teamed where
// a team has more than one warp or a frame more than one block, else staged
// (nbuf > 0); one warp a team and one block a frame with no symbol buffer
// and no scratch is no launch.
template <int m>
cudaError_t launch_fused(const FusedArgs& a, long long B, int smem,
                         int stage_h, cudaStream_t stream) {
    if (a.scratch != nullptr)
        return launch_team<m, false, true>(a, B, smem, stream);
    if (a.team > 1 || a.blocks > 1) {
        return stage_h ? launch_team<m, true, false>(a, B, smem, stream)
                       : launch_team<m, false, false>(a, B, smem, stream);
    }
    if (a.nbuf == 0) return cudaErrorInvalidValue;
    return launch_staged<m>(a, B, smem, stream);
}

}  // namespace

GF3X_EXPORT int gf3x_fused_eq_demap(
        const float* y, const float* h, const float* nv, const float* pv,
        const int* pos, float* llr, float* slope, float* cpe, float* evm,
        float* mabs, long long B, int S, int K, int U, int P, int m,
        const float* levels, int n_ladder, int q0, float base0, int q1,
        float base1, float mean_dk, int warps, int nbuf, int smem,
        float evm_div, float abs_div, float* scratch, int team, int blocks,
        int stage_h, float* part, int* ticket, void* stream) {
    FusedArgs a;
    a.t.y = reinterpret_cast<const float2*>(y);
    a.t.h = reinterpret_cast<const float2*>(h);
    a.t.nv = nv;
    a.t.pv = reinterpret_cast<const float2*>(pv);
    a.t.pos = pos;
    a.t.S = S;
    a.t.K = K;
    a.t.D = S - K;
    a.t.U = U;
    a.t.P = P;
    a.t.n_ladder = n_ladder;
    a.t.ladder_q[0] = q0;
    a.t.ladder_q[1] = q1;
    a.t.ladder_base[0] = base0;
    a.t.ladder_base[1] = base1;
    a.t.mean_dk = mean_dk;
    a.llr = llr;
    a.slope = slope;
    a.cpe = cpe;
    a.evm = evm;
    a.mabs = mabs;
    a.R = (U - P) * 2 * m;
    a.warps = warps;
    a.nbuf = nbuf;
    a.team = team;
    a.blocks = blocks;
    a.evm_div = evm_div;
    a.abs_div = abs_div;
    a.scratch = scratch;
    a.part = part;
    a.ticket = ticket;
    for (int i = 0; i < kMaxLevels; ++i) a.lv[i] = i < (1 << m) ? levels[i] : 0.0f;
    if (B <= 0) return static_cast<int>(cudaGetLastError());
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (m) {
    case 1: return static_cast<int>(launch_fused<1>(a, B, smem, stage_h, s));
    case 2: return static_cast<int>(launch_fused<2>(a, B, smem, stage_h, s));
    case 3: return static_cast<int>(launch_fused<3>(a, B, smem, stage_h, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
