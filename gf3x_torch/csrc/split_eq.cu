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
// Kernel B takes the wire-order slot table (the active data bins in the
// order their bits go on the wire, each an int2: its used-bin index and
// its order m in x, in y the offset of its first bit within a symbol's R
// wire bits, the running sum of 2m) and writes the twin's layout: scrambled,
// wire-order LLRs (B, D·R), plus per-(frame, symbol) partial sums of the
// EVM distances and of |llr|. One launch covers every loading group; a
// uniform config is one group with gain 1. The TPU kernel's bin chunking,
// per-group launches and plane-major sign rows are layouts of the TPU and
// are not carried over.
//
// What bounds them on the card: bytes. A reads U bins and writes U bins per
// data symbol; B reads them back and writes R LLRs (102.7 MB at the
// bit-loaded shape, 31 µs at 3.35 TB/s). The intermediate eq is B·D·U·8
// bytes (45.9 MB at B = 1024 and GF3 geometry), written once and read
// once: that round trip is the split's price against the fused kernel.
//
// Kernel A has kernel 2's layout (fused_eq.cu): a block takes one frame and
// stages Ĥ, |Ĥ|² and the pilot positions in shared memory once; each of its W warps walks data
// symbols w, w + W, ..., copying the next one's bins into its second
// buffer with cp.async while it runs the current one through
// gf3x_track_symbol_warp, then derotates every used bin and stores the eq
// row as coalesced 8-byte stores. W and the shared memory come from the
// wrapper (fused_eq_geometry with demap=False).
//
// Kernel B's first design (a block per (frame, symbol), a thread per data
// bin reading three table entries, a switch over orders that diverged in
// every warp of a random loading, scalar stores scattered over the row's
// three group regions, a block barrier to sum) ran at a third of its
// bound. Now it has the same layout as A: a block per frame stages the
// slot table and each slot's 1/max(|Ĥ|², 1e-12) once; each warp copies
// its next eq row (cp.async, 16-byte chunks where aligned) while lane l
// demaps slots l, l + 32, ... of the current one, which are group-sorted,
// so a warp runs one order except at a group boundary. The LLRs go to the
// warp's row in shared memory and leave as coalesced 16-byte stores (8-byte
// where R % 4 ≠ 0); the sums are warp sums with no block barrier. The
// demap arithmetic is the first design's, so the LLRs are bit for bit the
// same. W and the shared memory come from the wrapper (demap_geometry).
//
// Where a band's staged layout fits no warp count (gf3-16384: U = 7616, a
// 64-QAM row of R = 34 272 LLRs), kernel B takes the streamed layout (nbuf
// = 0): it reads its slots, Ĥ and the eq bins from global memory and
// writes each slot's 2m LLRs straight to its offset in the output row;
// shared memory holds only the PAM levels. Warps, lanes and each lane's
// order are the staged layout's, so the outputs are the same bits. Kernel A
// has kernel 2's other layouts (fused_eq.cu): teamed (eq_track_team_kernel),
// a team of warps takes a symbol (gf3x_fit_symbol_team) on a grid of (B,
// blocks), and its threads derotate and store the eq row kUnroll bins a
// lane at a time; spilled, the teamed kernel with each team's pilot scratch
// in global memory. Every layout gives the same bits.
#include <cstdint>

#include "eq_demap.cuh"

namespace {

struct TrackOut {
    TrackArgs t;
    float2* eq;          // (B, D, U) derotated equalized bins
    float* slope;        // (B, D)
    float* cpe;          // (B, D)
    float* nv_sym;       // (B, D)
    int warps;           // W warps a block
    int nbuf;            // symbol buffers per warp: 2 when W < D, else 1;
                         // 0 for the teamed layout
    int team;            // T warps a data symbol (teamed, spilled)
    int blocks;          // blocks a frame (teamed, spilled)
    float* scratch;      // the spilled layout's pilot scratch, else null
};

constexpr int kUnroll = 4;   // bins a lane loads before it stores them

// The staged layout. Dynamic shared memory, in floats (the wrapper's
// fused_eq_geometry with demap=False computes the same): Ĥ (2U) | W·nbuf
// symbol buffers (2U each) | |Ĥ|² (U) | W pilot scratches (4P each) | the
// pilot positions (P ints). Below two pilots the bins are not derotated.
__global__ void __launch_bounds__(1024, 1)
eq_track_kernel(const __grid_constant__ TrackOut a) {
    extern __shared__ __align__(16) float sm[];
    const TrackArgs& t = a.t;
    const int U = t.U, P = t.P, D = t.D, W = a.warps;
    const int b = blockIdx.x;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const size_t rows = 3 * U + 2 * U * W * a.nbuf;
    float2* hs = reinterpret_cast<float2*>(sm);
    float2* buf = hs + U + static_cast<size_t>(w) * a.nbuf * U;
    float* h2s = sm + 2 * U + 2 * U * W * a.nbuf;
    float* zr = sm + rows + 4 * P * w;
    float* zi = zr + P;
    float* dr = zi + P;
    float* di = dr + P;
    int* s_pos = reinterpret_cast<int*>(sm + rows + 4 * P * W);
    const int* kp = s_pos;
    const float2* hrow = t.h + static_cast<long long>(b) * U;

    // the warp's first symbol is in flight while the block stages Ĥ
    gf3x_fetch_symbol(t, b, w, buf, lane);
    for (int k = threadIdx.x; k < U; k += blockDim.x) {
        const float2 h = hrow[k];
        hs[k] = h;
        h2s[k] = gf3x_abs2(h);
    }
    gf3x_stage_layout(t, s_pos, P);
    __syncthreads();
    const bool derotate = P >= 2;

    for (int d = w, i = 0; d < D; d += W, ++i) {
        const long long o = static_cast<long long>(b) * D + d;
        float2* row = a.eq + o * U;
        float2* cur = buf + (i & (a.nbuf - 1)) * U;
        gf3x_fetch_symbol(t, b, d + W, buf + ((i + 1) & (a.nbuf - 1)) * U,
                          lane);
        gf3x_cp_async_wait_all_but_newest();
        __syncwarp();
        const SymbolFit f = gf3x_track_symbol_warp(t, b, cur, hs, h2s, kp, zr,
                                                   zi, dr, di, lane);
        for (int k = lane; k < U; k += 32)
            row[k] = derotate ? gf3x_derotate(cur[k], f.slope, k, f.cpe)
                              : cur[k];
        if (lane == 0) {
            a.slope[o] = f.slope;
            a.cpe[o] = f.cpe;
            a.nv_sym[o] = f.nv_sym;
        }
        __syncwarp();   // cur and the scratch are rewritten next
    }
}

// Kernel A's teamed layout (kSpilled: its pilot scratch in a.scratch),
// grid (B, blocks), G = W / T teams a block. Dynamic shared memory, in
// floats (fused_eq_geometry with demap=False computes the same): kStageH:
// Ĥ (2U) | |Ĥ|² (U); then, unless kSpilled, the G teams' pilot scratch (4P
// each) | the G teams' three shared values (4 each) | unless kSpilled, the
// P pilot positions (ints).
template <bool kStageH, bool kSpilled>
__global__ void __launch_bounds__(1024, 1)
eq_track_team_kernel(const __grid_constant__ TrackOut a) {
    extern __shared__ __align__(16) float sm[];
    const TrackArgs& t = a.t;
    const int U = t.U, P = t.P, D = t.D;
    const int b = blockIdx.x, blk = blockIdx.y;
    const Team tm(a.team);
    const int G = a.warps / a.team;
    float2* hs = reinterpret_cast<float2*>(sm);
    float* h2s = sm + 2 * U;
    float* scr = sm + (kStageH ? 3 * U : 0);
    float* bc = scr + (kSpilled ? 0 : 4 * P * G);
    int* s_pos = reinterpret_cast<int*>(bc + 4 * G);
    float* zr = kSpilled ? gf3x_spilled_scratch(a.scratch, b, a.blocks, blk,
                                                G, tm.g, P)
                         : scr + 4 * P * tm.g;
    float* zi = zr + P;
    float* dr = zi + P;
    float* di = dr + P;
    const float2* hrow = t.h + static_cast<long long>(b) * U;

    if constexpr (kStageH) {
        for (int k = threadIdx.x; k < U; k += blockDim.x) {
            const float2 h = hrow[k];
            hs[k] = h;
            h2s[k] = gf3x_abs2(h);
        }
    }
    if constexpr (!kSpilled) gf3x_stage_layout(t, s_pos, P);
    __syncthreads();
    const int* kp = kSpilled ? t.pos : s_pos;
    const bool derotate = P >= 2;

    const TeamSymbols run(D, a.blocks, blk);
    for (int d = run.lo + tm.g; d < run.hi; d += G) {
        const float2* yrow = t.y + (static_cast<long long>(b) * t.S + t.K + d) * U;
        const TeamBins<kStageH> bins{yrow, kStageH ? hs : hrow, h2s, nullptr};
        const SymbolFit f = gf3x_fit_symbol_team(t, b, bins, kp, zr, zi, dr,
                                                 di, bc + 4 * tm.g, tm);
        const long long o = static_cast<long long>(b) * D + d;
        float2* row = a.eq + o * U;
        for (int k0 = tm.tt; k0 < U; k0 += kUnroll * tm.n) {
            float2 y[kUnroll], h[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int k = min(k0 + u * tm.n, U - 1);
                y[u] = __ldg(yrow + k);
                h[u] = bins.hk(k);
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int k = k0 + u * tm.n;
                if (k >= U) break;
                const float h2 = kStageH ? h2s[k] : gf3x_abs2(h[u]);
                const float2 x = gf3x_eq_bin(y[u], h[u], h2);
                row[k] = derotate ? gf3x_derotate(x, f.slope, k, f.cpe) : x;
            }
        }
        if (tm.tt == 0) {
            a.slope[o] = f.slope;
            a.cpe[o] = f.cpe;
            a.nv_sym[o] = f.nv_sym;
        }
    }
}

template <typename Kernel>
cudaError_t launch_track_kernel(Kernel kernel,
                                size_t (&smem_set)[kMaxDevices],
                                const TrackOut& a, long long B, int smem,
                                cudaStream_t stream) {
    const cudaError_t e = gf3x_allow_smem(kernel, smem, smem_set);
    if (e != cudaSuccess) return e;
    if (B > 0) {
        kernel<<<dim3(static_cast<unsigned>(B),
                      static_cast<unsigned>(a.blocks)),
                 32 * a.warps, smem, stream>>>(a);
    }
    return cudaGetLastError();
}

cudaError_t launch_track(const TrackOut& a, long long B, int smem,
                         cudaStream_t stream) {
    static size_t smem_set[kMaxDevices] = {};
    return launch_track_kernel(eq_track_kernel, smem_set, a, B, smem, stream);
}

template <bool kStageH, bool kSpilled>
cudaError_t launch_track_team(const TrackOut& a, long long B, int smem,
                              cudaStream_t stream) {
    static size_t smem_set[kMaxDevices] = {};
    return launch_track_kernel(eq_track_team_kernel<kStageH, kSpilled>,
                               smem_set, a, B, smem, stream);
}

constexpr int kLevels = 2 + 4 + 8;   // PAM levels of QPSK, 16- and 64-QAM

// A slot: x = used-bin index << 2 | order m, y = the wire offset of its
// first LLR within the symbol's R.
__device__ __forceinline__ int slot_bin(int2 sl) { return sl.x >> 2; }
__device__ __forceinline__ int slot_order(int2 sl) { return sl.x & 3; }

struct DemapArgs {
    const float2* eq;    // (B, D, U) derotated equalized bins
    const float2* h;     // (B, U) channel estimate
    const float* nv_sym; // (B, D) per-symbol noise floor
    const int2* slots;   // (NS,) the active bins in wire order
    float* llr;          // (B, D·R)
    float* evm_part;     // (B, D) Σ over active bins of the min distances
    float* abs_part;     // (B, D) Σ |llr|
    int D, U, NS, R;
    float inv_gain, inv_gain2;   // 1/g and 1/g² of the loading boost
    int warps;           // W: warp w takes data symbols w, w + W, ...
    int nbuf;            // eq rows per warp: 2 when W < D, else 1; 0 for
                         // the streamed layout
    float lv[kLevels];   // levels of order m at lv[2^m − 2 ...]
};

__device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// Data symbol d's eq row of frame b into buf by one warp (16-byte copies
// where the row is 16-byte aligned, else 8-byte ones), as one cp.async
// group; an empty group when d ≥ D.
__device__ __forceinline__ void fetch_eq_row(const DemapArgs& a, int b, int d,
                                             float2* buf, int lane) {
    if (d < a.D) {
        const float2* src = a.eq + (static_cast<long long>(b) * a.D + d) * a.U;
        if (((reinterpret_cast<uintptr_t>(src) & 15) == 0) && !(a.U & 1)) {
            for (int c = lane; c < a.U / 2; c += 32)
                gf3x_cp_async16(buf + 2 * c, src + 2 * c);
        } else {
            for (int k = lane; k < a.U; k += 32)
                gf3x_cp_async8(buf + k, src + k);
        }
    }
    gf3x_cp_async_commit();
}

// One slot's 2m LLRs at nv_eff = nvs · inv into out (loading: demap e/g
// with noise nv/g², g = 1 when uniform).
__device__ __forceinline__ void demap_slot(const DemapArgs& a, int m,
                                           float2 e, float nvs, float inv,
                                           const float* lv, float* out,
                                           float& md_sum, float& abs_sum) {
    const float nv_eff = nvs * inv;
    const float nvc = fmaxf(nv_eff * a.inv_gain2, 1e-12f);
    gf3x_demap_bin(m, e.x * a.inv_gain, e.y * a.inv_gain, lv + (1 << m) - 2,
                   nvc, out, md_sum, abs_sum);
}

// Dynamic shared memory, in floats (the wrapper's demap_smem_bytes computes
// the same). Staged: per warp, nbuf eq rows (2U, rounded up to 4) and an
// LLR row (R, rounded up to 4) | the slot table (NS int2) |
// 1/max(|Ĥ|², 1e-12) per slot (NS) | the PAM levels (16). Streamed
// (nbuf = 0): the PAM levels alone; each lane reads its slots, their Ĥ and
// eq bins from global memory and writes each slot's LLRs at its offset in
// the output row.
template <bool kStreamed>
__global__ void __launch_bounds__(1024)
demap_bins_kernel(const __grid_constant__ DemapArgs a) {
    extern __shared__ __align__(16) float sm[];
    const int U = a.U, D = a.D, NS = a.NS, R = a.R, W = a.warps;
    const int b = blockIdx.x;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int per_warp = a.nbuf * round4(2 * U) + round4(R);
    float* mine = sm + static_cast<size_t>(w) * per_warp;
    float* row = mine + a.nbuf * round4(2 * U);
    int2* s_slot = reinterpret_cast<int2*>(sm + static_cast<size_t>(W) * per_warp);
    float* s_inv = reinterpret_cast<float*>(s_slot + NS);
    float* s_lv = kStreamed ? sm : s_inv + NS;
    const float2* hrow = a.h + static_cast<long long>(b) * U;

    if constexpr (!kStreamed) {
        // the warp's first row is in flight while the block stages the slots
        fetch_eq_row(a, b, w, reinterpret_cast<float2*>(mine), lane);
        for (int i = threadIdx.x; i < NS; i += blockDim.x) {
            const int2 sl = a.slots[i];
            s_slot[i] = sl;
            s_inv[i] = gf3x_inv_csi(gf3x_abs2(hrow[slot_bin(sl)]));
        }
    }
    if (threadIdx.x < kLevels) s_lv[threadIdx.x] = a.lv[threadIdx.x];
    __syncthreads();

    const bool vec4 = !(R & 3);
    for (int d = w, i = 0; d < D; d += W, ++i) {
        const long long o = static_cast<long long>(b) * D + d;
        const float nvs = a.nv_sym[o];
        float* dst = a.llr + o * R;
        float md_sum = 0.0f, abs_sum = 0.0f;
        if constexpr (kStreamed) {
            const float2* erow = a.eq + o * U;
            for (int j = lane; j < NS; j += 32) {
                const int2 sl = a.slots[j];
                const int k = slot_bin(sl);
                demap_slot(a, slot_order(sl), erow[k], nvs,
                           gf3x_inv_csi(gf3x_abs2(hrow[k])), s_lv, dst + sl.y,
                           md_sum, abs_sum);
            }
        } else {
            const float2* cur =
                reinterpret_cast<const float2*>(mine + (i & (a.nbuf - 1)) *
                                                           round4(2 * U));
            fetch_eq_row(a, b, d + W,
                         reinterpret_cast<float2*>(
                             mine + ((i + 1) & (a.nbuf - 1)) * round4(2 * U)),
                         lane);
            gf3x_cp_async_wait_all_but_newest();
            __syncwarp();
            for (int j = lane; j < NS; j += 32) {
                const int2 sl = s_slot[j];
                demap_slot(a, slot_order(sl), cur[slot_bin(sl)], nvs, s_inv[j],
                           s_lv, row + sl.y, md_sum, abs_sum);
            }
            __syncwarp();
            if (vec4 && !(reinterpret_cast<uintptr_t>(dst) & 15)) {
                for (int c = lane; c < R / 4; c += 32)
                    reinterpret_cast<float4*>(dst)[c] =
                        reinterpret_cast<const float4*>(row)[c];
            } else {
                for (int c = lane; c < R / 2; c += 32)
                    reinterpret_cast<float2*>(dst)[c] =
                        reinterpret_cast<const float2*>(row)[c];
            }
        }
        md_sum = gf3x_warp_sum(md_sum);
        abs_sum = gf3x_warp_sum(abs_sum);
        if (lane == 0) {
            a.evm_part[o] = md_sum;
            a.abs_part[o] = abs_sum;
        }
        __syncwarp();   // cur and the row are rewritten next
    }
}

template <bool kStreamed>
cudaError_t launch_demap(const DemapArgs& a, long long B, int smem,
                         cudaStream_t stream) {
    static size_t smem_set[kMaxDevices] = {};
    const cudaError_t e =
        gf3x_allow_smem(demap_bins_kernel<kStreamed>, smem, smem_set);
    if (e != cudaSuccess) return e;
    if (B > 0) {
        demap_bins_kernel<kStreamed>
            <<<static_cast<unsigned>(B), 32 * a.warps, smem, stream>>>(a);
    }
    return cudaGetLastError();
}

}  // namespace

GF3X_EXPORT int gf3x_eq_track(
        const float* y, const float* h, const float* nv, const float* pv,
        const int* pos, float* eq, float* slope, float* cpe, float* nv_sym,
        long long B, int S, int K, int U, int P, int n_ladder, int q0,
        float base0, int q1, float base1, float mean_dk, int warps, int nbuf,
        int smem, float* scratch, int team, int blocks, int stage_h,
        void* stream) {
    TrackOut a;
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
    a.eq = reinterpret_cast<float2*>(eq);
    a.slope = slope;
    a.cpe = cpe;
    a.nv_sym = nv_sym;
    a.warps = warps;
    a.nbuf = nbuf;
    a.team = team;
    a.blocks = blocks;
    a.scratch = scratch;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    // the layout, as kernel 2's (fused_eq.cu, launch_fused)
    if (scratch != nullptr)
        return static_cast<int>(launch_track_team<false, true>(a, B, smem, st));
    if (team > 1 || blocks > 1) {
        return static_cast<int>(
            stage_h ? launch_track_team<true, false>(a, B, smem, st)
                    : launch_track_team<false, false>(a, B, smem, st));
    }
    if (nbuf == 0) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_track(a, B, smem, st));
}

GF3X_EXPORT int gf3x_demap_bins(
        const float* eq, const float* h, const float* nv_sym, const int* slots,
        float* llr, float* evm_part, float* abs_part, long long B, int D,
        int U, int NS, int R, float inv_gain, float inv_gain2,
        const float* levels, int warps, int nbuf, int smem, void* stream) {
    DemapArgs a;
    a.eq = reinterpret_cast<const float2*>(eq);
    a.h = reinterpret_cast<const float2*>(h);
    a.nv_sym = nv_sym;
    a.slots = reinterpret_cast<const int2*>(slots);
    a.llr = llr;
    a.evm_part = evm_part;
    a.abs_part = abs_part;
    a.D = D;
    a.U = U;
    a.NS = NS;
    a.R = R;
    a.inv_gain = inv_gain;
    a.inv_gain2 = inv_gain2;
    a.warps = warps;
    a.nbuf = nbuf;
    for (int i = 0; i < kLevels; ++i) a.lv[i] = levels[i];
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    return static_cast<int>(nbuf == 0 ? launch_demap<true>(a, B, smem, st)
                                      : launch_demap<false>(a, B, smem, st));
}
