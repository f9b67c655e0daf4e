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
// kernel.
//
// Kernel A has kernel 2's layout (fused_eq.cu): a block takes one frame and
// stages Ĥ and |Ĥ|² in shared memory once; each of its W warps walks data
// symbols w, w + W, ..., copying the next one's bins into its second
// buffer with cp.async while it runs the current one through
// gf3x_track_symbol_warp, then derotates every used bin and stores the eq
// row as coalesced 8-byte stores. W and the shared memory come from the
// wrapper (fused_eq_geometry with demap=False). Kernel B is one block per
// (frame, data symbol), one thread per data bin, with the PAM levels of
// the three orders staged from the kernel's parameter (constant) bank into
// shared memory.
#include "eq_demap.cuh"

namespace {

struct TrackOut {
    TrackArgs t;
    float2* eq;          // (B, D, U) derotated equalized bins
    float* slope;        // (B, D)
    float* cpe;          // (B, D)
    float* nv_sym;       // (B, D)
    int warps;           // W: warp w takes data symbols w, w + W, ...
    int nbuf;            // symbol buffers per warp: 2 when W < D, else 1
};

// Dynamic shared memory, in floats (the wrapper's fused_eq_geometry with
// demap=False computes the same): Ĥ (2U) | W·nbuf symbol buffers (2U
// each) | |Ĥ|² (U) | W pilot scratches (4P each).
__global__ void __launch_bounds__(1024)
eq_track_kernel(const __grid_constant__ TrackOut a) {
    extern __shared__ __align__(16) float sm[];
    const TrackArgs& t = a.t;
    const int U = t.U, P = t.P, D = t.D, W = a.warps;
    const int b = blockIdx.x;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    float2* hs = reinterpret_cast<float2*>(sm);
    float2* buf = hs + U + static_cast<size_t>(w) * a.nbuf * U;
    float* h2s = sm + 2 * U + 2 * U * W * a.nbuf;
    float* zr = h2s + U + 4 * P * w;
    float* zi = zr + P;
    float* dr = zi + P;
    float* di = dr + P;

    // the warp's first symbol is in flight while the block stages Ĥ
    gf3x_fetch_symbol(t, b, w, buf, lane);
    for (int k = threadIdx.x; k < U; k += blockDim.x) {
        const float2 h = t.h[static_cast<long long>(b) * U + k];
        hs[k] = h;
        h2s[k] = h.x * h.x + h.y * h.y;
    }
    __syncthreads();

    for (int d = w, i = 0; d < D; d += W, ++i) {
        float2* cur = buf + (i & (a.nbuf - 1)) * U;
        gf3x_fetch_symbol(t, b, d + W, buf + ((i + 1) & (a.nbuf - 1)) * U,
                          lane);
        gf3x_cp_async_wait_all_but_newest();
        __syncwarp();
        const SymbolFit f = gf3x_track_symbol_warp(t, b, cur, hs, h2s, zr, zi,
                                                   dr, di, lane);
        const long long o = static_cast<long long>(b) * D + d;
        float2* row = a.eq + o * U;
        for (int k = lane; k < U; k += 32)
            row[k] = gf3x_derotate(cur[k], f.slope, k, f.cpe);
        if (lane == 0) {
            a.slope[o] = f.slope;
            a.cpe[o] = f.cpe;
            a.nv_sym[o] = f.nv_sym;
        }
        __syncwarp();   // cur and the scratch are rewritten next
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
        float base0, int q1, float base1, float mean_dk, int warps, int nbuf,
        int smem, void* stream) {
    TrackOut a;
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
    a.eq = reinterpret_cast<float2*>(eq);
    a.slope = slope;
    a.cpe = cpe;
    a.nv_sym = nv_sym;
    a.warps = warps;
    a.nbuf = nbuf;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            eq_track_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    if (B > 0) {
        eq_track_kernel<<<static_cast<unsigned>(B), 32 * warps, smem,
                          static_cast<cudaStream_t>(stream)>>>(a);
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
