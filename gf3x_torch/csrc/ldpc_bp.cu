// Layered normalised min-sum decoding of the QC-LDPC family (24 block
// columns, rates 1/2 to 5/6), one codeword per block.
//
// Replaces gf3x/ops/pallas/ldpc_bp.py:minsum_totals_tpu. It must be
// bit-identical to LdpcCode._minsum_xla (gf3x/fec/ldpc.py:301) and to the
// plain PyTorch version beside its wrapper: the same block-row order,
// argmin ties broken by the first edge, m2 over the other edges,
// new = (α·(prod·sgn))·mins with α = 0.8, delta = new − c2v, c2v += delta,
// and the freeze rule (a codeword whose hard decisions satisfy every check
// before a sweep stops updating; passes count the sweeps it ran). Every
// rounding is written out with __fmul_rn/__fadd_rn/__fsub_rn, and the
// library is built with --fmad=false, so no multiply-add is contracted.
//
// What bounds it on the card: the serial layer schedule. Each block row
// depends on the totals the previous row wrote, so a sweep is mb rounds of
// shared-memory traffic separated by __syncthreads(); device memory sees
// the LLRs once in and the totals once out. Design: one block per
// codeword, one thread per check of a block row (z threads); the c2v
// messages (E·z floats, 29 KB at rate 1/2, z = 96) and the column totals
// (24·z floats, 9.2 KB) stay in shared memory for all iterations. Within a
// block row each circulant column appears once, so thread c reads and
// writes total (c + s) mod z of each column it touches and no two threads
// of a row collide.
#include "common.cuh"

namespace {

constexpr int kBlockCols = 24;
constexpr float kAlpha = 0.8f;
constexpr float kBig = 1e30f;

struct Code {
    const int* row_ptr;   // (mb + 1,) first edge of each block row
    const int* col;       // (E,) block column of each edge
    const int* shift;     // (E,) circulant shift of each edge
    int mb, E, z;
};

__device__ __forceinline__ int wrap(int v, int z) { return v >= z ? v - z : v; }

// True for every thread of the block when any parity check of the current
// hard decisions is violated.
__device__ bool unsatisfied(const float* tot, const int* rp, const int* col,
                            const int* shf, int mb, int z) {
    const int c = threadIdx.x;
    int bad = 0;
    for (int i = 0; i < mb; ++i) {
        int par = 0;
        for (int e = rp[i]; e < rp[i + 1]; ++e)
            par ^= tot[col[e] * z + wrap(c + shf[e], z)] < 0.0f ? 1 : 0;
        bad |= par;
    }
    return __syncthreads_or(bad) != 0;
}

__global__ void minsum_kernel(const float* __restrict__ lam,
                              float* __restrict__ totals,
                              int* __restrict__ unsat_out,
                              int* __restrict__ passes_out, Code code,
                              int iters) {
    extern __shared__ float sm[];
    const int z = code.z, E = code.E, mb = code.mb;
    const int n = kBlockCols * z;
    float* c2v = sm;                          // (E, z)
    float* tot = c2v + E * z;                 // (24, z)
    int* rp = reinterpret_cast<int*>(tot + n);
    int* col = rp + mb + 1;
    int* shf = col + E;

    const int c = threadIdx.x;
    const long long cw = blockIdx.x;
    for (int i = c; i < n; i += blockDim.x) tot[i] = lam[cw * n + i];
    for (int i = c; i < E * z; i += blockDim.x) c2v[i] = 0.0f;
    for (int i = c; i <= mb; i += blockDim.x) rp[i] = code.row_ptr[i];
    for (int i = c; i < E; i += blockDim.x) {
        col[i] = code.col[i];
        shf[i] = code.shift[i];
    }
    __syncthreads();

    int passes = 0;
    bool bad = unsatisfied(tot, rp, col, shf, mb, z);
    while (bad && passes < iters) {
        for (int i = 0; i < mb; ++i) {
            const int e0 = rp[i], e1 = rp[i + 1];
            // pass 1: sign product, min, first argmin, min over the others
            float prod = 1.0f, m1 = 0.0f, m2 = kBig;
            int am = e0;
            for (int e = e0; e < e1; ++e) {
                const float v = __fsub_rn(tot[col[e] * z + wrap(c + shf[e], z)],
                                          c2v[e * z + c]);
                const float mag = fabsf(v);
                prod = __fmul_rn(prod, v < 0.0f ? -1.0f : 1.0f);
                if (e == e0) {
                    m1 = mag;
                } else if (mag < m1) {
                    m2 = m1;
                    m1 = mag;
                    am = e;
                } else {
                    m2 = fminf(m2, mag);
                }
            }
            // pass 2: new messages; the totals this thread read are its own
            for (int e = e0; e < e1; ++e) {
                const int t = col[e] * z + wrap(c + shf[e], z);
                const float old = c2v[e * z + c];
                const float v = __fsub_rn(tot[t], old);
                const float sgn = v < 0.0f ? -1.0f : 1.0f;
                const float mins = e == am ? m2 : m1;
                const float nw = __fmul_rn(__fmul_rn(kAlpha, __fmul_rn(prod, sgn)), mins);
                const float delta = __fsub_rn(nw, old);
                c2v[e * z + c] = __fadd_rn(old, delta);
                tot[t] = __fadd_rn(tot[t], delta);
            }
            __syncthreads();
        }
        ++passes;
        bad = unsatisfied(tot, rp, col, shf, mb, z);
    }
    for (int i = c; i < n; i += blockDim.x) totals[cw * n + i] = tot[i];
    if (c == 0) {
        unsat_out[cw] = bad ? 1 : 0;
        passes_out[cw] = passes;
    }
}

}  // namespace

GF3X_EXPORT int gf3x_minsum_totals(const float* lam, float* totals,
                                   int* unsat, int* passes,
                                   const int* row_ptr, const int* col,
                                   const int* shift, long long L, int mb,
                                   int E, int z, int iters, void* stream) {
    Code code{row_ptr, col, shift, mb, E, z};
    const size_t smem = (static_cast<size_t>(E) * z + kBlockCols * z) * sizeof(float) +
                        (mb + 1 + 2 * static_cast<size_t>(E)) * sizeof(int);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            minsum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (L > 0) {
        minsum_kernel<<<static_cast<unsigned>(L), z, smem,
                        static_cast<cudaStream_t>(stream)>>>(
            lam, totals, unsat, passes, code, iters);
    }
    return static_cast<int>(cudaGetLastError());
}
