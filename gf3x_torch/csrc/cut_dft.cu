// Fused frame cut + used-band DFT + deroll ramp.
//
// Replaces gf3x/ops/pallas/cut_dft.py:cut_dft_tpu. For row b, symbol s and
// used bin k ∈ [bin_lo, bin_lo + n_used):
//
//   Y[b,s,k] = inv_scale · Σ_n x[n]·e^{−2πi·k·n/N} · e^{+2πi·k·roll_b/N}
//
// with x[n] = rx[b, q_b·block + body_off + s·sym_len + cp + n], samples at
// or past `valid` reading as zero (kernel 1's `gather_cut` semantics). The
// segment after the S symbols (present when sc_off >= 0) copies the
// Schmidl–Cox window at q_b·block + sc_off, as kernel 1 does; with
// sc_off < 0 nothing is written there.
//
// The TPU kernel runs the DFT as bf16x3 MXU dots against resident tables
// and writes a group-major layout; both are TPU artefacts. Here the N real
// samples are packed as M = N/2 complex points z[m] = x[2m] + i·x[2m+1],
// transformed by a Stockham FFT, and each used bin is unpacked from Z[k]
// and Z[M − k], derolled and scaled, in float32. Every twiddle is read from
// one N-entry cos/sin table of 2πj/N (built in float64 on the host, so
// exactly rounded) at an index computed in integer arithmetic: k·r·N/(Ns·R)
// in a pass, k for the unpacking, (k·roll) mod N for the deroll; the
// constants inside a radix-8 butterfly (±1, ±i, (±1 ± i)/√2) are exactly
// rounded floats. Y lands as (B, S, n_used) complex64.
//
// What bounds it on the card: bytes. Per step at config 5 it reads
// 100.7 MB of symbol windows (+ 4.2 MB of SC windows) and writes 55.1 MB
// of spectra (+ 4.2 MB): 49 µs at 3.35 TB/s; the FFT is 0.67 GFLOP. The
// first design (a block per symbol, nine radix-2 stages in shared memory
// with a block barrier each, scalar loads tested against `valid` one by
// one) needed about 80 M warp-instructions by a count of its code, and
// ran at 23 % of that bound. This one cuts instructions and barriers per
// point:
//
// - A team of threads (8 to 32 lanes of one warp, or a pair of warps)
//   transforms one segment; each thread holds `P` points in registers and
//   runs radix-8 butterflies on them (a final radix-2 or radix-4 pass where
//   M is not a power of 8): 3 passes at N = 1024 instead of 9. Points move
//   between passes through the team's own shared buffer (one pad slot per
//   8 keeps the Stockham strides off a single bank), synchronised by
//   __syncwarp or, for a pair, a named barrier: no block barrier between
//   passes.
// - A block takes one row (q and roll loaded once); its teams walk the
//   row's segments, each copying its next window into its second buffer
//   with cp.async while it transforms the current one. A window's start is
//   16-byte aligned on only some rows (T is odd at config 5), so the copy
//   takes the aligned 16-byte chunks that cover the window and the first
//   pass starts at the window's offset in the first chunk; `valid` is
//   tested once per window, and per sample only in a window that crosses
//   it.
// - Each team stores its symbol's n_used spectra as one contiguous run of
//   coalesced 8-byte stores; the SC window is stored as 16-byte stores.
//
// The launch (points per thread, team size, passes, teams per block,
// shared memory) comes from the wrapper's cut_dft_geometry.
#include <cstdint>

#include "common.cuh"

namespace {

struct CutDftArgs {
    const float* rx;     // (B, T) recordings
    const int* q;        // (B,) window block of each row
    const int* roll;     // (B,) deroll of each row
    const float* tw;     // (2, N) cos, sin of 2πj/N
    float2* Y;           // (B, S, n_used) spectra
    float* scw;          // (B, N) SC windows
    long long T, valid;
    int block, S, n_fft, body_off, sym_len, cp, sc_off, bin_lo, n_used;
    float inv_scale;
    int team;            // threads per segment: 8, 16, 32 or 64
    int n8;              // radix-8 passes
    int tail;            // radix of the last pass (2 or 4), or 1
    int teams;           // teams per block
    int nbuf;            // window buffers per team: 2 when a team takes
                         // more than one segment, else 1
};

// shared-memory slot of complex point i: one pad slot after every 8
__device__ __forceinline__ int slot(int i) { return i + (i >> 3); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
    return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
    return make_float2(a.x - b.x, a.y - b.y);
}

// −i·a
__device__ __forceinline__ float2 mul_mi(float2 a) {
    return make_float2(a.y, -a.x);
}

// In-place DFT of 4 points, natural order: X[k] = Σ a[n]·e^{−2πi·nk/4}.
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3) {
    const float2 t0 = cadd(a0, a2), t1 = csub(a0, a2);
    const float2 t2 = cadd(a1, a3), t3 = mul_mi(csub(a1, a3));
    a0 = cadd(t0, t2);
    a2 = csub(t0, t2);
    a1 = cadd(t1, t3);
    a3 = csub(t1, t3);
}

// In-place DFT of 8 points, natural order: two DFT-4s of the even and odd
// points, the odd ones turned by e^{−2πi·k/8} ∈ {1, (1 − i)/√2, −i,
// (−1 − i)/√2}.
__device__ __forceinline__ void dft8(float2& a0, float2& a1, float2& a2,
                                     float2& a3, float2& a4, float2& a5,
                                     float2& a6, float2& a7) {
    constexpr float kR = 0.70710678118654752f;   // √½, exactly rounded
    dft4(a0, a2, a4, a6);
    dft4(a1, a3, a5, a7);
    const float2 o1 = make_float2(kR * (a3.x + a3.y), kR * (a3.y - a3.x));
    const float2 o2 = mul_mi(a5);
    const float2 o3 = make_float2(kR * (a7.y - a7.x), -kR * (a7.x + a7.y));
    const float2 e0 = a0, e1 = a2, e2 = a4, e3 = a6, o0 = a1;
    a0 = cadd(e0, o0);
    a4 = csub(e0, o0);
    a1 = cadd(e1, o1);
    a5 = csub(e1, o1);
    a2 = cadd(e2, o2);
    a6 = csub(e2, o2);
    a3 = cadd(e3, o3);
    a7 = csub(e3, o3);
}

template <int R>
__device__ __forceinline__ void dft(float2* v) {
    if constexpr (R == 8) {
        dft8(v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7]);
    } else if constexpr (R == 4) {
        dft4(v[0], v[1], v[2], v[3]);
    } else {
        const float2 a = v[0];
        v[0] = cadd(a, v[1]);
        v[1] = csub(a, v[1]);
    }
}

// A team: 8 to 32 lanes of one warp, synchronised by __syncwarp, or (kPair)
// a pair of warps, by named barrier 1 + its index in the block; only the
// pairs' kernels use named barriers.
template <bool kPair>
struct Team {
    int tl;              // thread within the team
    int size;
    int bar;             // named barrier of a pair of warps
    unsigned mask;       // the team's lanes in its warp (teams ≤ 32)

    __device__ __forceinline__ void sync() const {
        if constexpr (kPair) {
            asm volatile("bar.sync %0, 64;\n" :: "r"(bar) : "memory");
        } else {
            __syncwarp(mask);
        }
    }
};

// A Stockham pass of radix R over the M points: butterfly j (j < M/R)
// takes the points j + r·M/R from v (loaded by pass_read), turns them by
// e^{−2πi·(j mod Ns)·r/(Ns·R)}, transforms them and writes them to points
// (j − j mod Ns)·R + j mod Ns + r·Ns of ex. Thread tl runs butterflies
// tl + b·team, b < P/R.
template <int R, int P, class T>
__device__ __forceinline__ void pass_write(float2 (&v)[P], float2* ex, int N,
                                           int Ns, const T& tm,
                                           const float* cs,
                                           const float* sn) {
    const int stride = N / (Ns * R);
#pragma unroll
    for (int b = 0; b < P / R; ++b) {
        const int j = tm.tl + b * tm.size;
        const int k = j & (Ns - 1);
        if (Ns > 1) {
#pragma unroll
            for (int r = 1; r < R; ++r) {
                const int idx = k * r * stride;
                const float c = cs[idx], s = sn[idx];
                const float2 x = v[b * R + r];
                v[b * R + r] = make_float2(x.x * c + x.y * s,
                                           x.y * c - x.x * s);
            }
        }
        dft<R>(v + b * R);
        const int d = (j - k) * R + k;
#pragma unroll
        for (int r = 0; r < R; ++r) ex[slot(d + r * Ns)] = v[b * R + r];
    }
}

template <int R, int P, class T>
__device__ __forceinline__ void pass_read(float2 (&v)[P], const float2* ex,
                                          int M, const T& tm) {
#pragma unroll
    for (int b = 0; b < P / R; ++b) {
        const int j = tm.tl + b * tm.size;
#pragma unroll
        for (int r = 0; r < R; ++r) v[b * R + r] = ex[slot(j + r * (M / R))];
    }
}

// Row `row`'s samples [base, base + N) into buf as the aligned 16-byte
// chunks that cover them (one cp.async group of the team's share, committed
// even when empty); returns the window's first sample's offset in buf.
// A window that crosses `valid` is loaded sample by sample instead, zero at
// or past it.
template <class T>
__device__ __forceinline__ int fetch_window(const CutDftArgs& a, long long row,
                                            long long base, float* buf,
                                            const T& tm) {
    const float* src = a.rx + row * a.T + base;
    const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
    const float* src0 = reinterpret_cast<const float*>(addr & ~uintptr_t(15));
    const int off = static_cast<int>((addr & 15) >> 2);
    const int nch = (off + a.n_fft + 3) >> 2;
    if (base + a.n_fft <= a.valid) {
        for (int c = tm.tl; c < nch; c += tm.size)
            gf3x_cp_async16(buf + 4 * c, src0 + 4 * c);
    } else {
        for (int e = tm.tl; e < 4 * nch; e += tm.size) {
            const long long t = base - off + e;
            buf[e] = (t >= base && t < a.valid) ? src0[e] : 0.0f;
        }
    }
    gf3x_cp_async_commit();
    return off;
}

// Dynamic shared memory, in floats (the wrapper's cut_dft_geometry computes
// the same): cos (N) | sin (N) | per team, nbuf window buffers of
// 2·(M + M/8) floats each.
template <int P, bool kPair>
__global__ void __launch_bounds__(512)
cut_dft_kernel(const __grid_constant__ CutDftArgs a) {
    extern __shared__ __align__(16) float sm[];
    const int N = a.n_fft, M = N >> 1;
    float* cs = sm;
    float* sn = sm + N;
    Team<kPair> tm;
    tm.size = a.team;
    const int w = threadIdx.x / a.team;
    tm.tl = threadIdx.x - w * a.team;
    tm.bar = 1 + w;
    tm.mask = a.team >= 32 ? 0xffffffffu
                           : ((1u << a.team) - 1u)
                                 << ((threadIdx.x & 31) & ~(a.team - 1));
    const int buf_floats = 2 * (M + M / 8);
    float* bufs = sm + 2 * N + static_cast<size_t>(w) * a.nbuf * buf_floats;
    const long long row = blockIdx.x;
    const int nseg = a.S + (a.sc_off >= 0 ? 1 : 0);
    const long long w0 = static_cast<long long>(a.q[row]) * a.block;
    const int roll = a.roll[row];
    auto seg_base = [&](int s) -> long long {
        return s == a.S ? w0 + a.sc_off
                        : w0 + a.body_off + static_cast<long long>(s) *
                              a.sym_len + a.cp;
    };

    // the team's first window is in flight while the block stages the
    // twiddles
    int off = 0;
    if (w < nseg) off = fetch_window(a, row, seg_base(w), bufs, tm);
    else gf3x_cp_async_commit();
    for (int k = threadIdx.x; k < N; k += blockDim.x) {
        cs[k] = a.tw[k];
        sn[k] = a.tw[N + k];
    }
    __syncthreads();

    for (int s = w, i = 0; s < nseg; s += a.teams, ++i) {
        float* cur = bufs + (i & (a.nbuf - 1)) * buf_floats;
        int off_next = 0;
        if (s + a.teams < nseg) {
            off_next = fetch_window(a, row, seg_base(s + a.teams),
                                    bufs + ((i + 1) & (a.nbuf - 1)) *
                                               buf_floats, tm);
        } else {
            gf3x_cp_async_commit();
        }
        gf3x_cp_async_wait_all_but_newest();
        tm.sync();
        const float* x = cur + off;
        if (s == a.S) {   // the SC window: a copy, as kernel 1 makes it
            float4* dst = reinterpret_cast<float4*>(a.scw + row * N);
            for (int c = tm.tl; c < N / 4; c += tm.size)
                dst[c] = make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2],
                                     x[4 * c + 3]);
        } else {
            float2 v[P];
#pragma unroll
            for (int b = 0; b < P / 8; ++b) {
                const int j = tm.tl + b * tm.size;
#pragma unroll
                for (int r = 0; r < 8; ++r) {
                    const int m = j + r * (M / 8);
                    v[b * 8 + r] = make_float2(x[2 * m], x[2 * m + 1]);
                }
            }
            tm.sync();    // the window is overwritten by the exchange
            float2* ex = reinterpret_cast<float2*>(cur);
            int Ns = 1;
            for (int p = 0; p < a.n8; ++p) {
                pass_write<8, P>(v, ex, N, Ns, tm, cs, sn);
                tm.sync();
                Ns *= 8;
                if (p + 1 < a.n8) {
                    pass_read<8, P>(v, ex, M, tm);
                    tm.sync();
                }
            }
            if (a.tail == 4) {
                pass_read<4, P>(v, ex, M, tm);
                tm.sync();
                pass_write<4, P>(v, ex, N, Ns, tm, cs, sn);
                tm.sync();
            } else if (a.tail == 2) {
                pass_read<2, P>(v, ex, M, tm);
                tm.sync();
                pass_write<2, P>(v, ex, N, Ns, tm, cs, sn);
                tm.sync();
            }
            float2* out = a.Y + (row * a.S + s) * a.n_used;
            for (int u = tm.tl; u < a.n_used; u += tm.size) {
                const int k = a.bin_lo + u;
                const float2 za = ex[slot(k & (M - 1))];
                const float2 zb = ex[slot((M - k) & (M - 1))];
                // even part E = (Z[k] + conj Z[M−k])/2, odd part O = (Z[k] −
                // conj Z[M−k])/(2i), X[k] = E + e^{−2πik/N}·O
                const float er = 0.5f * (za.x + zb.x);
                const float ei = 0.5f * (za.y - zb.y);
                const float o_r = 0.5f * (za.y + zb.y);
                const float o_i = -0.5f * (za.x - zb.x);
                const float c = cs[k], sk = sn[k];
                const float xr = er + (c * o_r + sk * o_i);
                const float xi = ei + (c * o_i - sk * o_r);
                // deroll: X[k]·e^{+2πi·k·roll/N}
                const int ridx = (k * roll) & (N - 1);
                const float cr = cs[ridx], sr = sn[ridx];
                out[u] = make_float2((xr * cr - xi * sr) * a.inv_scale,
                                     (xr * sr + xi * cr) * a.inv_scale);
            }
        }
        tm.sync();        // cur is refilled two segments on
        off = off_next;
    }
}

template <int P, bool kPair>
cudaError_t launch_cut_dft(const CutDftArgs& a, long long B, int smem,
                           cudaStream_t stream) {
    static size_t smem_set[kMaxDevices] = {};
    const cudaError_t e = gf3x_allow_smem(cut_dft_kernel<P, kPair>, smem,
                                          smem_set);
    if (e != cudaSuccess) return e;
    cut_dft_kernel<P, kPair><<<static_cast<unsigned>(B), a.team * a.teams,
                               smem, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace

GF3X_EXPORT int gf3x_cut_dft(const float* rx, const int* q, const int* roll,
                             const float* tw, float* Y, float* scw,
                             long long B, long long T, long long valid,
                             int block, int S, int n_fft, int body_off,
                             int sym_len, int cp, int sc_off, int bin_lo,
                             int n_used, float inv_scale, int points,
                             int team, int n8, int tail, int teams, int nbuf,
                             int smem, void* stream) {
    CutDftArgs a;
    a.rx = rx;
    a.q = q;
    a.roll = roll;
    a.tw = tw;
    a.Y = reinterpret_cast<float2*>(Y);
    a.scw = scw;
    a.T = T;
    a.valid = valid;
    a.block = block;
    a.S = S;
    a.n_fft = n_fft;
    a.body_off = body_off;
    a.sym_len = sym_len;
    a.cp = cp;
    a.sc_off = sc_off;
    a.bin_lo = bin_lo;
    a.n_used = n_used;
    a.inv_scale = inv_scale;
    a.team = team;
    a.n8 = n8;
    a.tail = tail;
    a.teams = teams;
    a.nbuf = nbuf;
    if (team * points != n_fft / 2 || team * teams > 512 || n8 < 1 ||
        (team > 32 && (team != 64 || teams > 15)))
        return static_cast<int>(cudaErrorInvalidValue);
    if (B <= 0) return static_cast<int>(cudaGetLastError());
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool pair = team > 32;
    cudaError_t e = cudaErrorInvalidValue;
    if (points == 8 && !pair) e = launch_cut_dft<8, false>(a, B, smem, s);
    if (points == 16 && !pair) e = launch_cut_dft<16, false>(a, B, smem, s);
    if (points == 16 && pair) e = launch_cut_dft<16, true>(a, B, smem, s);
    if (points == 32 && pair) e = launch_cut_dft<32, true>(a, B, smem, s);
    return static_cast<int>(e);
}
