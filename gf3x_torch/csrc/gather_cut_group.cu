// Block-aligned per-row window cut over whole 8-row groups.
//
// Replaces gf3x/ops/pallas/gather_cut.py:gather_cut_group_tpu, the cut that
// gf3x's `cut_symbols` takes for a batch of whole 8-row groups when the
// fused cut refuses the geometry — an extraction offset that is not a
// multiple of 128, as the SC window of CP = N/4 at N = 2048 is
// (gf3x/ops/sync.py:329-335, 398). Row i of the output is
// rx[i, q[i]·block :][:L] with L = nb·block; samples at or past `valid` (the
// whole-block prefix floor(T/block)·block) read as zero, up to the 8-block
// slack the caller's clip of q allows (gf3x/ops/sync.py:274-351).
//
// The TPU kernel double-buffers one whole 8-row group at a time through
// VMEM and extracts each row at a 128-lane-aligned offset: Mosaic artefacts.
// Here a block reads its rows straight from device memory.
//
// What bounds it on the card: bytes, B·L·4 read and as many written. Design:
// one block per (8-row group, 4096-sample column chunk), eight warps, warp w
// copying row 8g + w; the group's eight q are read once into shared memory.
// Each lane moves four consecutive samples per step, so a warp reads and
// writes 512 contiguous bytes. Stores are 16-byte vectors whenever the
// output row length allows; loads are 16-byte vectors only where the row's
// window start is 16-byte aligned (rows of odd length T are not), else four
// scalar loads that still coalesce.
#include <cstdint>

#include "common.cuh"

namespace {
constexpr int kRows = 8;                     // rows per group = warps
constexpr int kThreads = kRows * 32;
constexpr int kChunk = 4096;                 // columns per block
}  // namespace

__global__ void gather_cut_group_kernel(const float* __restrict__ rx,
                                        const int* __restrict__ q,
                                        float* __restrict__ out,
                                        long long groups, long long T,
                                        long long valid, long long L,
                                        int block) {
    __shared__ long long base_s[kRows];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const long long c0 = static_cast<long long>(blockIdx.x) * kChunk;
    const long long c1 = c0 + kChunk < L ? c0 + kChunk : L;
    const bool vec_out = (L & 3) == 0 &&
                         (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    for (long long g = blockIdx.y; g < groups; g += gridDim.y) {
        if (threadIdx.x < kRows) {
            base_s[threadIdx.x] =
                static_cast<long long>(q[g * kRows + threadIdx.x]) * block;
        }
        __syncthreads();
        const long long row = g * kRows + warp;
        const long long base = base_s[warp];
        const float* src = rx + row * T;
        float* dst = out + row * L;
        const bool vec_in =
            vec_out && (reinterpret_cast<uintptr_t>(src + base) & 15) == 0;
        for (long long i = c0 + 4 * lane; i < c1; i += 4 * 32) {
            const long long t = base + i;
            if (vec_out && i + 3 < c1) {
                float4 v;
                if (vec_in && t >= 0 && t + 3 < valid) {
                    v = *reinterpret_cast<const float4*>(src + t);
                } else {
                    v.x = t >= 0 && t < valid ? src[t] : 0.0f;
                    v.y = t + 1 >= 0 && t + 1 < valid ? src[t + 1] : 0.0f;
                    v.z = t + 2 >= 0 && t + 2 < valid ? src[t + 2] : 0.0f;
                    v.w = t + 3 >= 0 && t + 3 < valid ? src[t + 3] : 0.0f;
                }
                *reinterpret_cast<float4*>(dst + i) = v;
            } else {
                for (int k = 0; k < 4 && i + k < c1; ++k) {
                    const long long tk = t + k;
                    dst[i + k] = tk >= 0 && tk < valid ? src[tk] : 0.0f;
                }
            }
        }
        __syncthreads();   // base_s is rewritten for the next group
    }
}

GF3X_EXPORT int gf3x_gather_cut_group(const float* rx, const int* q,
                                      float* out, long long B, long long T,
                                      long long valid, long long L, int block,
                                      void* stream) {
    const long long groups = B / kRows;
    const long long chunks = (L + kChunk - 1) / kChunk;
    if (groups > 0 && chunks > 0) {
        const dim3 grid(static_cast<unsigned>(chunks),
                        static_cast<unsigned>(groups < 65535 ? groups
                                                             : 65535));
        gather_cut_group_kernel<<<grid, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
            rx, q, out, groups, T, valid, L, block);
    }
    return static_cast<int>(cudaGetLastError());
}
