// Block-aligned per-row window cut.
//
// Replaces gf3x/ops/pallas/gather_cut.py:gather_cut_tpu, the cut that
// gf3x's `cut_symbols` falls back to when the batch is not a whole number of
// 8-row groups (gf3x/ops/sync.py:339-344) — `Modem.decode` of one recording.
// Row i of the output is rx[i, q[i]·block :][:L]; samples at or past `valid`
// (the whole-block prefix floor(T/block)·block) read as zero, the
// `gather_cut` boundary semantics (gf3x/ops/sync.py:274-351).
//
// The TPU kernel keeps a rolling window of 16 row DMAs in flight on a
// (B, n_blocks, block) tile view, whose slice shape forces L to a multiple
// of 8 blocks. A GPU block reads its span straight from device memory, so
// the window is exactly the L samples the caller asks for.
//
// What bounds it on the card: bytes, B·L·4 read and as many written. One
// block per (row, 1024-sample chunk); neighbouring threads copy
// neighbouring samples, so loads and stores coalesce; no shared memory.
#include "common.cuh"

namespace {
constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kChunk = kThreads * kPerThread;
}  // namespace

__global__ void gather_cut_kernel(const float* __restrict__ rx,
                                  const int* __restrict__ q,
                                  float* __restrict__ out, long long T,
                                  long long valid, long long L, int block,
                                  long long chunks) {
    const long long row = blockIdx.x / chunks;
    const long long c0 = (blockIdx.x % chunks) * kChunk;
    const long long base = static_cast<long long>(q[row]) * block;
    const float* src = rx + row * T;
    float* dst = out + row * L;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
        const long long i = c0 + j * kThreads + threadIdx.x;
        if (i < L) {
            const long long t = base + i;
            dst[i] = t < valid ? src[t] : 0.0f;
        }
    }
}

GF3X_EXPORT int gf3x_gather_cut(const float* rx, const int* q, float* out,
                                long long B, long long T, long long valid,
                                long long L, int block, void* stream) {
    const long long chunks = (L + kChunk - 1) / kChunk;
    const long long nblocks = B * chunks;
    if (nblocks > 0) {
        gather_cut_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
            rx, q, out, T, valid, L, block, chunks);
    }
    return static_cast<int>(cudaGetLastError());
}
