// Shared by the gf3x_torch kernel sources: every entry point is a plain C
// function (loaded with ctypes) that launches on the caller's stream and
// returns cudaGetLastError() as an int, so a refused launch (too many
// threads, too much shared memory) reaches the Python wrapper, which raises.
#pragma once

#include <cuda_runtime.h>

#define GF3X_EXPORT extern "C" __attribute__((visibility("default")))

// Sum over the 32 lanes of a warp; every lane gets the total.
__device__ __forceinline__ float gf3x_warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}
