// Shared by the gf3x_torch kernel sources: every entry point is a plain C
// function (loaded with ctypes) that launches on the caller's stream and
// returns cudaGetLastError() as an int, so a refused launch (too many
// threads, too much shared memory) reaches the Python wrapper, which raises.
#pragma once

#include <cuda_runtime.h>

#define GF3X_EXPORT extern "C" __attribute__((visibility("default")))

constexpr int kMaxDevices = 64;

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current
// device, where that is above the 48 KB default: the limit is an attribute
// of the kernel on each device, so `set` keeps, per device, the largest
// size allowed there so far and the attribute is set only when it grows.
template <typename Kernel>
cudaError_t gf3x_allow_smem(Kernel kernel, size_t smem,
                            size_t (&set)[kMaxDevices]) {
    if (smem <= 48 * 1024) return cudaSuccess;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices && smem <= set[dev]) return cudaSuccess;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e == cudaSuccess && dev < kMaxDevices) set[dev] = smem;
    return e;
}

// Sum over the 32 lanes of a warp; every lane gets the total.
__device__ __forceinline__ float gf3x_warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// cp.async copies into shared memory: 8 bytes (through L1) or 16 (L2 only).
__device__ __forceinline__ void gf3x_cp_async8(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void gf3x_cp_async16(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void gf3x_cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for all but the newest group: the current buffer's copy.
__device__ __forceinline__ void gf3x_cp_async_wait_all_but_newest() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
