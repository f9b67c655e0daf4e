// Error text for the codes the kernel entry points return.
#include "common.cuh"

GF3X_EXPORT const char* gf3x_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
