// Shared by every kernel library under csrc/.
//
// Each .cu file builds into its own shared library with a plain C interface
// (kernels/_build.py). Every entry point returns cudaGetLastError() as an int;
// the Python wrapper raises on a non-zero code and asks msa_error_string for
// the message.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

extern "C" const char* msa_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Element loads and stores of the kernels that have a bf16 form: storage is
// float or __nv_bfloat16, arithmetic is always float. bf16 converts only
// through the intrinsics, rounding to nearest even on the way out.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// Exact erf-GELU (torch nn.GELU default). The TPU kernels used a polynomial
// erf because Mosaic has none; CUDA's erff is accurate to 2 ulp.
__device__ __forceinline__ float gelu_erf(float v) {
    return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// d/dv of gelu_erf: Phi(v) + v * phi(v).
__device__ __forceinline__ float gelu_erf_grad(float v) {
    const float phi = expf(-0.5f * v * v) * 0.39894228040143268f;  // 1/sqrt(2 pi)
    return 0.5f * (1.0f + erff(v * 0.70710678118654752f)) + v * phi;
}

// One row of the EEG stem's epilogue, shared by the stem tail (stem_tail.cu)
// and the serving conv stem (conv_stem.cu): the folded BatchNorm x scale +
// shift, erf-GELU, dropout (a dropped row is 0, a kept one scaled by
// keep_scale; keep and keep_scale 1 without dropout), then MaxPool's
// first-max rule over the pool's rows: row j of the window replaces the
// running max m, and the code (winner + pool * keep bit), as its first row
// or where it is larger (torch MaxPool1d routes to the first max).
__device__ __forceinline__ void stem_pool_row(float x, float scale, float shift, bool keep,
                                              float keep_scale, int j, int pool, float& m,
                                              int& code) {
    float a = gelu_erf(fmaf(x, scale, shift));
    a = keep ? a * keep_scale : 0.0f;
    if (j == 0 || a > m) {
        m = a;
        code = j + pool * keep;
    }
}

__device__ __forceinline__ float sigmoid_f(float v) { return 1.0f / (1.0f + expf(-v)); }

// Warp-wide sum; every lane gets the total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}
