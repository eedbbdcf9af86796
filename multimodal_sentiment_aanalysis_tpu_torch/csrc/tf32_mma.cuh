// Shared by the kernels that run fp32 products on the tensor cores
// (lstm_gemm.cu, flash_attn.cu): TF32 rounding and the hi/lo split of the
// 3xTF32 scheme, the mma.sync.m16n8k8 TF32 product, and cp.async copies.
//
// 3xTF32: an fp32 operand v is split into two TF32 words, v = hi + lo, and a
// product a b is taken as a_hi b_hi + a_hi b_lo + a_lo b_hi (three mma.sync;
// the dropped a_lo b_lo is ~2^-22 of it), which is fp32-accurate where one
// TF32 pass (10-bit mantissa) is not.
//
// m16n8k8 fragments (g = lane / 4, t = lane % 4): A (16 x 8, row) a[0] at
// (g, t), a[1] (g + 8, t), a[2] (g, t + 4), a[3] (g + 8, t + 4); B (8 x 8,
// col) b0 at (k = t, n = g), b1 (t + 4, g); C (16 x 8) c[0], c[1] at (g, 2t),
// (g, 2t + 1), c[2], c[3] at row g + 8.
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t tf32(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
    return r;
}

// v = hi + lo with both parts TF32; lo is zero where v is exact in TF32
template <bool kExact>
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
    hi = tf32(v);
    lo = kExact ? 0u : tf32(v - __uint_as_float(hi));
}

// The same split with the low word left unrounded: the tensor cores read
// the upper 19 bits of a TF32 operand, which truncates it. lo = v - hi is
// exact and below half a TF32 ulp of v, so the truncation errs by < 2^-21
// |v|, the order of the lo.lo term that 3xTF32 drops; one conversion a
// value instead of two
__device__ __forceinline__ void split_tf32_trunc(float v, uint32_t& hi, uint32_t& lo) {
    hi = tf32(v);
    lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copies four elements of T (src_bytes of them from global memory, the rest
// zero) into shared memory, asynchronously
template <typename T>
__device__ __forceinline__ void cp_async4(T* dst, const T* src, bool valid) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    const int n = valid ? 4 * sizeof(T) : 0;
    if constexpr (sizeof(T) == 4)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
                     : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(n)
                     : "memory");
}
// Copies one float (or a zero, where !valid) into shared memory, asynchronously
__device__ __forceinline__ void cp_async1(float* dst, const float* src, bool valid) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 4 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
