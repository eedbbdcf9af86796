// Hopper (sm_90a) building blocks as plain inline PTX: mbarriers, TMA tile
// loads through tensor maps built on the host, wgmma descriptors and the
// warpgroup products (the shapes the kernels use), their fences, commits
// and waits, and setmaxnreg; on the host, the tensor maps and the kernels'
// shared-memory attribute, each cached so that a repeated call sets them up
// only once. Used by the bf16 flash-attention kernels (flash_sm90.cuh).
//
// Shared-memory layouts. A TMA box of R rows by W bf16 columns, W x 2 = 32,
// 64 or 128 bytes (the row's swizzle span), lands as R rows of W x 2 bytes,
// each row's 16-byte chunks permuted by the swizzle: byte address bits [4, 4
// + s) are XORed with bits [7, 7 + s), s = 1, 2, 3 for 32, 64, 128 bytes (the
// pattern repeats every 8 rows, 256 / 512 / 1024 bytes, so a tile starts on
// a multiple of that). A wgmma descriptor names the same swizzle (its layout
// field) and reads such a tile two ways:
// - K-major (the rows are the product's M or N index, the columns its K):
//   a k16 step is 32 bytes of each row, so step kk starts kk x 32 bytes into
//   the row; the stride byte offset is 8 rows (the next group of 8 M/N rows);
// - MN-major (the rows are K, the columns M or N; the transpose bit): a k16
//   step is 16 rows, so step kk starts kk x 16 rows down; the stride byte
//   offset is again 8 rows (the next 8 K rows). N is at most one swizzle
//   span (64 columns at 128 bytes), so the leading byte offset, the stride
//   between spans along N, is never read.
// The hardware applies the swizzle to the address it forms, which is why a
// start address may move by 32 bytes inside a row.
//
// Fragments of wgmma.m64nNk16 (warp w of the warpgroup, lane l, g = l / 4,
// t = l % 4): accumulator register 4j + e holds row 16w + g + 8 (e / 2),
// column 8j + 2t + e % 2 (j < N / 8); a register A fragment's a[0..3] hold
// rows 16w + g, + 8, columns 2t, 2t + 1 (a[0], a[1]) and 2t + 8, 2t + 9
// (a[2], a[3]), low half first. So accumulator registers 8kk .. 8kk + 7,
// packed in pairs to bf16, are the A fragment of the k16 step kk of a
// product whose K is this one's N.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_runtime.h>

#include "common.cuh"  // allow_dynamic_smem

#include <cstdint>
#include <mutex>
#include <utility>
#include <vector>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(arrivals)
                 : "memory");
}
// makes the initialised barriers visible to the async proxy (TMA) and the CTA
__device__ __forceinline__ void fence_barrier_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// waits until the phase of parity `parity` has completed (a fresh barrier
// is in phase 0: parity 1 passes at once)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n.reg .pred done;\nWAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
        "r"(parity)
        : "memory");
}

// ---- TMA ----

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// the box of `map` at coordinates (c0, c1, c2), innermost first, into
// shared memory at dst; completes as transaction bytes on bar. Elements
// outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// ---- registers ----

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
// keeps the compiler from moving reads or writes of r across this point
// (a wgmma writes its accumulators, and reads its A fragments, after the
// instruction that issues it has retired)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// ---- wgmma ----

// the descriptor's layout field for a swizzle span of 128, 64 or 32 bytes
__host__ __device__ constexpr uint64_t swizzle_mode(int span) {
    return span == 128 ? 1 : span == 64 ? 2 : 3;
}

// A shared-memory matrix descriptor: start address, stride byte offset
// (the next 8 rows), the swizzle of `span`-byte rows; the leading byte
// offset is set to 16 bytes and not read (see the head note)
__device__ __forceinline__ uint64_t make_desc(const void* start, uint32_t stride_bytes, int span) {
    return static_cast<uint64_t>((smem_addr(start) & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
           (static_cast<uint64_t>(stride_bytes >> 4) << 32) | (swizzle_mode(span) << 62);
}

// orders this warpgroup's register and shared-memory accesses before the
// wgmma instructions that follow
__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most kPending committed groups of this warpgroup are in flight
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// d (+)= a b, m64n16k16: a and b K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(a), "l"(b), "r"(accumulate));
}

// d += a b, m64n16k16: a in registers, b MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (+)= a b, m64n32k16: a and b K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
}

// d += a b, m64n32k16: a in registers, b MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a b, m64n64k16: a in registers, b MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (+)= a b, m64n64k16: a and b K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= a b, m64n64k16: a in registers, b K-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (+)= a b, m64n32k16: a in registers, b K-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

}  // namespace sm90

// ---- host: tensor maps ----

// cuTensorMapEncodeTiled of the CUDA low-level API, reached through the
// runtime's entry-point query, so that no library links libcuda
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                          cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                                  &found);
#endif
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiledFn>(p)
                   : nullptr;
    }();
    return fn;
}

// A map of a (heads, rows, d) bf16 tensor as 3-D {d, rows, heads}, boxes of
// box_rows rows by min(d, 64) columns, swizzled by the box row's bytes (32,
// 64 or 128): rows past `rows` arrive as zeros, never as the next head's.
// The encoding is a pure function of (base, d, rows, heads, box_rows), so
// the last kMapCache encodings are kept, keyed by them, and a call that
// repeats one copies it instead of encoding it again
inline cudaError_t rows_map(CUtensorMap* map, const void* base, int d, int rows, int heads,
                            int box_rows) {
    struct Entry {
        const void* base;
        int d, rows, heads, box_rows;
        CUtensorMap map;
    };
    constexpr int kMapCache = 64;  // the bf16 backward's four maps a call, many shapes
    static Entry cache[kMapCache];
    static int filled = 0, next = 0;
    static std::mutex mu;
    {
        std::lock_guard<std::mutex> lock(mu);
        for (int e = 0; e < filled; ++e) {
            const Entry& c = cache[e];
            if (c.base == base && c.d == d && c.rows == rows && c.heads == heads &&
                c.box_rows == box_rows) {
                *map = c.map;
                return cudaSuccess;
            }
        }
    }
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const int cols = d < 64 ? d : 64;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                                static_cast<cuuint64_t>(heads)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                   static_cast<cuuint64_t>(d) * 2 * rows};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(box_rows), 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    const CUtensorMapSwizzle swizzle = cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                       : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_32B;
    const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
    std::lock_guard<std::mutex> lock(mu);
    cache[next] = Entry{base, d, rows, heads, box_rows, *map};
    next = (next + 1) % kMapCache;
    if (filled < kMapCache) ++filled;
    return cudaSuccess;
}

// allow_dynamic_smem (common.cuh) once for each kernel and device: the
// attribute stays set, so later launches skip the call
template <typename Kernel>
inline cudaError_t allow_dynamic_smem_once(Kernel kernel, size_t bytes) {
    static std::mutex mu;
    static std::vector<std::pair<const void*, int>> done;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    const std::pair<const void*, int> key{reinterpret_cast<const void*>(kernel), device};
    std::lock_guard<std::mutex> lock(mu);
    for (const auto& k : done)
        if (k == key) return cudaSuccess;
    err = allow_dynamic_smem(kernel, bytes);
    if (err == cudaSuccess) done.push_back(key);
    return err;
}
