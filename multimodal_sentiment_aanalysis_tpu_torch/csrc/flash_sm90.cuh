// What the bf16 flash-attention kernels for Hopper share (the forward,
// flash_attn_bf16.cu, and the backward, flash_bwd_bf16.cu), on sm90.cuh:
// the CTA's shape (two consumer warpgroups of 64 own rows, a producer
// warpgroup), the persistent walk over work items of 128 own rows, the TMA
// tile loads, the wgmma products in the shapes both use and the moves
// between accumulators, register A fragments and global memory.
//
// A tile in shared memory is one TMA box of R rows of span_of(D) bytes, or
// at D = 128 two boxes of 64 columns one after the other, swizzled by the
// row's span (sm90.cuh's head note).
#pragma once

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace flash_sm90 {

using bf16 = __nv_bfloat16;
using sm90::make_desc;

constexpr int kConsumers = 2;                     // consumer warpgroups, 64 own rows each
constexpr int kOwnRows = 64 * kConsumers;         // own rows a work item
constexpr int kThreads = 128 * (kConsumers + 1);  // the consumers, then the producer
// one CTA an SM starts at 168 registers a thread; the producer gives 128 of
// its own to the consumers: 128 x (2 x 232 + 40) = 384 x 168
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x, one MUFU.EX2 (a result below 2^-126 flushes to 0); exp2f adds a
// range check and two scalings a call for subnormal results, and the exp
// loops are bound by instruction issue
__device__ __forceinline__ float exp2_ftz(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// bytes of a tile row in shared memory: the row's swizzle span, or at D = 128
// one of its two 64-column boxes
__host__ __device__ constexpr int span_of(int d) { return d < 64 ? 2 * d : 128; }

// two fp32 values rounded to nearest even into a packed bf16 pair
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// The TMA loads of `rows` rows from row0 of head bh into the tile at dst:
// one box, or at D = 128 two of 64 columns, each rows x kSpan bytes
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int row0, int bh, int rows) {
    constexpr int kSpan = span_of(D);
#pragma unroll
    for (int b = 0; b < (D > 64 ? 2 : 1); ++b)
        sm90::tma_load_3d(dst + b * rows * kSpan, map, bar, b * 64, row0, bh);
}

// s (=) the own tile's rows own_row .. own_row + 63 x the streamed tile's
// rows row .. row + N - 1, transposed: N = 2 x kRegs, K = D. Both K-major:
// k16 step kk reads 32 bytes of each row, kk x 32 bytes in (box kk / 4 at D
// = 128)
template <int D, int kRegs>
__device__ __forceinline__ void ss_product(float (&s)[kRegs], const uint8_t* own, int own_row,
                                           const uint8_t* tile, int tile_rows, int row) {
    constexpr int kSpan = span_of(D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const int box = kk / 4, at = (kk % 4) * 32;
        const uint64_t a =
            make_desc(own + box * kOwnRows * kSpan + own_row * kSpan + at, 8 * kSpan, kSpan);
        const uint64_t b =
            make_desc(tile + box * tile_rows * kSpan + row * kSpan + at, 8 * kSpan, kSpan);
        sm90::wgmma_ss(s, a, b, kk > 0);
    }
}

// s (=) own x the streamed tile's rows row .. row + N - 1, transposed, as
// ss_product with the own rows' A fragments in registers (a[kk]: k16 step
// kk), so that the tensor cores read only B from shared memory
template <int D, int kRegs>
__device__ __forceinline__ void rs_product_k(float (&s)[kRegs], const uint32_t (&a)[D / 16][4],
                                             const uint8_t* tile, int tile_rows, int row) {
    constexpr int kSpan = span_of(D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const int box = kk / 4, at = (kk % 4) * 32;
        const uint8_t* b = tile + box * tile_rows * kSpan + row * kSpan + at;
        sm90::wgmma_rs(s, a[kk], make_desc(b, 8 * kSpan, kSpan), kk > 0);
    }
}

// The A fragments of this thread's own rows (r0 = 16 warp + g, r0 + 8, warp
// counting both consumer warpgroups) at every k16 step, read from the
// swizzled own tile as TMA wrote it: byte b of a row-major tile of
// span-byte rows lies at b ^ (((b >> 7) & (span / 16 - 1)) << 4) (bits 4..
// XORed with bits 7..)
template <int D>
__device__ __forceinline__ void own_fragments(uint32_t (&a)[D / 16][4], const uint8_t* own,
                                              int r0) {
    constexpr int kSpan = span_of(D);
    const int t = threadIdx.x % 4;
    auto pair = [&](int row, int col) {
        uint32_t byte = row * kSpan + (col % 64) * 2;
        byte ^= ((byte >> 7) & (kSpan / 16 - 1)) << 4;
        return *reinterpret_cast<const uint32_t*>(own + (col / 64) * kOwnRows * kSpan + byte);
    };
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const int c = 16 * kk + 2 * t;
        a[kk][0] = pair(r0, c);
        a[kk][1] = pair(r0 + 8, c);
        a[kk][2] = pair(r0, c + 8);
        a[kk][3] = pair(r0 + 8, c + 8);
    }
}

// acc += a x the streamed tile's rows row .. row + 15 (K = 16, N = D), the
// tile read MN-major; at D = 128 one m64n64k16 per box
template <int D>
__device__ __forceinline__ void rs_product(float (&acc)[D / 2], const uint32_t (&a)[4],
                                           const uint8_t* tile, int tile_rows, int row) {
    constexpr int kSpan = span_of(D);
    if constexpr (D <= 64) {
        sm90::wgmma_rs_mn(acc, a, make_desc(tile + row * kSpan, 8 * kSpan, kSpan));
    } else {
#pragma unroll
        for (int b = 0; b < 2; ++b)
            sm90::wgmma_rs_mn(*reinterpret_cast<float(*)[32]>(&acc[32 * b]), a,
                              make_desc(tile + b * tile_rows * 128 + row * 128, 1024, 128));
    }
}

// accumulator registers 8kk .. 8kk + 7 as the A fragment of k16 step kk, bf16
template <int kRegs>
__device__ __forceinline__ void acc_as_a(const float (&c)[kRegs], uint32_t (&a)[kRegs / 8][4]) {
#pragma unroll
    for (int kk = 0; kk < kRegs / 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[kk][e] = pack_bf16(c[8 * kk + 2 * e], c[8 * kk + 2 * e + 1]);
}

// this thread's two rows (16 warp + g, + 8, warp counting both consumer
// warpgroups) of acc to rows row0 + ... of out (those below n), as bf16
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 2], int n, int row0) {
    const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int i = row0 + 16 * warp + g + 8 * h;
        if (i >= n) continue;
        bf16* oi = out + static_cast<size_t>(i) * D + 2 * t;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(oi + 8 * j) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
}

// The work items: a block of kOwnRows own rows of one head each, a head's
// blocks adjacent; CTA b takes items b, b + gridDim.x, ... (one CTA an SM),
// so that the ring runs on from one item into the next and a head's
// streamed side comes from memory once and from L2 for the rest
struct Work {
    int items, blocks;  // items = heads x blocks
    __device__ __forceinline__ int head(int item) const { return item / blocks; }
    __device__ __forceinline__ int row0(int item) const { return (item % blocks) * kOwnRows; }
};

// one CTA an SM, at most one a work item (heads x blocks of own rows); each
// device's SM count is asked for once
inline cudaError_t persistent_grid(long long items, unsigned& grid) {
    constexpr int kDevices = 64;
    static std::atomic<int> sm_count[kDevices];  // 0: not asked yet
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device >= kDevices || items > 0x7fffffff) return cudaErrorInvalidValue;
    int sms = sm_count[device].load(std::memory_order_relaxed);
    if (sms == 0) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        if (err != cudaSuccess) return err;
        sm_count[device].store(sms, std::memory_order_relaxed);
    }
    grid = static_cast<unsigned>(items < sms ? items : sms);
    return cudaSuccess;
}

// a streamed tile of 32, 64 or 128 rows: fn(std::integral_constant<int, tile>)
template <typename Fn>
cudaError_t by_tile(int tile, Fn fn) {
    switch (tile) {
        case 32: return fn(std::integral_constant<int, 32>());
        case 64: return fn(std::integral_constant<int, 64>());
        case 128: return fn(std::integral_constant<int, 128>());
        default: return cudaErrorInvalidValue;
    }
}

// a head dim of 16, 32, 64 or 128: fn(std::integral_constant<int, D>)
template <typename Fn>
cudaError_t by_dim(int d, Fn fn) {
    switch (d) {
        case 16: return fn(std::integral_constant<int, 16>());
        case 32: return fn(std::integral_constant<int, 32>());
        case 64: return fn(std::integral_constant<int, 64>());
        case 128: return fn(std::integral_constant<int, 128>());
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace flash_sm90
