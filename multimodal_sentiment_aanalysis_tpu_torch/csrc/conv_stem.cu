// Serving conv stem stage: Conv1d + folded BatchNorm + erf-GELU + MaxPool in
// one kernel, so the conv output never reaches device memory.
//
// Replaces multimodal_sentiment_aanalysis_tpu/kernels/conv_stem.py::_stage_kernel
// (reached from eval/serving.py when use_pallas=True). There the conv ran as
// K shifted (T, C) x (C, O) matmuls on the MXU; here it is one implicit GEMM
// a batch row on the tensor cores.
//
// What bounds it on the H100, at B=64: operations. Stage 1 (C=32 -> O=64,
// K=15, T=585, pool 4) is 2.3 GFLOP of products against 2.4 MB in and 2.4 MB
// out; stage 2 (C=64 -> O=256, K=5, T=146, pool 2) is 1.5 GFLOP against 2.4
// MB in and 4.8 MB out. The output must stay fp32-accurate, which one TF32
// pass (10-bit mantissa) is not, so each product is three TF32 passes
// (3xTF32: hi.hi + hi.lo + lo.hi, tf32_mma.cuh) at the TF32 tensor-core
// rate.
//
// Design: the GEMM of a batch row has M = the conv positions, N = the output
// channels and K = C x taps, ordered tap-major. A block owns one batch row, a
// tile of kBm conv positions (P = kBm / pool whole pool windows, so the
// pooled rows never straddle two blocks) and kBn output channels; 4 warps of
// 32 x 32 run mma.sync.m16n8k8.
// - The input window, the tile's rows plus the K - 1 halo, zero-filled past
//   the sequence's ends (the conv's padding) and past C, is staged once in
//   shared memory through cp.async and split there once into its TF32 high
//   and low words. The A fragments of tap k are the window's rows shifted
//   by k, so no im2col tensor exists.
// - The (taps, C, O) weight slab (the wrapper's transposed copy of the
//   (O, C, K) weight) streams through a kStages-deep cp.async ring in
//   k-tiles of 16 input channels of one tap, split into TF32 words as the
//   B fragments load.
// - Each 16-deep k-tile is summed on the tensor cores (its three passes, the
//   small terms first) and the k-tiles in fp32 on the CUDA cores, as
//   lstm_gemm.cu does.
// - The epilogue applies fmaf(acc, scale, shift) and GELU (stem_pool_row in
//   common.cuh, which the stem tail shares) and takes the pool's max across
//   the accumulator rows: a pool that divides 8 has its rows in neighbouring
//   lane groups of one fragment, folded with warp shuffles (first max wins);
//   any other pool folds rows staged in shared memory. Only the pooled rows
//   are written.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kBm = 64;           // conv positions a block
constexpr int kBn = 64;           // output channels a block
constexpr int kBk = 16;           // input channels of one tap a k-tile
constexpr int kThreads = 128;     // 4 warps, 2 x 2 of 32 x 32
constexpr int kStages = 4;        // weight k-tiles in flight
constexpr int kLdB = kBn + 8;     // weight tile [k][n]: a B fragment load hits 32 banks
constexpr int kLdOut = kBn + 4;   // the epilogue's [m][n] tile, in the ring's memory
constexpr int kRing = kStages * kBk * kLdB;
static_assert(kBm * kLdOut <= kRing, "the epilogue tile reuses the weight ring");

struct Params {
    const float* x;      // (B, T, C)
    const float* w_t;    // (taps, C, Op): Op = O rounded up to 4, zero columns past O
    const float* scale;  // (O,)
    const float* shift;  // (O,)
    float* out;          // (B, t_out, O)
    int T, C, O, Op, taps, pad, pool, t_out;
    int cp;       // C rounded up to kBk: the window's columns past C are zero
    int ldw;      // window row stride, cp + 4: an A fragment load hits 32 banks
    bool vec_x;   // x rows as 16-byte vectors (C % 4 == 0, x aligned)
};

// the window's rows and the ring's weight tiles, and the window split into
// TF32 words: [rows][ldw] high words, then the low words
inline size_t smem_bytes(int taps, int ldw) {
    return sizeof(float) * (kRing + 2 * static_cast<size_t>(kBm + taps - 1) * ldw);
}

__device__ __forceinline__ void issue_weights(const Params& p, int kt, int n0, float* bs) {
    const int cpt = p.cp / kBk;
    const int tap = kt / cpt, c0 = (kt % cpt) * kBk;
#pragma unroll
    for (int e = 0; e < kBk * kBn / 4 / kThreads; ++e) {
        const int v = threadIdx.x + e * kThreads;
        const int k = v / (kBn / 4), n = n0 + 4 * (v % (kBn / 4));
        const bool valid = c0 + k < p.C && n < p.Op;
        const float* src =
            valid ? p.w_t + (static_cast<size_t>(tap) * p.C + c0 + k) * p.Op + n : p.w_t;
        cp_async4(bs + k * kLdB + (n - n0), src, valid);
    }
}

__global__ void __launch_bounds__(kThreads) conv_stem_kernel(Params p) {
    extern __shared__ __align__(16) float smem[];
    float* ring = smem;                                              // [kStages][kBk][kLdB]
    uint32_t* win_hi = reinterpret_cast<uint32_t*>(smem + kRing);    // [rows][ldw]
    const int rows = kBm + p.taps - 1;
    uint32_t* win_lo = win_hi + rows * p.ldw;
    const int b = blockIdx.z;
    const int P = kBm / p.pool;  // pooled rows a block
    const int to0 = blockIdx.x * P;
    const int m0 = to0 * p.pool;  // first conv position
    const int n0 = blockIdx.y * kBn;
    const int t0 = m0 - p.pad;    // input row of window row 0
    const float* xb = p.x + static_cast<size_t>(b) * p.T * p.C;

    // the window, zero past the sequence's ends and past C, as fp32 in win_hi
    float* win = reinterpret_cast<float*>(win_hi);
    if (p.vec_x) {
        const int vecs = p.cp / 4;
        for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
            const int r = i / vecs, c = 4 * (i - r * vecs), t = t0 + r;
            const bool valid = t >= 0 && t < p.T && c < p.C;
            cp_async4(win + r * p.ldw + c, valid ? xb + static_cast<size_t>(t) * p.C + c : p.x,
                      valid);
        }
    } else {
        for (int i = threadIdx.x; i < rows * p.cp; i += kThreads) {
            const int r = i / p.cp, c = i - r * p.cp, t = t0 + r;
            const bool valid = t >= 0 && t < p.T && c < p.C;
            cp_async1(win + r * p.ldw + c, valid ? xb + static_cast<size_t>(t) * p.C + c : p.x,
                      valid);
        }
    }
    cp_async_commit();
    const int nk = p.taps * (p.cp / kBk);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < nk) issue_weights(p, s, n0, ring + s * kBk * kLdB);
        cp_async_commit();  // an empty group past the end keeps the count
    }
    cp_async_wait<kStages - 1>();  // the window (the oldest group) has landed
    __syncthreads();
    for (int i = threadIdx.x; i < rows * p.ldw; i += kThreads) {
        uint32_t hi, lo;
        split_tf32<false>(win[i], hi, lo);
        win_hi[i] = hi;
        win_lo[i] = lo;
    }

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
    const int gid = lane / 4, tig = lane % 4;
    const int cpt = p.cp / kBk;
    float acc[2][4][4] = {};
    for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<kStages - 2>();  // k-tile kt has landed (this thread's copies)
        __syncthreads();  // (everyone's), the window is split, k-tile kt - 1 is consumed
        const int next = kt + kStages - 1;
        if (next < nk) issue_weights(p, next, n0, ring + (next % kStages) * kBk * kLdB);
        cp_async_commit();
        const float* bs = ring + (kt % kStages) * kBk * kLdB;
        const int tap = kt / cpt, c0 = (kt % cpt) * kBk;
        float tile_acc[2][4][4] = {};
#pragma unroll
        for (int ks = 0; ks < kBk; ks += 8) {
            uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                // conv position wm + 16 i + gid reads window row (position + tap)
                const int o = (wm + i * 16 + gid + tap) * p.ldw + c0 + ks + tig;
                const int offs[4] = {o, o + 8 * p.ldw, o + 4, o + 8 * p.ldw + 4};
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    a_hi[i][q] = win_hi[offs[q]];
                    a_lo[i][q] = win_lo[offs[q]];
                }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float* bj = bs + (ks + tig) * kLdB + wn + j * 8 + gid;
                uint32_t b_hi0, b_lo0, b_hi1, b_lo1;
                split_tf32<false>(bj[0], b_hi0, b_lo0);
                split_tf32<false>(bj[4 * kLdB], b_hi1, b_lo1);
#pragma unroll
                for (int i = 0; i < 2; ++i) {  // the small terms first, then the large one
                    mma_tf32(tile_acc[i][j], a_lo[i], b_hi0, b_hi1);
                    mma_tf32(tile_acc[i][j], a_hi[i], b_lo0, b_lo1);
                    mma_tf32(tile_acc[i][j], a_hi[i], b_hi0, b_hi1);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] += tile_acc[i][j][e];
    }
    cp_async_wait<0>();  // no copy outlives the block

    // epilogue: c[0], c[1] at (row gid, columns 2 tig + {0, 1}), c[2], c[3] at row gid + 8
    float* dst = p.out + static_cast<size_t>(b) * p.t_out * p.O;
    if (8 % p.pool == 0) {
        // a pool window is `pool` neighbouring gids of one fragment half:
        // lanes 4 apart, folded with xor shuffles over lane bits 2, 3, 4
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int n = n0 + wn + j * 8 + 2 * tig + h;
                const float sc = n < p.O ? p.scale[n] : 0.0f, sh = n < p.O ? p.shift[n] : 0.0f;
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        float m;
                        int code;
                        stem_pool_row(acc[i][j][2 * half + h], sc, sh, true, 1.0f, 0, 1, m, code);
                        for (int off = 4; off < 4 * p.pool; off *= 2) {
                            // the lane with the off bit set holds the later rows
                            const float other = __shfl_xor_sync(0xffffffffu, m, off);
                            const float earlier = lane & off ? other : m;
                            const float later = lane & off ? m : other;
                            m = later > earlier ? later : earlier;
                        }
                        const int row = wm + i * 16 + half * 8 + gid;
                        const int to = to0 + row / p.pool;
                        if (gid % p.pool == 0 && to < p.t_out && n < p.O)
                            dst[static_cast<size_t>(to) * p.O + n] = m;
                    }
            }
        return;
    }
    // any other pool: the accumulators through shared memory, then a
    // thread per pooled cell folds the window's rows in order
    __syncthreads();  // every warp is done with the ring
    float* tile = ring;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                tile[(wm + i * 16 + gid + (e >= 2 ? 8 : 0)) * kLdOut + wn + j * 8 + 2 * tig +
                     (e & 1)] = acc[i][j][e];
    __syncthreads();
    for (int i = threadIdx.x; i < P * kBn; i += kThreads) {
        const int pr = i / kBn, nl = i - pr * kBn, n = n0 + nl, to = to0 + pr;
        if (to >= p.t_out || n >= p.O) continue;
        const float sc = p.scale[n], sh = p.shift[n];
        float m = 0.0f;
        int code = 0;
        for (int j = 0; j < p.pool; ++j)
            stem_pool_row(tile[(pr * p.pool + j) * kLdOut + nl], sc, sh, true, 1.0f, j, p.pool,
                          m, code);
        dst[static_cast<size_t>(to) * p.O + n] = m;
    }
}

}  // namespace

// w_t: the (K, C, O) transposed weight with its rows padded to O rounded up
// to 4 (zero columns), 16-byte aligned
extern "C" int msa_conv_stem(const float* x, const float* w_t, const float* scale,
                             const float* shift, float* out, int B, int T, int C, int O,
                             int K, int pad, int pool, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    Params p;
    p.x = x;
    p.w_t = w_t;
    p.scale = scale;
    p.shift = shift;
    p.out = out;
    p.T = T;
    p.C = C;
    p.O = O;
    p.Op = (O + 3) / 4 * 4;
    p.taps = K;
    p.pad = pad;
    p.pool = pool;  // the wrapper keeps 1 <= pool <= kBm
    p.t_out = (T + 2 * pad - K + 1) / pool;
    p.cp = (C + kBk - 1) / kBk * kBk;
    p.ldw = p.cp + 4;
    p.vec_x = C % 4 == 0 && !(reinterpret_cast<uintptr_t>(x) & 15);
    const size_t smem = smem_bytes(K, p.ldw);
    err = allow_dynamic_smem(conv_stem_kernel, smem);
    if (err != cudaSuccess) return err;
    const int P = kBm / pool;
    const dim3 grid((p.t_out + P - 1) / P, (O + kBn - 1) / kBn, B);
    conv_stem_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return cudaGetLastError();
}
