// The time-parallel products of the BiLSTM layer's forward and reverse sweeps,
// on the tensor cores: one tiled GEMM kernel, batched over the model axis S and
// the two directions, in five modes.
//
// Replaces the products that multimodal_sentiment_aanalysis_tpu/kernels/lstm.py
// computes inside its serial bodies, where they do not depend on the
// recurrence:
//
//   kProj    ::_fwd_xproj_kernel's input product, xp = x . W_ih^T + b, written
//            packed (S, B, T, 8H) [fwd | bwd] in actual time;
//   kGates   ::_segbwd_kernel's gate recompute: act([x | h_prev] . W_cat^T + b)
//            for every (b, t), h_prev the stored h_seq shifted by direction
//            (zero at each direction's first step), written in the same packed
//            layout as the gate activations (i, f, g, o); ::_cseq_kernel,
//            ::_bwd_xproj_kernel and ::_bwd_bwdc_kernel recompute the same;
//   kDx      its dx halves, dgates_d . W_ih_d, into dx_pk (S, 2, B, T, I);
//   kDw      its dW_cat_d = [x | h_prev | 1]^T . dgates_d, into (S, 2, I+H+1, 4H):
//            a reduction over the B*T rows, in fixed ranges summed in a fixed
//            order, so the result is deterministic without atomics;
//   kGatesXp ::_bwd_kernel's (v5) gate recompute: act(xp_d + h_prev . W_hh_d^T)
//            from the packed projection xp (S, B, T, 8H) the v5 forward read,
//            in the storage type (bf16 in the bf16 form, as JAX's _bwd_kernel
//            reads the v5 schedule's bf16 xp), written as kGates writes. It
//            is kGates with I = 0: K = H, the A operand h_prev alone and the
//            B operand the W_hh rows, and the epilogue adds xp[m, d 4H + n]
//            where kGates adds bias[n] (xp stays out of the product: as an
//            identity operand it would make K = 9H).
//
// What bounds it on the H100: at the flagship layer (B=64, T=73, I=256, H=128)
// each mode is 2.4-3.7 GFLOP per direction pair and model, so the tensor-core
// rate; the fp32 forms must stay fp32-accurate, which plain TF32 (10-bit
// mantissa) is not. So each fp32 operand is split into a TF32 high part and a
// TF32 low part and a product takes three mma.sync (hi.hi + hi.lo + lo.hi,
// "3xTF32"); a bf16 operand is exact in TF32 and is not split, so a bf16 x
// bf16 product takes one and a bf16 x fp32 product two. The tensor cores
// sum each 16-deep k-tile; the k-tiles are summed in fp32 on CUDA cores.
//
// Design: 64 x 64 output tiles, 4 warps of 32 x 32, mma.sync.m16n8k8 TF32,
// 16-deep k-tiles staged through a kStages-deep cp.async pipeline. The
// operands are gathered, not plain matrices (h_prev is a row-shifted view of
// h_seq with zero rows at the sequence ends, [x | h_prev | 1] a
// concatenation), so each thread copies its share of a 64 x 16 tile as
// 4-vectors (16 bytes of fp32 with cp.async.cg, 8 of bf16 with cp.async.ca)
// from per-vector source addresses, along the index in which the operand is
// contiguous: a vector past an edge, or in one of h_prev's zero rows, is a
// zero-filled copy (src-size 0), and the bias column's 1 a copy from a
// constant. Each operand stays in shared memory in its storage type (bf16
// as bf16) and converts to TF32 as the fragments load; I and H must be
// multiples of 4. dW_cat is a reduction over the B*T rows: at few models
// its 2 x 7 x 8 tiles a model would leave most of the 132 SMs idle, so the
// wrapper splits the rows into P fixed ranges (launch argument `splits`),
// each block writes its range's partial, and a second kernel sums the P
// partials in rank order: deterministic, no atomics. wgmma and larger tiles
// are later work.

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

enum Mode { kProj = 0, kGates = 1, kDx = 2, kDw = 3, kGatesXp = 4 };
// which operands a mode reads along k: x and W_ih; h_prev and W_hh
template <int kMode>
constexpr bool kReadsX = kMode == kProj || kMode == kGates;
template <int kMode>
constexpr bool kReadsH = kMode == kGates || kMode == kGatesXp;

constexpr int kBm = 64, kBn = 64, kBk = 16;
constexpr int kThreads = 128;        // 4 warps, 2 x 2 of 32 x 32
constexpr int kStages = 4;           // k-tiles in flight
// tile layouts in shared memory: "row-k" [64 rows][k], k contiguous, and
// "k-row" [k][64 rows], rows contiguous; strides padded so that a warp's
// fragment loads hit 32 different banks
constexpr int kLdRowK = kBk + 4, kLdKRow = kBm + 8;
constexpr int kTile = kBm * kLdRowK > kBk * kLdKRow ? kBm * kLdRowK : kBk * kLdKRow;

// the 1 of the bias column, as a 4-vector of either storage type
__device__ __align__(16) const uint32_t kOneF32[4] = {0x3F800000u, 0u, 0u, 0u};
__device__ __align__(16) const uint16_t kOneBf16[4] = {0x3F80u, 0u, 0u, 0u};

template <typename E>
__device__ __forceinline__ const E* one_vector();
template <>
__device__ __forceinline__ const float* one_vector<float>() {
    return reinterpret_cast<const float*>(kOneF32);
}
template <>
__device__ __forceinline__ const __nv_bfloat16* one_vector<__nv_bfloat16>() {
    return reinterpret_cast<const __nv_bfloat16*>(kOneBf16);
}

template <typename E>
struct Operands {
    const E* x;       // (S, B, T, I)
    const E* h_seq;   // (S, B, T, 2H)
    const E* w_ih;    // (S, 2, 4H, I)
    const E* w_hh;    // (S, 2, 4H, H)
    const E* bias;    // (S, 2, 4H)
    const float* dg;  // (S, B, T, 8H) packed fp32 dgates (kDx, kDw)
    const E* xp;      // (S, B, T, 8H) packed projection (kGatesXp)
    float* out;
    float* part;      // kDw at splits > 1: (splits, S, 2, I+H+1, 4H) partials
    int B, T, I, H;
    int M, N, K;      // of this mode's product, per (model, direction)
};

// Row m = b * T + t of h_prev for direction d: h_seq's row at the previous
// recurrence step (t - 1 forward, t + 1 backward), or null at the first step
template <typename E>
__device__ __forceinline__ const E* h_prev_row(const Operands<E>& p, int d, int m) {
    const int t = m % p.T;
    const int tp = d == 0 ? t - 1 : t + 1;
    if (tp < 0 || tp >= p.T) return nullptr;
    return p.h_seq + static_cast<size_t>(m - t + tp) * 2 * p.H + d * p.H;
}

// Per mode: A (M x K) and B (K x N) in shared memory, their storage types and
// layouts. kProj, kGates and kGatesXp read x, [x | h_prev] or h_prev and
// W_ih, [W_ih | W_hh] or W_hh along k: both row-k. kDx reads dgates along k (row-k) and W_ih along
// its I columns (k-row). kDw's A is [x | h_prev | 1] transposed: its m is the
// feature, contiguous, and its k the B*T rows (k-row), and B is dgates (k-row)
template <int kMode, typename E>
struct Traits {
    using TA = std::conditional_t<kMode == kDx, float, E>;
    using TB = std::conditional_t<kMode == kDw, float, E>;
    static constexpr bool kAKRow = kMode == kDw;
    static constexpr bool kBKRow = kMode == kDx || kMode == kDw;
};

// element (row, k) of a tile in either layout, as a float
template <bool kKRow, typename T>
__device__ __forceinline__ float tile_at(const T* s, int row, int k) {
    return to_float(kKRow ? s[k * kLdKRow + row] : s[row * kLdRowK + k]);
}

// Each k-tile, a thread copies two 4-vectors of A (64 x 16) and two of B
// (16 x 64). In a row-k tile vector e covers row tid / 4 + 32 e, k (tid % 4) 4;
// in a k-row tile k tid / 16 + 8 e, rows (tid % 16) 4. The row-k operands'
// row pointers are fixed per thread and worked out once. I and H are
// multiples of 4 (the wrapper checks), so no vector straddles the x | h_prev
// | 1 boundaries of the concatenated operands.
template <int kMode, typename E>
struct Stage {
    using TA = typename Traits<kMode, E>::TA;
    using TB = typename Traits<kMode, E>::TB;
    const TA* a_row[2] = {};  // x or dgates row (kProj, kGates, kDx); null past M
    const E* a_h[2] = {};     // h_prev row, null at the first step (kGates, kGatesXp)
    const E* b_i[2] = {};     // W_ih row (kProj, kGates); null past N
    const E* b_h[2] = {};     // W_hh row (kGates, kGatesXp)
    int kv = 0, kk = 0, cv = 0;

    __device__ __forceinline__ void init(const Operands<E>& p, int d, int m0, int n0) {
        const int tid = threadIdx.x;
        kv = (tid % 4) * 4;
        kk = tid / 16;
        cv = (tid % 16) * 4;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int m = m0 + tid / 4 + 32 * e, n = n0 + tid / 4 + 32 * e;
            if (m < p.M) {
                if constexpr (kReadsX<kMode>) a_row[e] = p.x + static_cast<size_t>(m) * p.I;
                if constexpr (kReadsH<kMode>) a_h[e] = h_prev_row(p, d, m);
            }
            if (n < p.N) {
                if constexpr (kReadsX<kMode>) b_i[e] = p.w_ih + static_cast<size_t>(n) * p.I;
                if constexpr (kReadsH<kMode>) b_h[e] = p.w_hh + static_cast<size_t>(n) * p.H;
            }
            if constexpr (kMode == kDx)
                if (m < p.M) a_row[e] = p.dg + static_cast<size_t>(m) * 8 * p.H + d * 4 * p.H;
        }
    }

    // issue the copies of k-tile k0 into as, bs; kend: the end of this
    // block's range of k (kDw splits the rows)
    __device__ __forceinline__ void issue(const Operands<E>& p, int d, int m0, int n0, int k0,
                                          int kend, TA* as, TB* bs) const {
        const int tid = threadIdx.x;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int r = tid / 4 + 32 * e;  // row of a row-k tile
            const int kr = kk + 8 * e;       // k of a k-row tile
            if constexpr (kReadsX<kMode> || kReadsH<kMode>) {
                // k runs over [x | h_prev] (I = 0 in kGatesXp); a zero-filled
                // copy still names a real address: x, or h_seq where x is null
                const int k = k0 + kv;
                const E* a = kReadsX<kMode> ? p.x : p.h_seq;
                const E* b = kReadsX<kMode> ? p.w_ih : p.w_hh;
                bool av = false, bv = false;
                if (k < p.I) {
                    av = a_row[e] != nullptr;
                    bv = b_i[e] != nullptr;
                    if (av) a = a_row[e] + k;
                    if (bv) b = b_i[e] + k;
                } else if (kReadsH<kMode> && k < p.K) {
                    av = a_h[e] != nullptr;
                    bv = b_h[e] != nullptr;
                    if (av) a = a_h[e] + (k - p.I);
                    if (bv) b = b_h[e] + (k - p.I);
                }
                cp_async4(as + r * kLdRowK + kv, a, av);
                cp_async4(bs + r * kLdRowK + kv, b, bv);
            } else if constexpr (kMode == kDx) {
                const int k = k0 + kv;
                const bool av = a_row[e] != nullptr && k < p.K;
                cp_async4(as + r * kLdRowK + kv, av ? a_row[e] + k : p.dg, av);
                const int kb = k0 + kr, n = n0 + cv;
                const bool bv = kb < p.K && n < p.N;
                cp_async4(bs + kr * kLdKRow + cv, bv ? p.w_ih + static_cast<size_t>(kb) * p.I + n
                                                     : p.w_ih, bv);
            } else {  // kDw: A'(feature, row) = [x | h_prev | 1][row][feature], B'(row, n) = dgates
                const int row = k0 + kr, f = m0 + cv, n = n0 + cv;
                const E* a = p.x;
                bool av = false;
                if (row < kend) {
                    if (f < p.I) {
                        a = p.x + static_cast<size_t>(row) * p.I + f;
                        av = true;
                    } else if (f < p.I + p.H) {
                        const E* hp = h_prev_row(p, d, row);
                        av = hp != nullptr;
                        if (av) a = hp + (f - p.I);
                    } else if (f == p.I + p.H) {
                        a = one_vector<E>();
                        av = true;
                    }
                }
                cp_async4(as + kr * kLdKRow + cv, a, av);
                const bool bv = row < kend && n < p.N;
                cp_async4(bs + kr * kLdKRow + cv,
                          bv ? p.dg + static_cast<size_t>(row) * 8 * p.H + d * 4 * p.H + n : p.dg,
                          bv);
            }
        }
    }
};

// kAExact / kBExact: the operand is bf16, exact in TF32
template <int kMode, typename E, bool kAExact, bool kBExact>
__global__ void __launch_bounds__(kThreads) bilstm_gemm_kernel(Operands<E> p, int tiles_n,
                                                               int splits) {
    using Tr = Traits<kMode, E>;
    using TA = typename Tr::TA;
    using TB = typename Tr::TB;
    __shared__ __align__(16) TA as[kStages][kTile];
    __shared__ __align__(16) TB bs[kStages][kTile];
    const int d = blockIdx.y;
    const size_t model = blockIdx.z / splits;
    const int range = blockIdx.z % splits;  // of the B*T rows (kDw)
    const int m0 = (blockIdx.x / tiles_n) * kBm;
    const int n0 = (blockIdx.x % tiles_n) * kBn;
    const int G = 4 * p.H;
    const size_t rows = static_cast<size_t>(p.B) * p.T;
    // a mode passes null for the operands it does not read
    if (p.x) p.x += model * rows * p.I;
    if (p.h_seq) p.h_seq += model * rows * 2 * p.H;
    if (p.w_ih) p.w_ih += (model * 2 + d) * G * p.I;
    if (p.w_hh) p.w_hh += (model * 2 + d) * G * p.H;
    if (p.bias) p.bias += (model * 2 + d) * G;
    if (p.dg) p.dg += model * rows * 2 * G;
    if (p.xp) p.xp += model * rows * 2 * G;

    // this block's k-tiles: all of them, or its split's fixed range (kDw)
    const int nk_all = (p.K + kBk - 1) / kBk;
    const int per = (nk_all + splits - 1) / splits;
    const int kt0 = min(nk_all, range * per), kt1 = min(nk_all, kt0 + per);
    const int kend = min(p.K, kt1 * kBk);
    const int nk = kt1 - kt0;

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
    const int gid = lane / 4, tig = lane % 4;
    // acc sums the k-tiles' products with fp32 adds that round to nearest;
    // each k-tile's products accumulate on the tensor cores in part, which
    // rounds less carefully, over 16 terms only (over B*T = 4672 terms in
    // dW_cat, the tensor cores' own sums drifted by 3e-5 of the result)
    float acc[2][4][4] = {};
    Stage<kMode, E> stage;
    stage.init(p, d, m0, n0);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < nk) stage.issue(p, d, m0, n0, (kt0 + s) * kBk, kend, as[s], bs[s]);
        cp_async_commit();  // an empty group past the end keeps the count
    }
    for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<kStages - 2>();  // k-tile kt has landed (this thread's copies)
        __syncthreads();               // (everyone's), and k-tile kt - 1 is consumed
        const int next = kt + kStages - 1;
        if (next < nk)
            stage.issue(p, d, m0, n0, (kt0 + next) * kBk, kend, as[next % kStages],
                        bs[next % kStages]);
        cp_async_commit();
        const TA* a_s = as[kt % kStages];
        const TB* b_s = bs[kt % kStages];
        float tile_acc[2][4][4] = {};
#pragma unroll
        for (int ks = 0; ks < kBk; ks += 8) {
            uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int r = wm + i * 16 + gid, k = ks + tig;
                split_tf32<kAExact>(tile_at<Tr::kAKRow>(a_s, r, k), a_hi[i][0], a_lo[i][0]);
                split_tf32<kAExact>(tile_at<Tr::kAKRow>(a_s, r + 8, k), a_hi[i][1], a_lo[i][1]);
                split_tf32<kAExact>(tile_at<Tr::kAKRow>(a_s, r, k + 4), a_hi[i][2], a_lo[i][2]);
                split_tf32<kAExact>(tile_at<Tr::kAKRow>(a_s, r + 8, k + 4), a_hi[i][3], a_lo[i][3]);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int n = wn + j * 8 + gid, k = ks + tig;
                uint32_t b_hi0, b_lo0, b_hi1, b_lo1;
                split_tf32<kBExact>(tile_at<Tr::kBKRow>(b_s, n, k), b_hi0, b_lo0);
                split_tf32<kBExact>(tile_at<Tr::kBKRow>(b_s, n, k + 4), b_hi1, b_lo1);
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    // the small terms first, then the large one
                    if constexpr (!kAExact) mma_tf32(tile_acc[i][j], a_lo[i], b_hi0, b_hi1);
                    if constexpr (!kBExact) mma_tf32(tile_acc[i][j], a_hi[i], b_lo0, b_lo1);
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

    // epilogue: c[0], c[1] at (gid, 2 tig + {0, 1}), c[2], c[3] at row gid + 8
    float* dst = p.out;
    if (kMode == kDw && splits > 1)
        dst = p.part + static_cast<size_t>(range) * (gridDim.z / splits) * 2 * p.M * p.N;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int m = m0 + wm + i * 16 + gid + (e >= 2 ? 8 : 0);
                const int n = n0 + wn + j * 8 + 2 * tig + (e & 1);
                if (m >= p.M || n >= p.N) continue;
                float v = acc[i][j][e];
                if constexpr (kMode == kProj || kReadsH<kMode>) {
                    v += kMode == kGatesXp
                             ? to_float(p.xp[static_cast<size_t>(m) * 2 * G + d * G + n])
                             : to_float(p.bias[n]);
                    if constexpr (kReadsH<kMode>) v = n / p.H == 2 ? tanhf(v) : sigmoid_f(v);
                    dst[(model * rows + m) * 2 * G + d * G + n] = v;
                } else {  // (S, 2, M, N)
                    dst[((model * 2 + d) * p.M + m) * p.N + n] = v;
                }
            }
}

// dW_cat = the sum of the splits' partials, in rank order
__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  size_t n, int splits) {
    for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
         i += static_cast<size_t>(gridDim.x) * blockDim.x) {
        float v = part[i];
        for (int s = 1; s < splits; ++s) v += part[s * n + i];
        out[i] = v;
    }
}

template <int kMode, typename E>
int launch(Operands<E> p, int S, int splits, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    constexpr bool kBf16 = !std::is_same<E, float>::value;
    // which operands are stored E (exact in TF32 when bf16) and which fp32 dgates
    constexpr bool kAExact = kBf16 && kMode != kDx;
    constexpr bool kBExact = kBf16 && kMode != kDw;
    const int rows = p.B * p.T;
    const int G = 4 * p.H;
    if constexpr (kMode == kProj) { p.M = rows; p.N = G; p.K = p.I; }
    if constexpr (kMode == kGates) { p.M = rows; p.N = G; p.K = p.I + p.H; }
    if constexpr (kMode == kGatesXp) { p.I = 0; p.M = rows; p.N = G; p.K = p.H; }
    if constexpr (kMode == kDx) { p.M = rows; p.N = p.I; p.K = G; }
    if constexpr (kMode == kDw) { p.M = p.I + p.H + 1; p.N = G; p.K = rows; }
    if (splits < 1 || (splits > 1 && (kMode != kDw || p.part == nullptr)))
        return cudaErrorInvalidValue;
    const int tiles_n = (p.N + kBn - 1) / kBn;
    const dim3 grid(tiles_n * ((p.M + kBm - 1) / kBm), 2, S * splits);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    bilstm_gemm_kernel<kMode, E, kAExact, kBExact><<<grid, kThreads, 0, st>>>(p, tiles_n, splits);
    if (splits > 1) {
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
        const size_t n = static_cast<size_t>(S) * 2 * p.M * p.N;
        sum_splits_kernel<<<264, 256, 0, st>>>(p.part, p.out, n, splits);
    }
    return cudaGetLastError();
}

// dg: the fp32 dgates, or xp in the storage type E (kGatesXp)
template <typename E>
int dispatch(int mode, const E* x, const E* h_seq, const E* w_ih, const E* w_hh, const E* bias,
             const void* dg, float* out, float* part, int S, int B, int T, int I, int H,
             int splits, int device, void* stream) {
    const bool is_xp = mode == kGatesXp;
    const Operands<E> p{x, h_seq, w_ih, w_hh, bias,
                        is_xp ? nullptr : static_cast<const float*>(dg),
                        is_xp ? static_cast<const E*>(dg) : nullptr,
                        out, part, B, T, I, H, 0, 0, 0};
    switch (mode) {
        case kProj: return launch<kProj>(p, S, splits, device, stream);
        case kGates: return launch<kGates>(p, S, splits, device, stream);
        case kDx: return launch<kDx>(p, S, splits, device, stream);
        case kDw: return launch<kDw>(p, S, splits, device, stream);
        case kGatesXp: return launch<kGatesXp>(p, S, splits, device, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// mode: 0 xp (S, B, T, 8H); 1 gate activations (S, B, T, 8H); 2 dx_pk
// (S, 2, B, T, I); 3 dW_cat (S, 2, I+H+1, 4H), its B*T rows in `splits`
// ranges whose partials go to `part` (splits, S, 2, I+H+1, 4H) when splits
// > 1; 4 the v5 gate activations (S, B, T, 8H) from h_seq, W_hh and xp
// (S, B, T, 8H) in the storage type of the form, passed as dg (I is not
// read); dg is the fp32 dgates otherwise. Operands a mode does not read may
// be null.
extern "C" int msa_bilstm_gemm(int mode, const float* x, const float* h_seq, const float* w_ih,
                               const float* w_hh, const float* bias, const void* dg, float* out,
                               float* part, int S, int B, int T, int I, int H, int splits,
                               int device, void* stream) {
    return dispatch(mode, x, h_seq, w_ih, w_hh, bias, dg, out, part, S, B, T, I, H, splits,
                    device, stream);
}

extern "C" int msa_bilstm_gemm_bf16(int mode, const __nv_bfloat16* x, const __nv_bfloat16* h_seq,
                                    const __nv_bfloat16* w_ih, const __nv_bfloat16* w_hh,
                                    const __nv_bfloat16* bias, const void* dg, float* out,
                                    float* part, int S, int B, int T, int I, int H, int splits,
                                    int device, void* stream) {
    return dispatch(mode, x, h_seq, w_ih, w_hh, bias, dg, out, part, S, B, T, I, H, splits,
                    device, stream);
}
