// EEG stem tail: BatchNorm + erf-GELU + dropout + MaxPool over the conv
// output, forward and backward.
//
// Replaces multimodal_sentiment_aanalysis_tpu/kernels/conv_stem_train.py::
// _fwd_kernel (msa_stem_tail) and ::_bwd_kernel (msa_stem_tail_bwd).
//
// Both kernels take a leading model axis S (the LOSO trainer's models under
// torch.func.vmap): conv (S, B, T, C) and per-model (S, C) statistics and
// affine parameters, all S models in one launch.
//
// Forward: one pass over conv. BN with the statistics it is given (batch
// stats in train mode, running stats in eval), exact erf-GELU, dropout with
// keep probability 1 - p, and MaxPool(pool) routed to the first max, as torch
// MaxPool1d (stem_pool_row in common.cuh, which the serving conv stem
// shares). Besides the pooled output it can write one int32 code per pooled
// cell, winner index + pool * keep bit, which is all the backward needs.
//
// What bounds the forward on the H100: bytes. At the LOSO step (S=24, B=64,
// fp32) stage 1 (T=585, C=64, pool 4) and stage 2 (T=146, C=256, pool 2)
// each read 230 MB of conv and write the pooled output and the codes. Its
// design:
// - vector access: a thread owns 4 consecutive channels of its pooled cells
//   and loads their pool windows' rows as 16-byte loads in fp32 (8 in
//   bf16), and stores the pooled values and codes the same way. It keeps 8
//   rows in flight (kSlots: a pool shorter than 8 gives a thread several
//   pooled rows), issued before the block folds its per-channel values, so
//   the two latencies overlap: the memory system, not the GELU, set the
//   pace of a thread with fewer. The grid is (channel-group tile x
//   pooled-row tile, batch row, model): offsets in 32-bit arithmetic
//   within the model (the wrapper keeps B T C < 2^31), no per-element
//   division. A C that is not a multiple of 4 (or a pointer that is not
//   aligned for the vector) runs the same loop with scalar accesses, the
//   last group of a row holding fewer channels;
// - the per-channel values once per block: its channels' scale = gamma
//   rsqrt(var + eps) and shift = beta - mean scale, folded into shared
//   memory by the block's first threads, so an element costs one fmaf;
// - four keep bits per Philox call: no mask tensor exists. The keep bit of
//   element e of model s (its flat index (b T + t) C + c within the model)
//   is word e mod 4 of Philox4x32-10 (Salmon et al., "Parallel random
//   numbers: as easy as 1, 2, 3", SC'11) at counter e div 4 under the key
//   seed[s], compared with the threshold: kept iff the word is >= it. The
//   wrapper draws the seeds, one per model, on the device from a
//   torch.Generator (no host sync). A thread's 4 channels of one row are
//   one counter where C is a multiple of 4, so a 10-round Philox serves 4
//   elements (kernels/conv_stem_train.py::keep_mask_plain is the same
//   stream in numpy). A tensor-parallel rank holds a channel shard: C of
//   the layer's c_full channels, from channel c_off on. Its element index
//   is the whole layer's, (b T + t) c_full + c_off + c, so a shard's keep
//   bits are exactly the unsharded tensor's columns (c_full = C and
//   c_off = 0 for a tensor held whole). The wrapper refuses a shard whose
//   C is not a multiple of 4, so that a thread's 4 channels stay one
//   counter.
//
// Backward: the code routes dpool to the window's winner, ONE gelu_grad,
// kept cells scaled by 1/(1-p); it writes dy at the conv's full length (S,
// B, T, C), 0 away from the winners and in the tail rows T - t_out pool
// that no window covers, so the caller pads nothing, and per-channel
// partial sums of g * xhat and g (dgamma, dbeta). The BN input-gradient
// combine stays in torch, as it stays in XLA in JAX. It reads the BN values
// as scale and shift from the wrapper.
//
// What bounds the backward: bytes. At the LOSO step's stage 2 (S=24, B=64,
// T=146, C=256, pool 2, fp32) it reads 230 MB of conv and 115 MB each of
// dpool and code and writes 230 MB of dy: 0.21 ms at 3.35 TB/s. Every
// window row is read (the winners of 4 channels cover nearly every 32-byte
// sector of a row, so reading only them saves nothing). Its design, the
// forward's:
// - vector access: a thread owns 4 consecutive channels of its pooled
//   cells: one 16-byte load of their dpool (8 in bf16), one int4 of their
//   codes, the window's rows as 16-byte (8-byte) loads with the winner
//   selected per channel, and dy as one 16-byte store a window row. 8
//   window rows in flight a thread (kSlots: 2 cells at pool 4, 4 at pool
//   2; the pool is a template parameter there, any other pool runs one cell
//   at a time), all of a pass's loads issued before any is used;
// - the grid (row tile x channel-group tile, batch row, model): 32-bit
//   offsets within the model, no per-element division;
// - deterministic partials, one per (model, batch row x row tile, channel):
//   a thread's rows summed in order, the block's thread rows folded by xor
//   shuffles and then across its warps through shared memory in a fixed
//   order; the wrapper sums the chunks (no atomics). The wrapper picks the
//   row tile so that a launch has a few waves of blocks.
// A C that is not a multiple of 4 (or a pointer not aligned for the
// vector) runs the same loop with scalar accesses.
//
// Each entry point has an fp32 and a bf16 form (suffix _bf16), one template
// over the element type E of conv, the pooled output and dpool. The
// per-channel statistics and affine parameters, dy and the partials are
// fp32 in both, and so is the whole body, as the JAX kernels upcast their
// blocks; the bf16 form reads and writes half the bytes of the big tensors.
// The TPU's full-lane relayout was a Mosaic workaround and is not carried
// over: rows stay (B, T, C) with channels fastest.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

// Philox4x32-10: the four 32-bit words at a counter (n, 0, 0, 0) under the
// key (k0, k1)
__device__ __forceinline__ uint4 philox4x32_10(uint32_t n, uint32_t k0, uint32_t k1) {
    constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
    constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
    uint32_t x0 = n, x1 = 0u, x2 = 0u, x3 = 0u;
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        const uint32_t hi0 = __umulhi(kM0, x0), lo0 = kM0 * x0;
        const uint32_t hi1 = __umulhi(kM1, x2), lo1 = kM1 * x2;
        x0 = hi1 ^ x1 ^ k0;
        x1 = lo1;
        x2 = hi0 ^ x3 ^ k1;
        x3 = lo0;
        k0 += kW0;
        k1 += kW1;
    }
    return make_uint4(x0, x1, x2, x3);
}

__device__ __forceinline__ uint32_t word(const uint4& w, int i) {
    return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// A thread's 4 channels of one conv row as loaded: one 16-byte access in
// fp32, one 8-byte access in bf16 (kVec), or n <= 4 scalar accesses (kept
// as floats)
template <typename E, bool kVec>
using Slot = std::conditional_t<kVec && std::is_same_v<E, __nv_bfloat16>, uint2, float4>;

template <typename E, bool kVec>
__device__ __forceinline__ Slot<E, kVec> load_slot(const E* p, int n) {
    if constexpr (kVec) {
        return *reinterpret_cast<const Slot<E, kVec>*>(p);
    } else {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = u < n ? to_float(p[u]) : 0.0f;
        return make_float4(v[0], v[1], v[2], v[3]);
    }
}
__device__ __forceinline__ void unpack(const float4& q, float (&v)[4]) {
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void unpack(const uint2& q, float (&v)[4]) {
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}

template <bool kVec>
__device__ __forceinline__ void store4(float* p, int n, const float (&v)[4]) {
    if constexpr (kVec) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (u < n) p[u] = v[u];
    }
}
template <bool kVec>
__device__ __forceinline__ void store4(__nv_bfloat16* p, int n, const float (&v)[4]) {
    if constexpr (kVec) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
        uint2 q;
        q.x = *reinterpret_cast<const uint32_t*>(&lo);
        q.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(p) = q;
    } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (u < n) p[u] = __float2bfloat16_rn(v[u]);
    }
}
template <bool kVec>
__device__ __forceinline__ void store4(int* p, int n, const int (&v)[4]) {
    if constexpr (kVec) {
        *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (u < n) p[u] = v[u];
    }
}

constexpr int kFwdThreads = 128;
constexpr int kMaxGroups = 32;  // channel groups of 4 a block: 128 channels
// conv rows of a thread's 4 channels in flight, 128 bytes in fp32 and 64 in
// bf16: fewer left the loads short of the card's rate at the occupancy
// the registers allow, GELU or no GELU, so a short pool gives a thread
// several pooled cells
constexpr int kSlots = 8;

// The folded BN, erf-GELU, dropout and first-max pool of one conv row of
// a thread's 4 channels (row j of the window of pooled row `to`); the last
// row of a window stores the pooled values and codes.
template <typename E, bool kVec>
struct Cell {
    float sc[4], sh[4];
    float keep_scale;
    uint32_t threshold, k0, k1;
    bool drop;
    int n, pool;
    float m[4];
    int cd[4];

    __device__ __forceinline__ void row(const Slot<E, kVec>& slot, int e, int j) {
        float x[4];
        unpack(slot, x);
        uint4 w0 = make_uint4(0u, 0u, 0u, 0u), w1 = w0;
        if (drop) {
            w0 = philox4x32_10(static_cast<uint32_t>(e) >> 2, k0, k1);
            // a scalar group may straddle two counters
            if (!kVec && (e & 3) + n > 4)
                w1 = philox4x32_10((static_cast<uint32_t>(e) >> 2) + 1u, k0, k1);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int i = kVec ? u : (e & 3) + u;
            const uint32_t bits = kVec ? word(w0, u) : i < 4 ? word(w0, i) : word(w1, i - 4);
            stem_pool_row(x[u], sc[u], sh[u], !drop || bits >= threshold, keep_scale, j, pool,
                          m[u], cd[u]);
        }
    }
};

// Grid: x = row tile * group_tiles + channel-group tile, y = batch row,
// z = model. Block: gx channel groups (a power of two) by kFwdThreads / gx
// = ry thread rows; thread (tx, ty) owns channels 4 (g0 + tx) .. + 3 of
// `cells` pooled rows to0 + c ry of its batch row (c < cells), whose
// window rows it loads, kSlots of them, before the block folds its
// per-channel values; a pool longer than kSlots streams the rest of its
// window kSlots rows at a time (cells = 1).
template <typename E, bool kVec>
__global__ void __launch_bounds__(kFwdThreads)
stem_tail_fwd_kernel(const E* __restrict__ conv,       // (S, B, T, C)
                     const float* __restrict__ gamma,  // (S, C)
                     const float* __restrict__ beta,   // (S, C)
                     const float* __restrict__ mean,   // (S, C)
                     const float* __restrict__ var,    // (S, C)
                     float eps, float keep_scale, uint32_t threshold,
                     const long long* __restrict__ seeds,  // (S,)
                     E* __restrict__ out,                  // (S, B, t_out, C)
                     int* __restrict__ code,               // (S, B, t_out, C) or null
                     int B, int T, int C, int pool, int t_out, int gx, int group_tiles,
                     int cells, int c_full, int c_off) {
    __shared__ float s_scale[4 * kMaxGroups], s_shift[4 * kMaxGroups];
    const int s = blockIdx.z, b = blockIdx.y;
    const int ry = kFwdThreads / gx;
    const int c_block = (blockIdx.x % group_tiles) * gx * 4;
    const int to0 = (blockIdx.x / group_tiles) * ry * cells + threadIdx.x / gx;
    const int cl = 4 * (threadIdx.x % gx);  // the thread's first channel within the block's
    const int c0 = c_block + cl;
    const bool live = c0 < C;
    const int n = kVec ? 4 : max(0, min(4, C - c0));  // channels of this group
    const E* src = conv + static_cast<size_t>(s) * B * T * C;
    const size_t model_out = static_cast<size_t>(s) * B * t_out * C;
    const int first = min(pool * cells, kSlots);  // rows loaded before the fold

    // the first rows' loads, in flight across the fold below
    Slot<E, kVec> slot[kSlots];
    {
        int c = 0, j = 0;
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
            const int to = to0 + c * ry;
            if (i < first && live && to < t_out)
                slot[i] = load_slot<E, kVec>(src + (b * T + to * pool + j) * C + c0, n);
            if (++j == pool) j = 0, ++c;
        }
    }
    if (threadIdx.x < 4 * gx && c_block + static_cast<int>(threadIdx.x) < C) {
        const int pc = s * C + c_block + threadIdx.x;
        const float sc = gamma[pc] * rsqrtf(var[pc] + eps);
        s_scale[threadIdx.x] = sc;
        s_shift[threadIdx.x] = beta[pc] - mean[pc] * sc;
    }
    __syncthreads();
    if (!live) return;

    Cell<E, kVec> cell;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        cell.sc[u] = u < n ? s_scale[cl + u] : 0.0f;
        cell.sh[u] = u < n ? s_shift[cl + u] : 0.0f;
    }
    cell.keep_scale = keep_scale;
    cell.threshold = threshold;
    cell.drop = threshold != 0u;
    cell.k0 = cell.k1 = 0u;
    if (cell.drop) {
        const uint64_t seed = static_cast<uint64_t>(seeds[s]);
        cell.k0 = static_cast<uint32_t>(seed);
        cell.k1 = static_cast<uint32_t>(seed >> 32);
    }
    cell.n = n;
    cell.pool = pool;
    auto finish = [&](int to) {
        const size_t o = model_out + (b * t_out + to) * C + c0;
        store4<kVec>(out + o, n, cell.m);
        if (code) store4<kVec>(code + o, n, cell.cd);
    };
    {
        int c = 0, j = 0;
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
            const int to = to0 + c * ry;
            if (i < first && to < t_out) {
                const int e = (b * T + to * pool + j) * c_full + c_off + c0;
                cell.row(slot[i], e, j);
                if (j == pool - 1) finish(to);
            }
            if (++j == pool) j = 0, ++c;
        }
    }
    // a window longer than kSlots rows (cells == 1): the rest, kSlots at a time
    for (int j0 = kSlots; j0 < pool && to0 < t_out; j0 += kSlots) {
        const int a0 = (b * T + to0 * pool + j0) * C + c0;
        const int e0 = (b * T + to0 * pool + j0) * c_full + c_off + c0;
#pragma unroll
        for (int i = 0; i < kSlots; ++i)
            if (j0 + i < pool) slot[i] = load_slot<E, kVec>(src + a0 + i * C, n);
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
            if (j0 + i >= pool) break;
            cell.row(slot[i], e0 + i * c_full, j0 + i);
        }
        if (pool - j0 <= kSlots) finish(to0);
    }
}

// The backward. A thread owns 4 consecutive channels of its pooled cells,
// as the forward does; kPool is the pool (2 or 4, the LOSO step's stages)
// or 0 for any other pool, read at run time, one cell at a time.
constexpr int kBwdThreads = 128;
constexpr int kBwdWarps = kBwdThreads / 32;

template <bool kVec>
__device__ __forceinline__ void load_codes(const int* p, int n, int (&cd)[4]) {
    if constexpr (kVec) {
        const int4 q = *reinterpret_cast<const int4*>(p);
        cd[0] = q.x, cd[1] = q.y, cd[2] = q.z, cd[3] = q.w;
    } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) cd[u] = u < n ? p[u] : 0;
    }
}

// Grid: x = row tile * group_tiles + channel-group tile, y = batch row,
// z = model. Block: gx channel groups (a power of two) by kBwdThreads / gx
// = ry thread rows; the block owns pooled rows [rt tile_rows, (rt + 1)
// tile_rows) of its batch row, thread (tx, ty) the rows ty + ry k of them,
// kCells at a time: their codes, dpool and all kCells * pool window rows
// loaded before any is used. The last row tile also writes the zero tail
// rows T - t_out pool of dy. Partials: one per (model, chunk = b row_tiles +
// rt, channel), the thread rows folded by xor shuffles within a warp and
// across the block's warps through shared memory, in a fixed order.
template <typename E, bool kVec, int kPool>
__global__ void __launch_bounds__(kBwdThreads)
stem_tail_bwd_kernel(const E* __restrict__ conv,       // (S, B, T, C)
                     const E* __restrict__ dpool,      // (S, B, t_out, C)
                     const int* __restrict__ code,     // (S, B, t_out, C)
                     const float* __restrict__ scale,  // (S, C) gamma * inv
                     const float* __restrict__ shift,  // (S, C) beta - mean * scale
                     const float* __restrict__ mean,   // (S, C)
                     const float* __restrict__ inv,    // (S, C)
                     float keep_scale,
                     float* __restrict__ dy,       // (S, B, T, C)
                     float* __restrict__ dg_part,  // (S, B * row_tiles, C)
                     float* __restrict__ db_part,  // (S, B * row_tiles, C)
                     int B, int T, int C, int pool, int t_out, int gx, int group_tiles,
                     int tile_rows) {
    // pooled cells a thread has in flight: 8 window rows for pools 2 and 4
    constexpr int kCells = kPool ? kSlots / kPool : 1;
    constexpr int kWin = kPool ? kPool : kSlots;  // window rows loaded a cell and pass
    __shared__ float s_vals[4][4 * kMaxGroups];   // scale, shift, mean, inv
    __shared__ float s_red[2][kBwdWarps][4 * kMaxGroups];
    if constexpr (kPool) pool = kPool;
    const int s = blockIdx.z, b = blockIdx.y;
    const int ry = kBwdThreads / gx;
    const int rt = blockIdx.x / group_tiles;
    const int row_tiles = (t_out + tile_rows - 1) / tile_rows;
    const int c_block = (blockIdx.x % group_tiles) * gx * 4;
    const int tx = threadIdx.x % gx, ty = threadIdx.x / gx;
    const int cl = 4 * tx;  // the thread's first channel within the block's
    const int c0 = c_block + cl;
    const bool live = c0 < C;
    const int n = kVec ? 4 : max(0, min(4, C - c0));  // channels of this group
    const size_t model = static_cast<size_t>(s) * B;
    const E* x_src = conv + model * T * C;
    const E* dp_src = dpool + model * t_out * C;
    const int* cd_src = code + model * t_out * C;
    float* dst = dy + model * T * C;
    const int t_begin = rt * tile_rows, t_end = min(t_out, t_begin + tile_rows);

    if (threadIdx.x < 4 * gx && c_block + static_cast<int>(threadIdx.x) < C) {
        const int pc = s * C + c_block + threadIdx.x;
        s_vals[0][threadIdx.x] = scale[pc];
        s_vals[1][threadIdx.x] = shift[pc];
        s_vals[2][threadIdx.x] = mean[pc];
        s_vals[3][threadIdx.x] = inv[pc];
    }
    __syncthreads();
    float sc[4], sh[4], mu[4], iv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        const bool in = live && u < n;
        sc[u] = in ? s_vals[0][cl + u] : 0.0f;
        sh[u] = in ? s_vals[1][cl + u] : 0.0f;
        mu[u] = in ? s_vals[2][cl + u] : 0.0f;
        iv[u] = in ? s_vals[3][cl + u] : 0.0f;
    }

    float sg[4] = {0.0f, 0.0f, 0.0f, 0.0f}, sb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int to0 = t_begin + ty; live && to0 < t_end; to0 += ry * kCells) {
        Slot<E, kVec> dps[kCells], xs[kCells][kWin];
        int cds[kCells][4];
#pragma unroll
        for (int i = 0; i < kCells; ++i) {
            const int to = to0 + i * ry;
            if (to < t_end) {
                const int o = (b * t_out + to) * C + c0;
                dps[i] = load_slot<E, kVec>(dp_src + o, n);
                load_codes<kVec>(cd_src + o, n, cds[i]);
                const int x0 = (b * T + to * pool) * C + c0;
#pragma unroll
                for (int j = 0; j < kWin; ++j)
                    if (kPool || j < pool) xs[i][j] = load_slot<E, kVec>(x_src + x0 + j * C, n);
            }
        }
#pragma unroll
        for (int i = 0; i < kCells; ++i) {
            const int to = to0 + i * ry;
            if (to >= t_end) break;
            int jw[4];
            float xw[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dp[4], g[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) jw[u] = cds[i][u] >= pool ? cds[i][u] - pool : cds[i][u];
            auto select = [&](const Slot<E, kVec>(&rows)[kWin], int j0) {
#pragma unroll
                for (int j = 0; j < kWin; ++j) {
                    if (!kPool && j0 + j >= pool) break;
                    float v[4];
                    unpack(rows[j], v);
#pragma unroll
                    for (int u = 0; u < 4; ++u) xw[u] = j0 + j == jw[u] ? v[u] : xw[u];
                }
            };
            select(xs[i], 0);
            const int x0 = (b * T + to * pool) * C + c0;
            // a window longer than kSlots rows (kPool 0): the rest, kSlots at a time
            for (int j0 = kWin; !kPool && j0 < pool; j0 += kWin) {
#pragma unroll
                for (int j = 0; j < kWin; ++j)
                    if (j0 + j < pool) xs[i][j] = load_slot<E, kVec>(x_src + x0 + (j0 + j) * C, n);
                select(xs[i], j0);
            }
            unpack(dps[i], dp);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const float y = fmaf(xw[u], sc[u], sh[u]);
                g[u] = cds[i][u] >= pool ? dp[u] * gelu_erf_grad(y) * keep_scale : 0.0f;
                sg[u] = fmaf(g[u], (xw[u] - mu[u]) * iv[u], sg[u]);
                sb[u] += g[u];
            }
            // dy over the window: g at the winner's row, 0 elsewhere
#pragma unroll
            for (int j = 0; j < kWin; ++j) {
                if (!kPool && j >= pool) break;
                float v[4];
#pragma unroll
                for (int u = 0; u < 4; ++u) v[u] = j == jw[u] ? g[u] : 0.0f;
                store4<kVec>(dst + x0 + j * C, n, v);
            }
            for (int j = kWin; !kPool && j < pool; ++j) {
                float v[4];
#pragma unroll
                for (int u = 0; u < 4; ++u) v[u] = j == jw[u] ? g[u] : 0.0f;
                store4<kVec>(dst + x0 + j * C, n, v);
            }
        }
    }
    // the rows past the last window (T not a multiple of pool) get no gradient
    if (live && rt == row_tiles - 1) {
        const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int r = t_out * pool + ty; r < T; r += ry) store4<kVec>(dst + (b * T + r) * C + c0, n, zero);
    }

    // the partials: thread rows of a warp by xor shuffles (lanes tx + gx k
    // hold one channel group), then the warps through shared memory, in order
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        for (int off = 16; off >= gx; off >>= 1) {
            sg[u] += __shfl_xor_sync(0xffffffffu, sg[u], off);
            sb[u] += __shfl_xor_sync(0xffffffffu, sb[u], off);
        }
    }
    if (lane < gx) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            s_red[0][warp][cl + u] = sg[u];
            s_red[1][warp][cl + u] = sb[u];
        }
    }
    __syncthreads();
    const int c = c_block + threadIdx.x;
    if (threadIdx.x < 4 * gx && c < C) {
        // warps that hold no thread row of this group hold zeros
        const int warps = min(kBwdWarps, (ry * gx + 31) / 32);
        float tg = 0.0f, tb = 0.0f;
        for (int w = 0; w < warps; ++w) {
            tg += s_red[0][w][threadIdx.x];
            tb += s_red[1][w][threadIdx.x];
        }
        const size_t at = (model + b) * row_tiles + rt;  // (s, b, rt) chunk
        dg_part[at * C + c] = tg;
        db_part[at * C + c] = tb;
    }
}

template <typename E>
int launch_fwd(const E* conv, const float* gamma, const float* beta, const float* mean,
               const float* var, float eps, float keep_scale, unsigned int threshold,
               const long long* seeds, E* out, int* code, int S, int B, int T, int C, int pool,
               int c_full, int c_off, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const int t_out = T / pool;
    const int groups = (C + 3) / 4;
    int gx = 1;
    while (gx < groups && gx < kMaxGroups) gx *= 2;
    const int group_tiles = (groups + gx - 1) / gx;
    const int cells = pool >= kSlots ? 1 : kSlots / pool;  // pooled rows a thread
    const int rows = kFwdThreads / gx * cells;             // pooled rows a block
    const dim3 grid(group_tiles * ((t_out + rows - 1) / rows), B, S);
    // 16-byte (bf16: 8-byte) accesses need C % 4 == 0 and aligned tensors
    const uintptr_t align = 4 * sizeof(E) - 1;
    const bool vec = C % 4 == 0 && !(reinterpret_cast<uintptr_t>(conv) & align) &&
                     !(reinterpret_cast<uintptr_t>(out) & align) &&
                     !(reinterpret_cast<uintptr_t>(code) & 15);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vec)
        stem_tail_fwd_kernel<E, true><<<grid, kFwdThreads, 0, st>>>(
            conv, gamma, beta, mean, var, eps, keep_scale, threshold, seeds, out, code, B, T, C,
            pool, t_out, gx, group_tiles, cells, c_full, c_off);
    else
        stem_tail_fwd_kernel<E, false><<<grid, kFwdThreads, 0, st>>>(
            conv, gamma, beta, mean, var, eps, keep_scale, threshold, seeds, out, code, B, T, C,
            pool, t_out, gx, group_tiles, cells, c_full, c_off);
    return cudaGetLastError();
}

template <typename E, bool kVec>
cudaError_t launch_bwd_form(dim3 grid, cudaStream_t st, const E* conv, const E* dpool,
                            const int* code, const float* scale, const float* shift,
                            const float* mean, const float* inv, float keep_scale, float* dy,
                            float* dg_part, float* db_part, int B, int T, int C, int pool,
                            int t_out, int gx, int group_tiles, int tile_rows) {
    auto run = [&](auto kernel) {
        kernel<<<grid, kBwdThreads, 0, st>>>(conv, dpool, code, scale, shift, mean, inv,
                                             keep_scale, dy, dg_part, db_part, B, T, C, pool,
                                             t_out, gx, group_tiles, tile_rows);
        return cudaGetLastError();
    };
    if (pool == 2) return run(stem_tail_bwd_kernel<E, kVec, 2>);
    if (pool == 4) return run(stem_tail_bwd_kernel<E, kVec, 4>);
    return run(stem_tail_bwd_kernel<E, kVec, 0>);
}

// tile_rows: pooled rows a block, chosen by the wrapper
// (kernels/conv_stem_train.py::bwd_tile_rows); the partials have B
// ceil(t_out / tile_rows) chunks a model
template <typename E>
int launch_bwd(const E* conv, const E* dpool, const int* code, const float* scale,
               const float* shift, const float* mean, const float* inv, float keep_scale,
               float* dy, float* dg_part, float* db_part, int S, int B, int T, int C, int pool,
               int tile_rows, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const int t_out = T / pool;
    const int groups = (C + 3) / 4;
    int gx = 1;
    while (gx < groups && gx < kMaxGroups) gx *= 2;
    const int group_tiles = (groups + gx - 1) / gx;
    const int row_tiles = (t_out + tile_rows - 1) / tile_rows;
    const dim3 grid(group_tiles * row_tiles, B, S);
    // 16-byte (bf16: 8-byte) accesses need C % 4 == 0 and aligned tensors
    const uintptr_t align = 4 * sizeof(E) - 1;
    const bool vec = C % 4 == 0 && !(reinterpret_cast<uintptr_t>(conv) & align) &&
                     !(reinterpret_cast<uintptr_t>(dpool) & align) &&
                     !(reinterpret_cast<uintptr_t>(code) & 15) &&
                     !(reinterpret_cast<uintptr_t>(dy) & 15);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vec)
        return launch_bwd_form<E, true>(grid, st, conv, dpool, code, scale, shift, mean, inv,
                                        keep_scale, dy, dg_part, db_part, B, T, C, pool, t_out,
                                        gx, group_tiles, tile_rows);
    return launch_bwd_form<E, false>(grid, st, conv, dpool, code, scale, shift, mean, inv,
                                     keep_scale, dy, dg_part, db_part, B, T, C, pool, t_out, gx,
                                     group_tiles, tile_rows);
}

}  // namespace

using bf16 = __nv_bfloat16;

extern "C" int msa_stem_tail(const float* conv, const float* gamma, const float* beta,
                             const float* mean, const float* var, float eps, float keep_scale,
                             unsigned int threshold, const long long* seeds, float* out,
                             int* code, int S, int B, int T, int C, int pool, int c_full,
                             int c_off, int device, void* stream) {
    return launch_fwd(conv, gamma, beta, mean, var, eps, keep_scale, threshold, seeds, out, code,
                      S, B, T, C, pool, c_full, c_off, device, stream);
}

extern "C" int msa_stem_tail_bf16(const bf16* conv, const float* gamma, const float* beta,
                                  const float* mean, const float* var, float eps,
                                  float keep_scale, unsigned int threshold,
                                  const long long* seeds, bf16* out, int* code, int S, int B,
                                  int T, int C, int pool, int c_full, int c_off, int device,
                                  void* stream) {
    return launch_fwd(conv, gamma, beta, mean, var, eps, keep_scale, threshold, seeds, out, code,
                      S, B, T, C, pool, c_full, c_off, device, stream);
}

extern "C" int msa_stem_tail_bwd(const float* conv, const float* dpool, const int* code,
                                 const float* scale, const float* shift, const float* mean,
                                 const float* inv, float keep_scale, float* dy, float* dg_part,
                                 float* db_part, int S, int B, int T, int C, int pool,
                                 int tile_rows, int device, void* stream) {
    return launch_bwd(conv, dpool, code, scale, shift, mean, inv, keep_scale, dy, dg_part,
                      db_part, S, B, T, C, pool, tile_rows, device, stream);
}

extern "C" int msa_stem_tail_bwd_bf16(const bf16* conv, const bf16* dpool, const int* code,
                                      const float* scale, const float* shift, const float* mean,
                                      const float* inv, float keep_scale, float* dy,
                                      float* dg_part, float* db_part, int S, int B, int T, int C,
                                      int pool, int tile_rows, int device, void* stream) {
    return launch_bwd(conv, dpool, code, scale, shift, mean, inv, keep_scale, dy, dg_part,
                      db_part, S, B, T, C, pool, tile_rows, device, stream);
}
