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
//   stream in numpy).
//
// Backward: one thread per pooled cell reads the code, re-reads the
// winner's conv value, applies ONE gelu_grad, scales kept cells by 1/(1-p),
// writes dy over the covered rows (B, t_out * pool, C) and accumulates
// g * xhat and g per channel. Per-block partial sums of dgamma and dbeta
// are reduced in a fixed order inside the block and written per (model, row
// chunk); the wrapper sums the chunks in a second pass (deterministic, no
// atomics). The grid's z axis is the model. It reads the BN values as
// scale and shift from the wrapper. The BN input-gradient combine stays in
// torch, as it stays in XLA in JAX. What bounds it: bytes (it reads the
// codes, dpool and the winners and writes dy).
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
                     int cells) {
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
                const int e = (b * T + to * pool + j) * C + c0;
                cell.row(slot[i], e, j);
                if (j == pool - 1) finish(to);
            }
            if (++j == pool) j = 0, ++c;
        }
    }
    // a window longer than kSlots rows (cells == 1): the rest, kSlots at a time
    for (int j0 = kSlots; j0 < pool && to0 < t_out; j0 += kSlots) {
        const int e0 = (b * T + to0 * pool + j0) * C + c0;
#pragma unroll
        for (int i = 0; i < kSlots; ++i)
            if (j0 + i < pool) slot[i] = load_slot<E, kVec>(src + e0 + i * C, n);
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
            if (j0 + i >= pool) break;
            cell.row(slot[i], e0 + i * C, j0 + i);
        }
        if (pool - j0 <= kSlots) finish(to0);
    }
}

constexpr int kCh = 32;       // channels per block (threadIdx.x)
constexpr int kRowLanes = 8;  // pooled rows in flight per block (threadIdx.y)

template <typename E>
__global__ void stem_tail_bwd_kernel(const E* __restrict__ conv,       // (S, B, T, C)
                                     const E* __restrict__ dpool,      // (S, B, t_out, C)
                                     const int* __restrict__ code,     // (S, B, t_out, C)
                                     const float* __restrict__ scale,  // (S, C) gamma * inv
                                     const float* __restrict__ shift,  // (S, C) beta - mean * scale
                                     const float* __restrict__ mean,   // (S, C)
                                     const float* __restrict__ inv,    // (S, C)
                                     float keep_scale,
                                     float* __restrict__ dy,       // (S, B, t_out * pool, C)
                                     float* __restrict__ dg_part,  // (S, chunks, C)
                                     float* __restrict__ db_part,  // (S, chunks, C)
                                     int B, int T, int C, int pool, int t_out,
                                     int rows_per_chunk) {
    __shared__ float red_g[kRowLanes][kCh];
    __shared__ float red_b[kRowLanes][kCh];
    const size_t model = blockIdx.z;
    conv += model * B * T * C;
    dpool += model * B * t_out * C;
    code += model * B * t_out * C;
    scale += model * C;
    shift += model * C;
    mean += model * C;
    inv += model * C;
    dy += model * B * t_out * pool * C;
    dg_part += model * gridDim.y * C;
    db_part += model * gridDim.y * C;
    const int c = blockIdx.x * kCh + threadIdx.x;
    const int rows = B * t_out;
    const int r0 = blockIdx.y * rows_per_chunk;
    const int r1 = min(r0 + rows_per_chunk, rows);
    float sg = 0.0f, sb = 0.0f;
    if (c < C) {
        const float sc = scale[c], sh = shift[c], mu = mean[c], iv = inv[c];
        for (int r = r0 + threadIdx.y; r < r1; r += kRowLanes) {
            const int b = r / t_out;
            const int to = r - b * t_out;
            const size_t o = static_cast<size_t>(r) * C + c;
            const int cd = code[o];
            const int jw = cd % pool;
            const size_t xi = (static_cast<size_t>(b) * T + static_cast<size_t>(to) * pool + jw) * C + c;
            const float x = to_float(conv[xi]);
            float g = to_float(dpool[o]) * gelu_erf_grad(x * sc + sh);
            g = cd >= pool ? g * keep_scale : 0.0f;
            float* dst = dy + static_cast<size_t>(r) * pool * C + c;
            for (int j = 0; j < pool; ++j) dst[static_cast<size_t>(j) * C] = j == jw ? g : 0.0f;
            sg = fmaf(g, (x - mu) * iv, sg);
            sb += g;
        }
    }
    red_g[threadIdx.y][threadIdx.x] = sg;
    red_b[threadIdx.y][threadIdx.x] = sb;
    __syncthreads();
    if (threadIdx.y == 0 && c < C) {
        float tg = 0.0f, tb = 0.0f;
        for (int y = 0; y < kRowLanes; ++y) {  // fixed order: deterministic
            tg += red_g[y][threadIdx.x];
            tb += red_b[y][threadIdx.x];
        }
        dg_part[static_cast<size_t>(blockIdx.y) * C + c] = tg;
        db_part[static_cast<size_t>(blockIdx.y) * C + c] = tb;
    }
}

template <typename E>
int launch_fwd(const E* conv, const float* gamma, const float* beta, const float* mean,
               const float* var, float eps, float keep_scale, unsigned int threshold,
               const long long* seeds, E* out, int* code, int S, int B, int T, int C, int pool,
               int device, void* stream) {
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
            pool, t_out, gx, group_tiles, cells);
    else
        stem_tail_fwd_kernel<E, false><<<grid, kFwdThreads, 0, st>>>(
            conv, gamma, beta, mean, var, eps, keep_scale, threshold, seeds, out, code, B, T, C,
            pool, t_out, gx, group_tiles, cells);
    return cudaGetLastError();
}

template <typename E>
int launch_bwd(const E* conv, const E* dpool, const int* code, const float* scale,
               const float* shift, const float* mean, const float* inv, float keep_scale,
               float* dy, float* dg_part, float* db_part, int S, int B, int T, int C, int pool,
               int rows_per_chunk, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const int t_out = T / pool;
    const int chunks = (B * t_out + rows_per_chunk - 1) / rows_per_chunk;
    const dim3 grid((C + kCh - 1) / kCh, chunks, S);
    const dim3 block(kCh, kRowLanes);
    stem_tail_bwd_kernel<E><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        conv, dpool, code, scale, shift, mean, inv, keep_scale, dy, dg_part, db_part, B, T, C,
        pool, t_out, rows_per_chunk);
    return cudaGetLastError();
}

}  // namespace

using bf16 = __nv_bfloat16;

extern "C" int msa_stem_tail(const float* conv, const float* gamma, const float* beta,
                             const float* mean, const float* var, float eps, float keep_scale,
                             unsigned int threshold, const long long* seeds, float* out,
                             int* code, int S, int B, int T, int C, int pool, int device,
                             void* stream) {
    return launch_fwd(conv, gamma, beta, mean, var, eps, keep_scale, threshold, seeds, out, code,
                      S, B, T, C, pool, device, stream);
}

extern "C" int msa_stem_tail_bf16(const bf16* conv, const float* gamma, const float* beta,
                                  const float* mean, const float* var, float eps,
                                  float keep_scale, unsigned int threshold,
                                  const long long* seeds, bf16* out, int* code, int S, int B,
                                  int T, int C, int pool, int device, void* stream) {
    return launch_fwd(conv, gamma, beta, mean, var, eps, keep_scale, threshold, seeds, out, code,
                      S, B, T, C, pool, device, stream);
}

extern "C" int msa_stem_tail_bwd(const float* conv, const float* dpool, const int* code,
                                 const float* scale, const float* shift, const float* mean,
                                 const float* inv, float keep_scale, float* dy, float* dg_part,
                                 float* db_part, int S, int B, int T, int C, int pool,
                                 int rows_per_chunk, int device, void* stream) {
    return launch_bwd(conv, dpool, code, scale, shift, mean, inv, keep_scale, dy, dg_part,
                      db_part, S, B, T, C, pool, rows_per_chunk, device, stream);
}

extern "C" int msa_stem_tail_bwd_bf16(const bf16* conv, const bf16* dpool, const int* code,
                                      const float* scale, const float* shift, const float* mean,
                                      const float* inv, float keep_scale, float* dy,
                                      float* dg_part, float* db_part, int S, int B, int T, int C,
                                      int pool, int rows_per_chunk, int device, void* stream) {
    return launch_bwd(conv, dpool, code, scale, shift, mean, inv, keep_scale, dy, dg_part,
                      db_part, S, B, T, C, pool, rows_per_chunk, device, stream);
}
