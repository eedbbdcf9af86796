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
// keep probability 1 - p drawn from Philox4x32-10 keyed by one seed per
// model that the wrapper draws from a torch.Generator (read from device
// memory, so drawing it never syncs the host), and MaxPool(pool) routed to
// the first max, as torch MaxPool1d. No mask tensor exists: the keep bit of
// element (b, t, c) of model s is a pure function of (seed[s], flat index
// within the model). Besides the pooled output it can write one int32 code
// per pooled cell, winner index + pool * keep bit, which is all the backward
// needs.
//
// Backward: one thread per pooled cell reads the code, re-reads the
// winner's conv value, applies ONE gelu_grad, scales kept cells by 1/(1-p),
// writes dy over the covered rows (B, t_out * pool, C) and accumulates
// g * xhat and g per channel. Per-block partial sums of dgamma and dbeta
// are reduced in a fixed order inside the block and written per (model, row
// chunk); the wrapper sums the chunks in a second pass (deterministic, no
// atomics). The grid's z axis is the model.
// The BN input-gradient combine stays in torch, as it stays in XLA in JAX.
//
// Each entry point has an fp32 and a bf16 form (suffix _bf16), one template
// over the element type E of conv, the pooled output and dpool. The
// per-channel statistics and affine parameters, dy and the partials are
// fp32 in both, and so is the whole body, as the JAX kernels upcast their
// blocks; the bf16 form reads and writes half the bytes of the big tensors.
//
// What bounds it on the H100: bytes. Stage 1 (B=64, T=585, C=64, fp32)
// reads 9.6 MB and writes 2.4 MB + 2.4 MB of codes; stage 2 (T=146, C=256)
// reads 9.6 MB and writes 4.8 + 4.8 MB. The backward reads the codes,
// dpool and the winners and writes dy (9.6 / 9.5 MB). Philox adds ~40
// integer ops per element, still under the card's op/byte balance. The TPU's
// full-lane relayout was a Mosaic workaround and is not carried over: rows
// stay (B, T, C) with channels fastest, so a warp reads 32 consecutive
// floats of each row.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11): counter-based, so every element draws its bits independently.
__device__ __forceinline__ uint32_t philox_bits(uint64_t counter, uint64_t seed) {
    constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
    constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
    uint32_t x0 = static_cast<uint32_t>(counter), x1 = static_cast<uint32_t>(counter >> 32);
    uint32_t x2 = 0u, x3 = 0u;
    uint32_t k0 = static_cast<uint32_t>(seed), k1 = static_cast<uint32_t>(seed >> 32);
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
    return x0;
}

template <typename E>
__global__ void stem_tail_fwd_kernel(const E* __restrict__ conv,       // (S, B, T, C)
                                     const float* __restrict__ gamma,  // (S, C)
                                     const float* __restrict__ beta,   // (S, C)
                                     const float* __restrict__ mean,   // (S, C)
                                     const float* __restrict__ var,    // (S, C)
                                     float eps, float keep_scale, uint32_t threshold,
                                     const long long* __restrict__ seeds,  // (S,)
                                     E* __restrict__ out,       // (S, B, t_out, C)
                                     int* __restrict__ code,    // (S, B, t_out, C) or null
                                     int S, int B, int T, int C, int pool, int t_out) {
    const bool drop = threshold != 0u;
    const size_t n = static_cast<size_t>(S) * B * t_out * C;
    const size_t model_size = static_cast<size_t>(B) * T * C;
    const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
    for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        const int c = static_cast<int>(i % C);
        const size_t row = i / C;
        const int to = static_cast<int>(row % t_out);
        const size_t sb = row / t_out;  // model * B + batch row
        const size_t s = sb / B;
        const size_t pc = s * C + c;
        const float inv = rsqrtf(var[pc] + eps);
        const float mu = mean[pc], ga = gamma[pc], be = beta[pc];
        const uint64_t seed = drop ? static_cast<uint64_t>(seeds[s]) : 0ull;
        const size_t first = (sb * T + static_cast<size_t>(to) * pool) * C + c;
        float m = -INFINITY;
        int win = 0, kept = 1;
        for (int j = 0; j < pool; ++j) {
            const size_t e = first + static_cast<size_t>(j) * C;
            float a = gelu_erf((to_float(conv[e]) - mu) * inv * ga + be);
            int keep = 1;
            if (drop) {
                keep = philox_bits(e - s * model_size, seed) >= threshold;
                a = keep ? a * keep_scale : 0.0f;
            }
            if (j == 0 || a > m) {  // first max wins, as torch MaxPool1d
                m = a;
                win = j;
                kept = keep;
            }
        }
        out[i] = from_float<E>(m);
        if (code) code[i] = win + pool * kept;
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
    const size_t n = static_cast<size_t>(S) * B * t_out * C;
    const int threads = 256;
    const size_t want = (n + threads - 1) / threads;
    const int blocks = static_cast<int>(want < 8192 ? want : 8192);
    stem_tail_fwd_kernel<E><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        conv, gamma, beta, mean, var, eps, keep_scale, threshold, seeds, out, code, S, B, T, C,
        pool, t_out);
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
