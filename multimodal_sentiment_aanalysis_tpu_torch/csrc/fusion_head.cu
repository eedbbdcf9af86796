// The ME-MHACL fusion and classification head in one pass, fp32, forward
// only.
//
// Replaces multimodal_sentiment_aanalysis_tpu/kernels/fusion_head.py::_kernel:
// the three modality embeddings (B, F) as a length-3 sequence; Q, K and V
// projections (the packed in_proj of nn.MultiheadAttention); per head a 3x3
// softmax of q_i . k_j / sqrt(F / H); the out projection; the mean over the
// three modalities; the shared Linear + ReLU and the two heads. Nothing
// between the embeddings and the logits reaches device memory.
//
// What bounds it on the H100: at the reference batch (B = 32, F = 256, 8
// heads, hidden 128, 2 classes) it is ~52 MFLOP over ~1.1 MB, mostly the
// weights, so its bound is ~1 us and the launch and the dependent phases
// dominate. One block owns one batch row: its 3 embedding rows sit in shared
// memory and each projection walks its weights from L2 once per block, 8
// lanes for every 4 output columns (coalesced 16-byte loads of the weight
// rows, each activation vector read once for the 4 columns), so a batch of
// B has B blocks in flight. One warp computes the 3x3 softmax of one (query
// modality, head), lanes over the head's entries. Every stage writes over a
// shared buffer the previous stage has finished with:
//   xs (3, F): embeddings -> attention output -> modality mean -> logits
//   ys (3, 3F): q|k|v -> out projection -> shared layer
// so the block needs 48 F bytes (12 KB at F = 256).

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Y[r * ystride + c] = act(bias[c] + sum_k X[r * in + k] W[c * in + k]) for
// r < ROWS, c < out. in % 4 == 0; X in shared memory, W and bias in global.
// kLanes lanes share kCols output columns: each lane reads its share of the
// columns' weight rows as 16-byte vectors (kLanes x 16 contiguous bytes per
// row and load), reads each activation vector once for all kCols columns,
// and keeps kCols x ROWS partial sums; a 3-step butterfly of shuffles adds
// them up. Every thread runs the same number of passes, so the shuffles
// always see the whole warp.
constexpr int kLanes = 8;
constexpr int kCols = 4;

template <int ROWS, bool RELU>
__device__ void block_linear(const float* __restrict__ W, const float* __restrict__ bias,
                             const float* X, int in, int out, float* Y, int ystride) {
    // weight vectors in flight per lane and column: the weights stream from
    // L2 at the rate of loads in flight
    constexpr int kDepth = 4;
    const float4* X4 = reinterpret_cast<const float4*>(X);
    const int in4 = in / 4;
    const int sub = threadIdx.x % kLanes;
    const int group = threadIdx.x / kLanes;
    const int groups = blockDim.x / kLanes;
    for (int c0 = 0; c0 < out; c0 += groups * kCols) {
        const float4* w4[kCols];
        bool live[kCols];
#pragma unroll
        for (int g = 0; g < kCols; ++g) {
            const int c = c0 + group + g * groups;
            live[g] = c < out;
            w4[g] = reinterpret_cast<const float4*>(W + static_cast<size_t>(live[g] ? c : 0) * in);
        }
        float acc[kCols][ROWS];
#pragma unroll
        for (int g = 0; g < kCols; ++g)
#pragma unroll
            for (int r = 0; r < ROWS; ++r) acc[g][r] = 0.0f;
        for (int kq0 = sub; kq0 < in4; kq0 += kLanes * kDepth) {
            float4 w[kDepth][kCols];  // all of a step's loads in flight before any use
#pragma unroll
            for (int u = 0; u < kDepth; ++u) {
                const int kq = kq0 + u * kLanes;
#pragma unroll
                for (int g = 0; g < kCols; ++g)
                    w[u][g] = live[g] && kq < in4 ? __ldg(w4[g] + kq)
                                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
#pragma unroll
            for (int u = 0; u < kDepth; ++u) {
                const int kq = kq0 + u * kLanes;
                if (kq >= in4) break;
#pragma unroll
                for (int r = 0; r < ROWS; ++r) {
                    const float4 x = X4[r * in4 + kq];
#pragma unroll
                    for (int g = 0; g < kCols; ++g) {
                        acc[g][r] = fmaf(x.x, w[u][g].x, acc[g][r]);
                        acc[g][r] = fmaf(x.y, w[u][g].y, acc[g][r]);
                        acc[g][r] = fmaf(x.z, w[u][g].z, acc[g][r]);
                        acc[g][r] = fmaf(x.w, w[u][g].w, acc[g][r]);
                    }
                }
            }
        }
#pragma unroll
        for (int g = 0; g < kCols; ++g) {
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
#pragma unroll
                for (int off = kLanes / 2; off > 0; off >>= 1)
                    acc[g][r] += __shfl_xor_sync(0xffffffffu, acc[g][r], off);
            }
            const int c = c0 + group + g * groups;
            if (live[g]) {
                const float b = bias[c];
#pragma unroll
                for (int r = 0; r < ROWS; ++r) {
                    if (r % kLanes == sub) {
                        const float y = acc[g][r] + b;
                        Y[r * ystride + c] = RELU ? fmaxf(y, 0.0f) : y;
                    }
                }
            }
        }
    }
}

__global__ void __launch_bounds__(kThreads)
fusion_head_kernel(const float* __restrict__ xe, const float* __restrict__ xy,
                   const float* __restrict__ xp,
                   const float* __restrict__ w_in, const float* __restrict__ b_in,    // (3F, F), (3F,)
                   const float* __restrict__ w_out, const float* __restrict__ b_out,  // (F, F), (F,)
                   const float* __restrict__ w_sh, const float* __restrict__ b_sh,    // (Hd, F), (Hd,)
                   const float* __restrict__ w_a, const float* __restrict__ b_a,      // (C, Hd), (C,)
                   const float* __restrict__ w_v, const float* __restrict__ b_v,      // (C, Hd), (C,)
                   float* __restrict__ oa, float* __restrict__ ov,                    // (B, C)
                   int F, int H, int hidden, int ncls) {
    extern __shared__ float4 smem4[];
    float* xs = reinterpret_cast<float*>(smem4);  // (3, F): row m = modality m
    float* ys = xs + 3 * F;                       // (3, 3F)
    const size_t row = blockIdx.x;

    // 1. the row's three embeddings
    for (int e = threadIdx.x; e < 3 * F; e += blockDim.x) {
        const int m = e / F, c = e % F;
        const float* x = m == 0 ? xe : (m == 1 ? xy : xp);
        xs[e] = x[row * F + c];
    }
    __syncthreads();

    // 2. q | k | v of the three modalities
    block_linear<3, false>(w_in, b_in, xs, F, 3 * F, ys, 3 * F);
    __syncthreads();

    // 3. per (query modality, head), one warp: lanes over the head's
    // entries, the three scores by shuffle sums, the 3x3 softmax, p . v
    const int dh = F / H;
    const float scale = 1.0f / sqrtf(static_cast<float>(dh));
    const int lane = threadIdx.x % 32;
    for (int task = threadIdx.x / 32; task < 3 * H; task += blockDim.x / 32) {
        const int i = task / H, h = task % H;
        const float* qi = ys + i * 3 * F + h * dh;
        float s[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const float* kj = ys + j * 3 * F + F + h * dh;
            float acc = 0.0f;
            for (int d = lane; d < dh; d += 32) acc = fmaf(qi[d], kj[d], acc);
            s[j] = warp_sum(acc) * scale;
        }
        const float m = fmaxf(fmaxf(s[0], s[1]), s[2]);
        float e[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) e[j] = expf(s[j] - m);
        const float den = e[0] + e[1] + e[2];
        const float p0 = e[0] / den, p1 = e[1] / den, p2 = e[2] / den;
        const float* v0 = ys + 0 * 3 * F + 2 * F + h * dh;
        const float* v1 = ys + 1 * 3 * F + 2 * F + h * dh;
        const float* v2 = ys + 2 * 3 * F + 2 * F + h * dh;
        float* out = xs + i * F + h * dh;
        for (int d = lane; d < dh; d += 32) out[d] = p0 * v0[d] + p1 * v1[d] + p2 * v2[d];
    }
    __syncthreads();

    // 4. out projection of the three modalities
    block_linear<3, false>(w_out, b_out, xs, F, F, ys, F);
    __syncthreads();

    // 5. mean over the three modalities
    for (int e = threadIdx.x; e < F; e += blockDim.x)
        xs[e] = (ys[e] + ys[F + e] + ys[2 * F + e]) / 3.0f;
    __syncthreads();

    // 6. shared Linear + ReLU, then the two heads
    block_linear<1, true>(w_sh, b_sh, xs, F, hidden, ys, hidden);
    __syncthreads();
    block_linear<1, false>(w_a, b_a, ys, hidden, ncls, xs, ncls);
    block_linear<1, false>(w_v, b_v, ys, hidden, ncls, xs + ncls, ncls);
    __syncthreads();
    for (int e = threadIdx.x; e < ncls; e += blockDim.x) {
        oa[row * ncls + e] = xs[e];
        ov[row * ncls + e] = xs[ncls + e];
    }
}

}  // namespace

// F % H == 0, F % 4 == 0, hidden % 4 == 0, hidden <= 9 F and 2 ncls <= 3 F
// (the wrapper checks).
extern "C" int msa_fusion_head(const float* xe, const float* xy, const float* xp,
                               const float* w_in, const float* b_in, const float* w_out,
                               const float* b_out, const float* w_sh, const float* b_sh,
                               const float* w_a, const float* b_a, const float* w_v,
                               const float* b_v, float* oa, float* ov, int B, int F, int H,
                               int hidden, int ncls, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const size_t smem = sizeof(float) * 12 * F;
    err = allow_dynamic_smem(fusion_head_kernel, smem);
    if (err != cudaSuccess) return err;
    fusion_head_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        xe, xy, xp, w_in, b_in, w_out, b_out, w_sh, b_sh, w_a, b_a, w_v, b_v, oa, ov, F, H,
        hidden, ncls);
    return cudaGetLastError();
}
