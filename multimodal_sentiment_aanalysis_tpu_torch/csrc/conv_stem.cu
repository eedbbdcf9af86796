// Serving conv stem stage: Conv1d + folded BatchNorm + erf-GELU + MaxPool in
// one kernel, so the conv output never reaches device memory.
//
// Replaces multimodal_sentiment_aanalysis_tpu/kernels/conv_stem.py::_stage_kernel
// (reached from eval/serving.py when use_pallas=True). There the conv ran as
// K shifted (T, C) x (C, O) matmuls on the MXU; here it is a direct conv over
// K taps x C input channels in the kernel body, in fp32 on the CUDA cores.
//
// What bounds it on the H100, at B=64: stage 1 (C=32 -> O=64, K=15, T=585,
// pool 4) is 2.3 GFLOP against 2.4 MB in and 2.4 MB out; stage 2 (C=64 ->
// O=256, K=5, T=146, pool 2) is 1.5 GFLOP against 2.4 MB in and 4.8 MB out.
// Both are compute-heavy for their bytes, so what counts is how many loads
// each FMA costs.
//
// Design: a block owns one batch row, kOT=32 output channels (one per lane)
// and kTY*R consecutive conv positions; its input window (plus the K-1 halo,
// zero-padded at the edges) is staged once in shared memory. Each thread
// keeps R <= 8 conv positions of one output channel in registers, so every
// weight load (coalesced across the warp from the (K, C, O) transposed
// weight, and shared by the block's warps through L1) feeds R FMAs, and the
// input values are shared-memory broadcasts. The epilogue applies the folded
// scale/shift, GELU and the pool max in registers and writes only the pooled
// rows. Tensor-core (TF32 or bf16 wgmma) tiling is later work.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kOT = 32;   // output channels per block (threadIdx.x)
constexpr int kTY = 8;    // thread rows per block (threadIdx.y)
constexpr int kMaxR = 8;  // conv positions per thread

__global__ void conv_stem_kernel(const float* __restrict__ x,      // (B, T, C)
                                 const float* __restrict__ w_t,    // (K, C, O)
                                 const float* __restrict__ scale,  // (O,)
                                 const float* __restrict__ shift,  // (O,)
                                 float* __restrict__ out,          // (B, t_out, O)
                                 int T, int C, int O, int K, int pad, int pool, int t_out,
                                 int P) {
    extern __shared__ float xs[];  // (kTY * R + K - 1, C) input window
    const int R = P * pool;        // conv positions per thread
    const int b = blockIdx.z;
    const int o = blockIdx.y * kOT + threadIdx.x;
    const int to0 = blockIdx.x * kTY * P;
    const int rows = kTY * R + K - 1;
    const int t_start = to0 * pool - pad;
    const int tid = threadIdx.y * kOT + threadIdx.x;

    for (int idx = tid; idx < rows * C; idx += kOT * kTY) {
        const int r = idx / C;
        const int t = t_start + r;
        xs[idx] = (t >= 0 && t < T) ? x[(static_cast<size_t>(b) * T + t) * C + (idx - r * C)] : 0.0f;
    }
    __syncthreads();
    if (o >= O) return;

    float acc[kMaxR];
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) acc[r] = 0.0f;
    const int rbase = threadIdx.y * R;
    for (int k = 0; k < K; ++k) {
        const float* xk = xs + (rbase + k) * C;
        const float* wk = w_t + static_cast<size_t>(k) * C * O + o;
        for (int c = 0; c < C; ++c) {
            const float w = wk[static_cast<size_t>(c) * O];
#pragma unroll
            for (int r = 0; r < kMaxR; ++r)
                if (r < R) acc[r] = fmaf(xk[r * C + c], w, acc[r]);
        }
    }

    const float sc = scale[o], sh = shift[o];
    for (int p = 0; p < P; ++p) {
        const int to = to0 + threadIdx.y * P + p;
        if (to >= t_out) break;
        float m = -INFINITY;
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) {
            if (r >= p * pool && r < (p + 1) * pool) {
                const float a = gelu_erf(fmaf(acc[r], sc, sh));
                if (r == p * pool || a > m) m = a;
            }
        }
        out[(static_cast<size_t>(b) * t_out + to) * O + o] = m;
    }
}

}  // namespace

extern "C" int msa_conv_stem(const float* x, const float* w_t, const float* scale,
                             const float* shift, float* out, int B, int T, int C, int O,
                             int K, int pad, int pool, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const int t_out = (T + 2 * pad - K + 1) / pool;
    const int P = kMaxR / pool;  // pooled outputs per thread; the wrapper keeps pool <= kMaxR
    const size_t smem = sizeof(float) * static_cast<size_t>(kTY * P * pool + K - 1) * C;
    err = allow_dynamic_smem(conv_stem_kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((t_out + kTY * P - 1) / (kTY * P), (O + kOT - 1) / kOT, B);
    const dim3 block(kOT, kTY);
    conv_stem_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
        x, w_t, scale, shift, out, T, C, O, K, pad, pool, t_out, P);
    return cudaGetLastError();
}
