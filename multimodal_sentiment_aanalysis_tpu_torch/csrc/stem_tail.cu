// EEG stem tail, eval forward: BatchNorm with running stats, erf-GELU and
// MaxPool in one pass over the conv output.
//
// Replaces multimodal_sentiment_aanalysis_tpu/kernels/conv_stem_train.py::_fwd_kernel
// at p=0 (the eval model forward calls it with the running stats). Dropout
// and the winner/keep routing code exist only for the backward and are not
// part of this kernel; the wrapper refuses p > 0.
//
// What bounds it on the H100: bytes. Stage 1 reads (64, 585, 64) fp32
// (9.6 MB) and writes (64, 146, 64) (2.4 MB); stage 2 reads (64, 146, 256)
// (9.6 MB) and writes (64, 73, 256) (4.8 MB). About 15 flops per element
// read, far below the card's ~20 flops per byte balance point.
//
// Design: one thread per pooled output (b, t_out, c), channels fastest, so a
// warp reads 32 consecutive floats of each pool row and writes 32
// consecutive outputs. The pre-pool activations never reach device memory.

#include <math.h>

#include "common.cuh"

namespace {

__global__ void stem_tail_kernel(const float* __restrict__ conv,  // (B, T, C)
                                 const float* __restrict__ gamma,
                                 const float* __restrict__ beta,
                                 const float* __restrict__ mean,
                                 const float* __restrict__ var, float eps,
                                 float* __restrict__ out,  // (B, t_out, C)
                                 int B, int T, int C, int pool, int t_out) {
    const size_t n = static_cast<size_t>(B) * t_out * C;
    const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
    for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        const int c = static_cast<int>(i % C);
        const size_t row = i / C;
        const int to = static_cast<int>(row % t_out);
        const int b = static_cast<int>(row / t_out);
        const float inv = rsqrtf(var[c] + eps);
        const float mu = mean[c], ga = gamma[c], be = beta[c];
        const float* src = conv + (static_cast<size_t>(b) * T + static_cast<size_t>(to) * pool) * C + c;
        float m = -INFINITY;
        for (int j = 0; j < pool; ++j) {
            const float a = gelu_erf((src[static_cast<size_t>(j) * C] - mu) * inv * ga + be);
            if (j == 0 || a > m) m = a;  // first max wins, as torch MaxPool1d
        }
        out[i] = m;
    }
}

}  // namespace

extern "C" int msa_stem_tail(const float* conv, const float* gamma, const float* beta,
                             const float* mean, const float* var, float eps, float* out,
                             int B, int T, int C, int pool, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const int t_out = T / pool;
    const size_t n = static_cast<size_t>(B) * t_out * C;
    const int threads = 256;
    const size_t want = (n + threads - 1) / threads;
    const int blocks = static_cast<int>(want < 8192 ? want : 8192);
    stem_tail_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        conv, gamma, beta, mean, var, eps, out, B, T, C, pool, t_out);
    return cudaGetLastError();
}
