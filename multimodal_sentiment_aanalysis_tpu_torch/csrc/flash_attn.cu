// Flash attention over (BH, T, D) fp32: the forward with its per-row
// log-sum-exp, and the two-kernel backward.
//
// Replaces multimodal_sentiment_aanalysis_tpu/kernels/attention.py:
// - msa_flash_fwd      -> _fwd_kernel: O = softmax(Q K^T) V by online softmax
//                         over key tiles (Q pre-scaled by 1/sqrt(D) in the
//                         wrapper, as the JAX entry does), LSE = m + log(l);
// - msa_flash_bwd_dq   -> _bwd_dq_kernel: dQ = sum_j dS_ij K_j with
//                         P = exp(S - LSE) recomputed and dS = P (dO V^T - delta);
// - msa_flash_bwd_dkv  -> _bwd_dkv_kernel: dV = P^T dO, dK = dS^T Q, by key tile.
// delta = rowsum(dO * O) is computed by the wrapper, as _flash_bwd does.
//
// The TPU kernels pad T to whole blocks and mask key columns >= tk with -1e30
// (and padded query rows in dK/dV with a where); here every loop stops at the
// last real row, which is the same masking without the padded copies.
//
// What bounds it on the H100: fp32 operations. At the ME-MHACL-shaped
// self-attention (BH = 512, T = 585, D = 32) the forward is 4 BH T^2 D =
// 22.4 GFLOP against 153 MB of Q, K, V and O: 0.33 ms at 67 TFLOP/s against
// 0.046 ms at 3.35 TB/s. This first version runs on the CUDA cores: one
// thread owns one query row (forward, dQ) or one key row (dK/dV) with its D
// values and its accumulators in registers, and the other operand's tile is
// staged in shared memory, where every lane of a warp reads the same entry
// (a broadcast). The forward keeps the tile's scores in shared memory (one
// column per thread), so each key tile rescales the accumulator once. No
// atomics: dQ is owned by its query tile and dK/dV by its key tile, so the
// results are deterministic. Tensor-core (wgmma) tiles are later work.
// D = 128 (2-4 x 128 accumulators a thread) spills registers to local
// memory: it is there for MultiheadAttention's wider heads, not for speed.

#include <math.h>

#include "common.cuh"

namespace {

template <int D>
__global__ void flash_fwd_kernel(const float* __restrict__ q,  // (BH, tq, D), pre-scaled
                                 const float* __restrict__ k,  // (BH, tk, D)
                                 const float* __restrict__ v,  // (BH, tk, D)
                                 float* __restrict__ o,        // (BH, tq, D)
                                 float* __restrict__ lse,      // (BH, tq)
                                 int tq, int tk, int bk) {
    extern __shared__ float smem[];
    const int bq = blockDim.x;
    float* ks = smem;           // (bk, D)
    float* vs = ks + bk * D;    // (bk, D)
    float* ss = vs + bk * D;    // (bk, bq): column r is thread r's scores
    const int bh = blockIdx.x;
    const int r = threadIdx.x;
    const int i = blockIdx.y * bq + r;
    const bool real = i < tq;
    const float* kb = k + static_cast<size_t>(bh) * tk * D;
    const float* vb = v + static_cast<size_t>(bh) * tk * D;

    float qr[D], acc[D];
    const float* qi = q + (static_cast<size_t>(bh) * tq + (real ? i : 0)) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
        qr[d] = real ? qi[d] : 0.0f;
        acc[d] = 0.0f;
    }
    float m = -INFINITY, l = 0.0f;
    for (int j0 = 0; j0 < tk; j0 += bk) {
        const int n = min(bk, tk - j0);
        __syncthreads();  // every thread is done with the previous tile
        for (int e = r; e < n * D; e += bq) {
            ks[e] = kb[static_cast<size_t>(j0) * D + e];
            vs[e] = vb[static_cast<size_t>(j0) * D + e];
        }
        __syncthreads();
        float mt = m;
        for (int j = 0; j < n; ++j) {
            float s = 0.0f;
#pragma unroll
            for (int d = 0; d < D; ++d) s = fmaf(qr[d], ks[j * D + d], s);
            ss[j * bq + r] = s;
            mt = fmaxf(mt, s);
        }
        const float alpha = expf(m - mt);  // 0 on the first tile (m = -inf)
        l *= alpha;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] *= alpha;
        for (int j = 0; j < n; ++j) {
            const float p = expf(ss[j * bq + r] - mt);
            l += p;
#pragma unroll
            for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j * D + d], acc[d]);
        }
        m = mt;
    }
    if (real) {
        float* oi = o + (static_cast<size_t>(bh) * tq + i) * D;
#pragma unroll
        for (int d = 0; d < D; ++d) oi[d] = acc[d] / l;
        lse[static_cast<size_t>(bh) * tq + i] = m + logf(l);
    }
}

template <int D>
__global__ void flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                    const float* __restrict__ v, const float* __restrict__ dout,
                                    const float* __restrict__ lse,    // (BH, tq)
                                    const float* __restrict__ delta,  // (BH, tq)
                                    float* __restrict__ dq, int tq, int tk, int bk) {
    extern __shared__ float smem[];
    const int bq = blockDim.x;
    float* ks = smem;         // (bk, D)
    float* vs = ks + bk * D;  // (bk, D)
    const int bh = blockIdx.x;
    const int r = threadIdx.x;
    const int i = blockIdx.y * bq + r;
    const bool real = i < tq;
    const size_t row = static_cast<size_t>(bh) * tq + (real ? i : 0);
    const float* kb = k + static_cast<size_t>(bh) * tk * D;
    const float* vb = v + static_cast<size_t>(bh) * tk * D;

    float qr[D], dor[D], acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
        qr[d] = real ? q[row * D + d] : 0.0f;
        dor[d] = real ? dout[row * D + d] : 0.0f;
        acc[d] = 0.0f;
    }
    const float li = real ? lse[row] : 0.0f;
    const float di = real ? delta[row] : 0.0f;
    for (int j0 = 0; j0 < tk; j0 += bk) {
        const int n = min(bk, tk - j0);
        __syncthreads();
        for (int e = r; e < n * D; e += bq) {
            ks[e] = kb[static_cast<size_t>(j0) * D + e];
            vs[e] = vb[static_cast<size_t>(j0) * D + e];
        }
        __syncthreads();
        for (int j = 0; j < n; ++j) {
            float s = 0.0f, dp = 0.0f;
#pragma unroll
            for (int d = 0; d < D; ++d) {
                s = fmaf(qr[d], ks[j * D + d], s);
                dp = fmaf(dor[d], vs[j * D + d], dp);
            }
            const float ds = expf(s - li) * (dp - di);
#pragma unroll
            for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, ks[j * D + d], acc[d]);
        }
    }
    if (real) {
#pragma unroll
        for (int d = 0; d < D; ++d) dq[row * D + d] = acc[d];
    }
}

template <int D>
__global__ void flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                     const float* __restrict__ v,
                                     const float* __restrict__ dout,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ delta,
                                     float* __restrict__ dk, float* __restrict__ dv, int tq,
                                     int tk, int bq) {
    extern __shared__ float smem[];
    const int bk = blockDim.x;
    float* qs = smem;            // (bq, D)
    float* dos = qs + bq * D;    // (bq, D)
    float* ls = dos + bq * D;    // (bq,)
    float* dls = ls + bq;        // (bq,)
    const int bh = blockIdx.x;
    const int r = threadIdx.x;
    const int j = blockIdx.y * bk + r;
    const bool real = j < tk;
    const size_t row = static_cast<size_t>(bh) * tk + (real ? j : 0);
    const float* qb = q + static_cast<size_t>(bh) * tq * D;
    const float* dob = dout + static_cast<size_t>(bh) * tq * D;

    float kr[D], vr[D], dka[D], dva[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
        kr[d] = real ? k[row * D + d] : 0.0f;
        vr[d] = real ? v[row * D + d] : 0.0f;
        dka[d] = 0.0f;
        dva[d] = 0.0f;
    }
    for (int i0 = 0; i0 < tq; i0 += bq) {
        const int n = min(bq, tq - i0);  // query rows >= tq never enter
        __syncthreads();
        for (int e = r; e < n * D; e += bk) {
            qs[e] = qb[static_cast<size_t>(i0) * D + e];
            dos[e] = dob[static_cast<size_t>(i0) * D + e];
        }
        for (int e = r; e < n; e += bk) {
            ls[e] = lse[static_cast<size_t>(bh) * tq + i0 + e];
            dls[e] = delta[static_cast<size_t>(bh) * tq + i0 + e];
        }
        __syncthreads();
        for (int i = 0; i < n; ++i) {
            float s = 0.0f, dp = 0.0f;
#pragma unroll
            for (int d = 0; d < D; ++d) {
                s = fmaf(qs[i * D + d], kr[d], s);
                dp = fmaf(dos[i * D + d], vr[d], dp);
            }
            const float p = expf(s - ls[i]);
            const float ds = p * (dp - dls[i]);
#pragma unroll
            for (int d = 0; d < D; ++d) {
                dva[d] = fmaf(p, dos[i * D + d], dva[d]);
                dka[d] = fmaf(ds, qs[i * D + d], dka[d]);
            }
        }
    }
    if (real) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
            dk[row * D + d] = dka[d];
            dv[row * D + d] = dva[d];
        }
    }
}

template <int D>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, float* o, float* lse,
                       int bh, int tq, int tk, int bq, int bk, cudaStream_t s) {
    const size_t smem = sizeof(float) * (2 * bk * D + bk * bq);
    cudaError_t err = allow_dynamic_smem(flash_fwd_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (tq + bq - 1) / bq);
    flash_fwd_kernel<D><<<grid, bq, smem, s>>>(q, k, v, o, lse, tq, tk, bk);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v, const float* dout,
                      const float* lse, const float* delta, float* dq, int bh, int tq, int tk,
                      int bq, int bk, cudaStream_t s) {
    const size_t smem = sizeof(float) * 2 * bk * D;
    cudaError_t err = allow_dynamic_smem(flash_bwd_dq_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (tq + bq - 1) / bq);
    flash_bwd_dq_kernel<D><<<grid, bq, smem, s>>>(q, k, v, dout, lse, delta, dq, tq, tk, bk);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v, const float* dout,
                       const float* lse, const float* delta, float* dk, float* dv, int bh,
                       int tq, int tk, int bq, int bk, cudaStream_t s) {
    const size_t smem = sizeof(float) * (2 * bq * D + 2 * bq);
    cudaError_t err = allow_dynamic_smem(flash_bwd_dkv_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (tk + bk - 1) / bk);
    flash_bwd_dkv_kernel<D><<<grid, bk, smem, s>>>(q, k, v, dout, lse, delta, dk, dv, tq, tk,
                                                   bq);
    return cudaGetLastError();
}

}  // namespace

// D must be 8, 16, 32, 64 or 128 (the wrapper checks); block_q and block_k are
// thread counts (multiples of 32) or tile rows, as each kernel uses them.
extern "C" int msa_flash_fwd(const float* q, const float* k, const float* v, float* o,
                             float* lse, int BH, int tq, int tk, int D, int block_q,
                             int block_k, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 8: return launch_fwd<8>(q, k, v, o, lse, BH, tq, tk, block_q, block_k, s);
        case 16: return launch_fwd<16>(q, k, v, o, lse, BH, tq, tk, block_q, block_k, s);
        case 32: return launch_fwd<32>(q, k, v, o, lse, BH, tq, tk, block_q, block_k, s);
        case 64: return launch_fwd<64>(q, k, v, o, lse, BH, tq, tk, block_q, block_k, s);
        case 128: return launch_fwd<128>(q, k, v, o, lse, BH, tq, tk, block_q, block_k, s);
        default: return cudaErrorInvalidValue;
    }
}

extern "C" int msa_flash_bwd_dq(const float* q, const float* k, const float* v,
                                const float* dout, const float* lse, const float* delta,
                                float* dq, int BH, int tq, int tk, int D, int block_q,
                                int block_k, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 8: return launch_dq<8>(q, k, v, dout, lse, delta, dq, BH, tq, tk, block_q, block_k, s);
        case 16: return launch_dq<16>(q, k, v, dout, lse, delta, dq, BH, tq, tk, block_q, block_k, s);
        case 32: return launch_dq<32>(q, k, v, dout, lse, delta, dq, BH, tq, tk, block_q, block_k, s);
        case 64: return launch_dq<64>(q, k, v, dout, lse, delta, dq, BH, tq, tk, block_q, block_k, s);
        case 128: return launch_dq<128>(q, k, v, dout, lse, delta, dq, BH, tq, tk, block_q, block_k, s);
        default: return cudaErrorInvalidValue;
    }
}

extern "C" int msa_flash_bwd_dkv(const float* q, const float* k, const float* v,
                                 const float* dout, const float* lse, const float* delta,
                                 float* dk, float* dv, int BH, int tq, int tk, int D,
                                 int block_q, int block_k, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 8: return launch_dkv<8>(q, k, v, dout, lse, delta, dk, dv, BH, tq, tk, block_q, block_k, s);
        case 16: return launch_dkv<16>(q, k, v, dout, lse, delta, dk, dv, BH, tq, tk, block_q, block_k, s);
        case 32: return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, BH, tq, tk, block_q, block_k, s);
        case 64: return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, BH, tq, tk, block_q, block_k, s);
        case 128: return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, BH, tq, tk, block_q, block_k, s);
        default: return cudaErrorInvalidValue;
    }
}
