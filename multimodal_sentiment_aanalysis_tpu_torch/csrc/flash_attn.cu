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
// (and padded query rows in dK/dV with a where); here the forward zero-fills
// the key and value rows past tk in its tiles and masks their scores to
// -inf, the backward loops stop at the last real row, and no query row past
// tq is stored: the same masking without the padded copies.
//
// What bounds it on the H100: the products. At the ME-MHACL-shaped
// self-attention (BH = 512, T = 585, D = 32) the forward's two products are
// 4 BH T^2 D = 22.4 GFLOP, against 153 MB of Q, K, V and O (0.046 ms at 3.35
// TB/s). They must stay fp32-accurate (the JAX kernel runs them at HIGHEST
// precision), so on the tensor cores they take three TF32 passes each
// (tf32_mma.cuh): 67.3 GFLOP at 495 TFLOP/s, 0.136 ms, plus ~4 fp32
// operations a score for the softmax, 0.010 ms at 67 TFLOP/s.
//
// Forward design (flash_fwd_kernel): one CTA per (bh, block_q query rows),
// one warp per 16 of them (the m16 of mma.sync.m16n8k8). Each warp splits
// its Q fragments into TF32 high and low words once and keeps them in
// registers (D <= 64; at D = 128 the CTA's Q tile waits in shared memory and
// is split as it is read). Every split rounds the high word and leaves the
// low word for the tensor cores to truncate (split_tf32_trunc): one
// conversion a value instead of two. The key and value tiles, kBk rows
// each, stream through a 2-3 deep cp.async ring; rows past tk are
// zero-filled copies (src-size 0). Per key tile a warp computes S = Q K^T
// for its 16 rows with three mma.sync per 8 x 8 x 8 step (the small terms
// first), the depth D summed on the tensor cores; masks the columns past tk
// to -inf; takes the row max over its accumulator fragment and two quad
// shuffles (a row's scores sit in the 4 lanes of a quad), rescales its
// partial row sum and, once per tile, the fp32 output accumulator by
// exp(m_old - m_new). P = exp(S - m), taken as 2^(S log2 e - m log2 e)
// (exp2f; the exponent rounds once), goes from S's accumulator fragment
// straight into the next mma.sync as its A operand, with no trip through
// shared memory: C holds keys 2t and 2t + 1 of each 8-key step in lane t of
// a quad, so A column t takes key 2t and column t + 4 key 2t + 1, and the B
// fragment of V loads its rows in that key order (the sum over keys does
// not care about order, so no shuffles). P and V are split as Q and K are.
// Each key tile's P V is summed on the tensor cores into a fresh fragment
// and added to the accumulator in fp32 (acc = alpha acc + P V), so the
// tensor cores' own sums run over one tile's keys, not all of Tk. The
// partial row sums meet in the quad at the end: O = acc / l, LSE = m + log
// l. Shared-memory rows are padded to D + 4 floats, so every fragment load
// of a warp hits 32 banks. At D = 128 and a 128-key tile two stages do not
// fit the 227 KB a block may use: that pair is refused. wgmma and TMA are
// later work: a TF32 wgmma needs both operands K-major in shared memory, so
// V would have to be staged transposed and split.
//
// The backward kernels run on the CUDA cores: one thread owns one query row
// (dQ) or one key row (dK/dV) with its D values and its accumulators in
// registers, and the other operand's tile is staged in shared memory, where
// every lane of a warp reads the same entry (a broadcast). No atomics: dQ is
// owned by its query tile and dK/dV by its key tile, so the results are
// deterministic. D = 128 (2-4 x 128 accumulators a thread) spills registers
// to local memory: it is there for MultiheadAttention's wider heads, not for
// speed.

#include <math.h>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

// ---- forward: tensor cores ----

constexpr int kFwdMaxThreads = 256;  // block_q <= 128 query rows, 16 a warp
constexpr float kLog2e = 1.4426950408889634f;

template <int D, int kBk>
struct FwdTile {
    static constexpr int kLd = D + 4;             // padded row of a Q, K or V tile
    static constexpr int kStage = 2 * kBk * kLd;  // floats of one stage: K and V
    static constexpr int kStages = 3 * 4 * kStage <= 120 * 1024 ? 3 : 2;
    static constexpr bool kQShared = D > 64;      // Q fragments: shared memory, not registers
    // bytes of shared memory a CTA of `rows` query rows takes
    static constexpr size_t smem(int rows) {
        return sizeof(float) * (static_cast<size_t>(kStages) * kStage +
                                (kQShared ? static_cast<size_t>(rows) * kLd : 0));
    }
};

template <int D, int kBk>
__global__ void __launch_bounds__(kFwdMaxThreads)
flash_fwd_kernel(const float* __restrict__ q,  // (BH, tq, D), pre-scaled
                 const float* __restrict__ k,  // (BH, tk, D)
                 const float* __restrict__ v,  // (BH, tk, D)
                 float* __restrict__ o,        // (BH, tq, D)
                 float* __restrict__ lse,      // (BH, tq)
                 int tq, int tk) {
    using Tile = FwdTile<D, kBk>;
    constexpr int kLd = Tile::kLd, kStages = Tile::kStages;
    constexpr int kKeySteps = kBk / 8, kDSteps = D / 8, kVecs = D / 4;
    extern __shared__ float4 fwd_smem[];  // 16-byte aligned
    float* ring = reinterpret_cast<float*>(fwd_smem);  // kStages x (K, V) tiles (kBk, kLd)
    float* qs = ring + kStages * Tile::kStage;         // Q tile (rows, kLd), kQShared only
    const int rows = blockDim.x / 2;                   // 16 a warp of 32 threads
    const int bh = blockIdx.x;
    const int q0 = blockIdx.y * rows;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = (threadIdx.x / 32) * 16 + g;  // this thread's tile rows: r0, r0 + 8
    const float* qb = q + static_cast<size_t>(bh) * tq * D;
    const float* kb = k + static_cast<size_t>(bh) * tk * D;
    const float* vb = v + static_cast<size_t>(bh) * tk * D;
    auto q_at = [&](int r, int c) {
        return q0 + r < tq ? qb[static_cast<size_t>(q0 + r) * D + c] : 0.0f;
    };

    // Q as A fragments, split into TF32 words: in registers, or staged in
    // shared memory (visible after the first barrier of the loop)
    uint32_t qhi[Tile::kQShared ? 1 : kDSteps][4], qlo[Tile::kQShared ? 1 : kDSteps][4];
    if constexpr (Tile::kQShared) {
        for (int e = threadIdx.x; e < rows * D; e += blockDim.x)
            qs[(e / D) * kLd + e % D] = q_at(e / D, e % D);
    } else {
#pragma unroll
        for (int kd = 0; kd < kDSteps; ++kd) {
            const int c = kd * 8 + t;
            split_tf32_trunc(q_at(r0, c), qhi[kd][0], qlo[kd][0]);
            split_tf32_trunc(q_at(r0 + 8, c), qhi[kd][1], qlo[kd][1]);
            split_tf32_trunc(q_at(r0, c + 4), qhi[kd][2], qlo[kd][2]);
            split_tf32_trunc(q_at(r0 + 8, c + 4), qhi[kd][3], qlo[kd][3]);
        }
    }
    auto q_frag = [&](int kd, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
        if constexpr (Tile::kQShared) {
            const float* qr = qs + r0 * kLd + kd * 8 + t;
            split_tf32_trunc(qr[0], hi[0], lo[0]);
            split_tf32_trunc(qr[8 * kLd], hi[1], lo[1]);
            split_tf32_trunc(qr[4], hi[2], lo[2]);
            split_tf32_trunc(qr[8 * kLd + 4], hi[3], lo[3]);
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                hi[e] = qhi[kd][e];
                lo[e] = qlo[kd][e];
            }
        }
    };
    // the copies of key tile kt into a stage: K rows, then V rows
    auto load_tile = [&](int kt, float* stage) {
        const int j0 = kt * kBk;
        for (int e = threadIdx.x; e < kBk * kVecs; e += blockDim.x) {
            const int r = e / kVecs, c = (e % kVecs) * 4;
            const bool real = j0 + r < tk;
            const size_t at = static_cast<size_t>(real ? j0 + r : 0) * D + c;
            cp_async4(stage + r * kLd + c, kb + at, real);
            cp_async4(stage + (kBk + r) * kLd + c, vb + at, real);
        }
    };

    float acc[kDSteps][4] = {};                  // O of rows r0, r0 + 8, as C fragments
    float m[2] = {-INFINITY, -INFINITY};         // running max of the two rows
    float l[2] = {0.0f, 0.0f};                   // this lane's share of the row sums
    const int nk = (tk + kBk - 1) / kBk;
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
        if (st < nk) load_tile(st, ring + st * Tile::kStage);
        cp_async_commit();  // an empty group past the end keeps the count
    }
    for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<kStages - 2>();  // key tile kt has landed (this thread's copies)
        __syncthreads();               // (everyone's), and tile kt - 1 is consumed
        const int next = kt + kStages - 1;
        if (next < nk) load_tile(next, ring + (next % kStages) * Tile::kStage);
        cp_async_commit();
        const float* ks = ring + (kt % kStages) * Tile::kStage;
        const float* vs = ks + kBk * kLd;

        // S = Q K^T: key step j holds keys 8j + 2t, 8j + 2t + 1 in s[j][0..1]
        // (row r0) and s[j][2..3] (row r0 + 8)
        float s[kKeySteps][4] = {};
#pragma unroll
        for (int kd = 0; kd < kDSteps; ++kd) {
            uint32_t ahi[4], alo[4];
            q_frag(kd, ahi, alo);
#pragma unroll
            for (int j = 0; j < kKeySteps; ++j) {
                const float* kr = ks + (j * 8 + g) * kLd + kd * 8 + t;
                uint32_t bhi0, blo0, bhi1, blo1;
                split_tf32_trunc(kr[0], bhi0, blo0);
                split_tf32_trunc(kr[4], bhi1, blo1);
                mma_tf32(s[j], alo, bhi0, bhi1);
                mma_tf32(s[j], ahi, blo0, blo1);
                mma_tf32(s[j], ahi, bhi0, bhi1);
            }
        }
        const int j0 = kt * kBk;
        if (j0 + kBk > tk) {
#pragma unroll
            for (int j = 0; j < kKeySteps; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (j0 + j * 8 + 2 * t + (e & 1) >= tk) s[j][e] = -INFINITY;
        }

        // online softmax: every tile has a real key, so the max is finite
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < kKeySteps; ++j) {
            mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
            mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
        }
        float alpha[2], ml[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
            alpha[h] = exp2f((m[h] - mx[h]) * kLog2e);  // 0 on the first tile (m = -inf)
            m[h] = mx[h];
            ml[h] = m[h] * kLog2e;
            l[h] *= alpha[h];
        }
        // P = exp(S - m) = 2^(S log2 e - m log2 e), one rounding in the exponent
#pragma unroll
        for (int j = 0; j < kKeySteps; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s[j][e] = exp2f(fmaf(s[j][e], kLog2e, -ml[e >> 1]));
                l[e >> 1] += s[j][e];
            }

        // P V: A column t <- key 8j + 2t, column t + 4 <- key 8j + 2t + 1
        float pv[kDSteps][4] = {};
#pragma unroll
        for (int j = 0; j < kKeySteps; ++j) {
            uint32_t phi[4], plo[4];
            split_tf32_trunc(s[j][0], phi[0], plo[0]);
            split_tf32_trunc(s[j][2], phi[1], plo[1]);
            split_tf32_trunc(s[j][1], phi[2], plo[2]);
            split_tf32_trunc(s[j][3], phi[3], plo[3]);
            const float* vr = vs + (j * 8 + 2 * t) * kLd + g;  // B rows k = t, t + 4
#pragma unroll
            for (int nd = 0; nd < kDSteps; ++nd) {
                uint32_t bhi0, blo0, bhi1, blo1;
                split_tf32_trunc(vr[nd * 8], bhi0, blo0);
                split_tf32_trunc(vr[kLd + nd * 8], bhi1, blo1);
                mma_tf32(pv[nd], plo, bhi0, bhi1);
                mma_tf32(pv[nd], phi, blo0, blo1);
                mma_tf32(pv[nd], phi, bhi0, bhi1);
            }
        }
#pragma unroll
        for (int nd = 0; nd < kDSteps; ++nd)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nd][e] = fmaf(acc[nd][e], alpha[e >> 1], pv[nd][e]);
    }
    cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        const int i = q0 + r0 + 8 * h;
        if (i >= tq) continue;
        float* oi = o + (static_cast<size_t>(bh) * tq + i) * D + 2 * t;
#pragma unroll
        for (int nd = 0; nd < kDSteps; ++nd)
            *reinterpret_cast<float2*>(oi + nd * 8) =
                make_float2(acc[nd][2 * h] / l[h], acc[nd][2 * h + 1] / l[h]);
        if (t == 0) lse[static_cast<size_t>(bh) * tq + i] = m[h] + logf(l[h]);
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

template <int D, int kBk>
cudaError_t launch_fwd_tile(const float* q, const float* k, const float* v, float* o,
                            float* lse, int bh, int tq, int tk, int bq, int smem_planned,
                            cudaStream_t s) {
    using Tile = FwdTile<D, kBk>;
    const size_t smem = Tile::smem(bq);
    // the wrapper counted these bytes itself (kernels/attention.py::fwd_smem):
    // a plan made on another layout is refused, as is one that does not fit
    if (bq % 16 || bq < 16 || 2 * bq > kFwdMaxThreads ||
        smem != static_cast<size_t>(smem_planned) || smem > 227 * 1024)
        return cudaErrorInvalidValue;
    if constexpr (Tile::smem(16) <= 227 * 1024) {
        cudaError_t err = allow_dynamic_smem(flash_fwd_kernel<D, kBk>, smem);
        if (err != cudaSuccess) return err;
        const dim3 grid(bh, (tq + bq - 1) / bq);
        flash_fwd_kernel<D, kBk><<<grid, 2 * bq, smem, s>>>(q, k, v, o, lse, tq, tk);
        return cudaGetLastError();
    }
    return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, float* o, float* lse,
                       int bh, int tq, int tk, int bq, int bk, int smem_planned,
                       cudaStream_t s) {
    const int sp = smem_planned;
    switch (bk) {
        case 32: return launch_fwd_tile<D, 32>(q, k, v, o, lse, bh, tq, tk, bq, sp, s);
        case 64: return launch_fwd_tile<D, 64>(q, k, v, o, lse, bh, tq, tk, bq, sp, s);
        case 128: return launch_fwd_tile<D, 128>(q, k, v, o, lse, bh, tq, tk, bq, sp, s);
        default: return cudaErrorInvalidValue;
    }
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

// D must be 8, 16, 32, 64 or 128 (the wrapper checks). The forward takes
// block_q query rows a CTA (a multiple of 16 up to 128: one warp per 16) and
// block_k keys a tile (32, 64 or 128), and smem_planned, the wrapper's count
// of its shared memory; the backward kernels take block_q and block_k as
// thread counts (multiples of 32) or tile rows, as each uses them.
extern "C" int msa_flash_fwd(const float* q, const float* k, const float* v, float* o,
                             float* lse, int BH, int tq, int tk, int D, int block_q,
                             int block_k, int smem_planned, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int bq = block_q, bk = block_k, sp = smem_planned;
    switch (D) {
        case 8: return launch_fwd<8>(q, k, v, o, lse, BH, tq, tk, bq, bk, sp, s);
        case 16: return launch_fwd<16>(q, k, v, o, lse, BH, tq, tk, bq, bk, sp, s);
        case 32: return launch_fwd<32>(q, k, v, o, lse, BH, tq, tk, bq, bk, sp, s);
        case 64: return launch_fwd<64>(q, k, v, o, lse, BH, tq, tk, bq, bk, sp, s);
        case 128: return launch_fwd<128>(q, k, v, o, lse, BH, tq, tk, bq, bk, sp, s);
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
