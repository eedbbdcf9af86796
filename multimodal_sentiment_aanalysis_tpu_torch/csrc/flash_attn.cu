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
// (and padded query rows in dK/dV with a where); here the streamed tiles
// zero-fill their rows past the end, the forward and dQ mask those keys'
// scores to -inf, dK/dV sets the P of queries past tq to 0, and no row past
// the end is stored: the same masking without the padded copies.
//
// What bounds them on the H100: the products. At the ME-MHACL-shaped
// self-attention (BH = 512, T = 585, D = 32) the forward's two products are
// 4 BH T^2 D = 22.4 GFLOP, dQ's three (S, dP, dS K) 33.6 and dK/dV's four
// (S, dP, P^T dO, dS^T Q) 44.9, against 153-230 MB of operands (0.05-0.07
// ms at 3.35 TB/s). They must stay fp32-accurate (the JAX kernels run them
// at HIGHEST precision), so on the tensor cores they take three TF32 passes
// each (tf32_mma.cuh): 67.3, 100.9 and 134.6 GFLOP at 495 TFLOP/s, 0.136,
// 0.204 and 0.272 ms, plus ~4 fp32 operations a score for the softmax,
// 0.010 ms at 67 TFLOP/s.
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
// Backward design, in the forward's mould. Each kernel owns a tile of rows
// (dQ: block_q queries; dK/dV: block_k keys), one warp per 16 of them, and
// streams the other side through the same kind of cp.async ring (dQ: K and
// V tiles of block_k keys; dK/dV: Q and dO tiles of block_q queries with
// their LSE and delta). The CTA's own two operands are A fragments, split
// once into TF32 words and kept in registers (dQ: Q and dO up to D = 64;
// dK/dV: K and V up to D = 32), or above that kept in shared memory and
// split as they are read: dK/dV holds two accumulator sets and their fresh
// fragments, which leave no room for K and V at D = 64. Each streamed tile
// is taken in sub-tiles of kSub = 32 rows. Per sub-tile a warp computes
// - dQ: S = Q K^T and dP = dO V^T (three passes each), P = exp2f(S log2 e -
//   LSE log2 e) with its rows' LSE and delta in registers, dS = P (dP -
//   delta) in the accumulator fragments, then dS K with dS fed from the
//   accumulator in the forward's key pairing and K's rows read in that order;
// - dK/dV: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T with the LSE and delta
//   of each accumulator column's query (queries 2t and 2t + 1 of an 8-query
//   step, one 8-byte shared load each), P^T = 0 for queries past tq (their
//   zero-filled rows would give exp(0)), then P^T dO and dS^T Q with the
//   query pairing.
// The output products of a sub-tile are summed on the tensor cores into
// fresh fragments and added to the fp32 accumulators, so the tensor cores
// sum 32 rows, not all of T. Both kernels are deterministic: dQ is owned by
// its query tile and dK/dV by its key tile, with no atomics (a fused
// backward with atomic dQ would take 5 products in place of 7, but its
// gradients would change from run to run). D = 128 is there for
// MultiheadAttention's wider heads, not for speed: its ring holds two 32-row
// stages whatever the tile, so that 128 own rows of two operands fit beside
// it, and dK/dV's four accumulator sets (dK, dV and their fresh fragments)
// pass the register file, so that form spills.

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

// ---- backward: tensor cores ----

constexpr int kBwdMaxThreads = 256;  // block_q (dQ) or block_k (dK/dV) <= 128 rows, 16 a warp
constexpr int kSub = 32;             // streamed rows whose products share fresh fragments
// The backward kernels are bound with at least one block an SM, which
// leaves ptxas all 255 registers (it held dQ at D = 32 to 128 and spilled
// without it). Up to D = 32 a tile's sub-tiles are unrolled, so one's loads
// overlap another's products; wider heads keep one sub-tile's registers
// live at a time, which is what keeps D = 64 from spilling

// A backward CTA's shared memory: a ring of kStages stages of the streamed
// tiles, kBt rows of D + 4 floats each (dQ: K and V; dK/dV: Q and dO, then
// the tile's LSE and delta), and, where they wait in shared memory, the
// CTA's own two operands (dQ: Q and dO; dK/dV: K and V). At D = 128 the
// launchers take kBt = 32 and two stages whatever the tile, so that 128 own
// rows of two operands (135 KB) and the ring fit the 227 KB a block may use
template <int D, int kBt, bool kDkv>
struct BwdTile {
    static constexpr int kLd = D + 4;
    static constexpr int kStage = 2 * kBt * kLd + (kDkv ? 2 * kBt : 0);
    static constexpr int kStages = D <= 64 && 3 * 4 * kStage <= 120 * 1024 ? 3 : 2;
    // the own operands' A fragments: registers up to D = 64 (dQ) or D = 32
    // (dK/dV, whose two accumulator sets and fresh fragments take the room)
    static constexpr bool kOwnShared = D > (kDkv ? 32 : 64);
    // bytes of shared memory a CTA of `rows` own rows takes
    static constexpr size_t smem(int rows) {
        return sizeof(float) * (static_cast<size_t>(kStages) * kStage +
                                (kOwnShared ? 2 * static_cast<size_t>(rows) * kLd : 0));
    }
};

// A fragments of one of a CTA's own operands (Q or dO; K or V) for this
// warp's 16 rows at every 8-deep step of D, split into TF32 words: once, into
// registers, or (kShared) as they are read from the CTA's tile in shared
// memory (visible after the first barrier of the loop)
template <int D, bool kShared>
struct OwnFrags {
    static constexpr int kLd = D + 4, kDSteps = D / 8;
    uint32_t hi[kShared ? 1 : kDSteps][4], lo[kShared ? 1 : kDSteps][4];
    const float* row;  // this thread's row r0 at column t, in shared memory

    // src: the operand's rows of this head, n of them; the CTA owns rows
    // row0 on (`rows` of them, this thread r0 and r0 + 8), rows past n are 0
    __device__ __forceinline__ void load(const float* src, int n, int row0, int rows, int r0,
                                         int t, float* tile) {
        auto at = [&](int r, int c) {
            return row0 + r < n ? src[static_cast<size_t>(row0 + r) * D + c] : 0.0f;
        };
        if constexpr (kShared) {
            for (int e = threadIdx.x; e < rows * D; e += blockDim.x)
                tile[(e / D) * kLd + e % D] = at(e / D, e % D);
            row = tile + r0 * kLd + t;
        } else {
#pragma unroll
            for (int kd = 0; kd < kDSteps; ++kd) {
                const int c = kd * 8 + t;
                split_tf32_trunc(at(r0, c), hi[kd][0], lo[kd][0]);
                split_tf32_trunc(at(r0 + 8, c), hi[kd][1], lo[kd][1]);
                split_tf32_trunc(at(r0, c + 4), hi[kd][2], lo[kd][2]);
                split_tf32_trunc(at(r0 + 8, c + 4), hi[kd][3], lo[kd][3]);
            }
        }
    }
    __device__ __forceinline__ void frag(int kd, uint32_t (&ahi)[4], uint32_t (&alo)[4]) const {
        if constexpr (kShared) {
            const float* p = row + kd * 8;
            split_tf32_trunc(p[0], ahi[0], alo[0]);
            split_tf32_trunc(p[8 * kLd], ahi[1], alo[1]);
            split_tf32_trunc(p[4], ahi[2], alo[2]);
            split_tf32_trunc(p[8 * kLd + 4], ahi[3], alo[3]);
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                ahi[e] = hi[kd][e];
                alo[e] = lo[kd][e];
            }
        }
    }
};

// c += a b in three TF32 passes (the small terms first); b's two values (k =
// t and k = t + 4 of column g) at p[0] and p[off] in shared memory, split as
// they are read
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], const float* p, int off) {
    uint32_t bhi0, blo0, bhi1, blo1;
    split_tf32_trunc(p[0], bhi0, blo0);
    split_tf32_trunc(p[off], bhi1, blo1);
    mma_tf32(c, alo, bhi0, bhi1);
    mma_tf32(c, ahi, blo0, blo1);
    mma_tf32(c, ahi, bhi0, bhi1);
}

// An accumulator fragment (columns 2t and 2t + 1 of rows g and g + 8) as the
// A operand of the next product, split: A column t takes column 2t and
// column t + 4 column 2t + 1, so B's rows are read in that order
__device__ __forceinline__ void acc_as_a(const float (&c)[4], uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
    split_tf32_trunc(c[0], hi[0], lo[0]);
    split_tf32_trunc(c[2], hi[1], lo[1]);
    split_tf32_trunc(c[1], hi[2], lo[2]);
    split_tf32_trunc(c[3], hi[3], lo[3]);
}

// acc += part, in fp32
template <int kDSteps>
__device__ __forceinline__ void add_parts(float (&acc)[kDSteps][4],
                                          const float (&part)[kDSteps][4]) {
#pragma unroll
    for (int nd = 0; nd < kDSteps; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] += part[nd][e];
}
// this thread's two rows of acc to rows row0 + r0 and row0 + r0 + 8 of out
// (those below n)
template <int kDSteps>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[kDSteps][4], int n,
                                           int row0, int r0, int t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int i = row0 + r0 + 8 * h;
        if (i >= n) continue;
        float* oi = out + static_cast<size_t>(i) * (kDSteps * 8) + 2 * t;
#pragma unroll
        for (int nd = 0; nd < kDSteps; ++nd)
            *reinterpret_cast<float2*>(oi + nd * 8) =
                make_float2(acc[nd][2 * h], acc[nd][2 * h + 1]);
    }
}

template <int D, int kBk>
__global__ void __launch_bounds__(kBwdMaxThreads, 1)
flash_bwd_dq_kernel(const float* __restrict__ q,      // (BH, tq, D), pre-scaled
                    const float* __restrict__ k,      // (BH, tk, D)
                    const float* __restrict__ v,      // (BH, tk, D)
                    const float* __restrict__ dout,   // (BH, tq, D)
                    const float* __restrict__ lse,    // (BH, tq)
                    const float* __restrict__ delta,  // (BH, tq)
                    float* __restrict__ dq,           // (BH, tq, D)
                    int tq, int tk) {
    using Tile = BwdTile<D, kBk, false>;
    constexpr int kLd = Tile::kLd, kStages = Tile::kStages;
    constexpr int kDSteps = D / 8, kVecs = D / 4, kSteps = kSub / 8;
    extern __shared__ float4 bwd_smem[];  // 16-byte aligned
    float* ring = reinterpret_cast<float*>(bwd_smem);  // kStages x (K, V) tiles (kBk, kLd)
    float* own = ring + kStages * Tile::kStage;        // Q, dO tiles (rows, kLd), kOwnShared only
    const int rows = blockDim.x / 2;                   // 16 a warp of 32 threads
    const int bh = blockIdx.x;
    const int q0 = blockIdx.y * rows;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = (threadIdx.x / 32) * 16 + g;  // this thread's tile rows: r0, r0 + 8
    const size_t head = static_cast<size_t>(bh) * tq;  // this head's first query row
    const float* kb = k + static_cast<size_t>(bh) * tk * D;
    const float* vb = v + static_cast<size_t>(bh) * tk * D;

    OwnFrags<D, Tile::kOwnShared> qf, dof;
    qf.load(q + head * D, tq, q0, rows, r0, t, own);
    dof.load(dout + head * D, tq, q0, rows, r0, t, own + rows * kLd);
    float ml[2], dl[2];  // LSE log2 e and delta of rows r0, r0 + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int i = q0 + r0 + 8 * h;
        ml[h] = i < tq ? lse[head + i] * kLog2e : 0.0f;
        dl[h] = i < tq ? delta[head + i] : 0.0f;
    }
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

    float acc[kDSteps][4] = {};  // dQ of rows r0, r0 + 8, as C fragments
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
#pragma unroll(D <= 32 ? kBk / kSub : 1)
        for (int sc = 0; sc < kBk / kSub; ++sc) {
            const int j0 = kt * kBk + sc * kSub;  // the sub-tile's first key
            if (j0 >= tk) break;                  // the rest of the tile is padding
            const float* kc = ks + sc * kSub * kLd;
            const float* vc = vs + sc * kSub * kLd;

            // S = Q K^T and dP = dO V^T: key step j holds keys j0 + 8j + 2t,
            // + 1 in [j][0..1] (row r0) and [j][2..3] (row r0 + 8)
            float s[kSteps][4] = {}, dp[kSteps][4] = {};
#pragma unroll
            for (int kd = 0; kd < kDSteps; ++kd) {
                uint32_t qhi[4], qlo[4], dhi[4], dlo[4];
                qf.frag(kd, qhi, qlo);
                dof.frag(kd, dhi, dlo);
#pragma unroll
                for (int j = 0; j < kSteps; ++j) {
                    const int at = (j * 8 + g) * kLd + kd * 8 + t;
                    mma3(s[j], qhi, qlo, kc + at, 4);
                    mma3(dp[j], dhi, dlo, vc + at, 4);
                }
            }
            if (j0 + kSub > tk) {
#pragma unroll
                for (int j = 0; j < kSteps; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (j0 + j * 8 + 2 * t + (e & 1) >= tk) s[j][e] = -INFINITY;
            }
            // dS = P (dP - delta), P = exp(S - LSE) = 2^(S log2 e - LSE log2 e)
#pragma unroll
            for (int j = 0; j < kSteps; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    s[j][e] = exp2f(fmaf(s[j][e], kLog2e, -ml[e >> 1])) * (dp[j][e] - dl[e >> 1]);

            // dQ += dS K: A column t <- key 8j + 2t, column t + 4 <- key 8j + 2t + 1
            float part[kDSteps][4] = {};
#pragma unroll
            for (int j = 0; j < kSteps; ++j) {
                uint32_t ahi[4], alo[4];
                acc_as_a(s[j], ahi, alo);
                const float* kr = kc + (j * 8 + 2 * t) * kLd + g;  // B rows k = t, t + 4
#pragma unroll
                for (int nd = 0; nd < kDSteps; ++nd) mma3(part[nd], ahi, alo, kr + nd * 8, kLd);
            }
            add_parts(acc, part);
        }
    }
    cp_async_wait<0>();  // no copy outlives the block
    store_rows(dq + head * D, acc, tq, q0, r0, t);
}

template <int D, int kBq>
__global__ void __launch_bounds__(kBwdMaxThreads, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q,      // (BH, tq, D), pre-scaled
                     const float* __restrict__ k,      // (BH, tk, D)
                     const float* __restrict__ v,      // (BH, tk, D)
                     const float* __restrict__ dout,   // (BH, tq, D)
                     const float* __restrict__ lse,    // (BH, tq)
                     const float* __restrict__ delta,  // (BH, tq)
                     float* __restrict__ dk,           // (BH, tk, D)
                     float* __restrict__ dv,           // (BH, tk, D)
                     int tq, int tk) {
    using Tile = BwdTile<D, kBq, true>;
    constexpr int kLd = Tile::kLd, kStages = Tile::kStages;
    constexpr int kDSteps = D / 8, kVecs = D / 4, kSteps = kSub / 8;
    extern __shared__ float4 bwd_smem[];  // 16-byte aligned
    // kStages x (Q, dO tiles (kBq, kLd), LSE, delta (kBq))
    float* ring = reinterpret_cast<float*>(bwd_smem);
    float* own = ring + kStages * Tile::kStage;  // K, V tiles (rows, kLd), kOwnShared only
    const int rows = blockDim.x / 2;             // 16 a warp of 32 threads
    const int bh = blockIdx.x;
    const int k0 = blockIdx.y * rows;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = (threadIdx.x / 32) * 16 + g;  // this thread's tile rows: r0, r0 + 8
    const size_t head = static_cast<size_t>(bh) * tq;    // this head's first query row
    const size_t khead = static_cast<size_t>(bh) * tk;   // and key row
    const float* qb = q + head * D;
    const float* dob = dout + head * D;

    OwnFrags<D, Tile::kOwnShared> kf, vf;
    kf.load(k + khead * D, tk, k0, rows, r0, t, own);
    vf.load(v + khead * D, tk, k0, rows, r0, t, own + rows * kLd);
    // the copies of query tile it into a stage: Q rows, dO rows, LSE, delta
    auto load_tile = [&](int it, float* stage) {
        const int i0 = it * kBq;
        for (int e = threadIdx.x; e < kBq * kVecs; e += blockDim.x) {
            const int r = e / kVecs, c = (e % kVecs) * 4;
            const bool real = i0 + r < tq;
            const size_t at = static_cast<size_t>(real ? i0 + r : 0) * D + c;
            cp_async4(stage + r * kLd + c, qb + at, real);
            cp_async4(stage + (kBq + r) * kLd + c, dob + at, real);
        }
        float* ls = stage + 2 * kBq * kLd;
        for (int e = threadIdx.x; e < kBq; e += blockDim.x) {
            const bool real = i0 + e < tq;
            const size_t at = head + (real ? i0 + e : 0);
            cp_async1(ls + e, lse + at, real);
            cp_async1(ls + kBq + e, delta + at, real);
        }
    };

    float dka[kDSteps][4] = {}, dva[kDSteps][4] = {};  // dK, dV of rows r0, r0 + 8
    const int nq = (tq + kBq - 1) / kBq;
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
        if (st < nq) load_tile(st, ring + st * Tile::kStage);
        cp_async_commit();  // an empty group past the end keeps the count
    }
    for (int it = 0; it < nq; ++it) {
        cp_async_wait<kStages - 2>();  // query tile it has landed (this thread's copies)
        __syncthreads();               // (everyone's), and tile it - 1 is consumed
        const int next = it + kStages - 1;
        if (next < nq) load_tile(next, ring + (next % kStages) * Tile::kStage);
        cp_async_commit();
        const float* qs = ring + (it % kStages) * Tile::kStage;
        const float* dos = qs + kBq * kLd;
        const float* ls = qs + 2 * kBq * kLd;
#pragma unroll(D <= 32 ? kBq / kSub : 1)
        for (int sc = 0; sc < kBq / kSub; ++sc) {
            const int i0 = it * kBq + sc * kSub;  // the sub-tile's first query
            if (i0 >= tq) break;                  // the rest of the tile is padding
            const float* qc = qs + sc * kSub * kLd;
            const float* dc = dos + sc * kSub * kLd;
            const float* lc = ls + sc * kSub;

            // S^T = K Q^T and dP^T = V dO^T: query step j holds queries i0 +
            // 8j + 2t, + 1 in [j][0..1] (key r0) and [j][2..3] (key r0 + 8)
            float s[kSteps][4] = {}, dp[kSteps][4] = {};
#pragma unroll
            for (int kd = 0; kd < kDSteps; ++kd) {
                uint32_t khi[4], klo[4], vhi[4], vlo[4];
                kf.frag(kd, khi, klo);
                vf.frag(kd, vhi, vlo);
#pragma unroll
                for (int j = 0; j < kSteps; ++j) {
                    const int at = (j * 8 + g) * kLd + kd * 8 + t;
                    mma3(s[j], khi, klo, qc + at, 4);
                    mma3(dp[j], vhi, vlo, dc + at, 4);
                }
            }
            // P^T = exp(S^T - LSE) with each column's query's LSE, exactly 0
            // for queries past tq; dS^T = P^T (dP^T - delta)
            const bool edge = i0 + kSub > tq;
#pragma unroll
            for (int j = 0; j < kSteps; ++j) {
                const float2 l2 = *reinterpret_cast<const float2*>(lc + j * 8 + 2 * t);
                const float2 d2 = *reinterpret_cast<const float2*>(lc + kBq + j * 8 + 2 * t);
                const float ml[2] = {l2.x * kLog2e, l2.y * kLog2e}, dl[2] = {d2.x, d2.y};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float p = exp2f(fmaf(s[j][e], kLog2e, -ml[e & 1]));
                    if (edge && i0 + j * 8 + 2 * t + (e & 1) >= tq) p = 0.0f;
                    s[j][e] = p;
                    dp[j][e] = p * (dp[j][e] - dl[e & 1]);
                }
            }

            // dV += P^T dO and dK += dS^T Q: A column t <- query 8j + 2t,
            // column t + 4 <- query 8j + 2t + 1
            float pv[kDSteps][4] = {}, pk[kDSteps][4] = {};
#pragma unroll
            for (int j = 0; j < kSteps; ++j) {
                uint32_t phi[4], plo[4], shi[4], slo[4];
                acc_as_a(s[j], phi, plo);
                acc_as_a(dp[j], shi, slo);
                const int at = (j * 8 + 2 * t) * kLd + g;  // B rows k = t, t + 4
#pragma unroll
                for (int nd = 0; nd < kDSteps; ++nd) {
                    mma3(pv[nd], phi, plo, dc + at + nd * 8, kLd);
                    mma3(pk[nd], shi, slo, qc + at + nd * 8, kLd);
                }
            }
            add_parts(dva, pv);
            add_parts(dka, pk);
        }
    }
    cp_async_wait<0>();  // no copy outlives the block
    store_rows(dk + khead * D, dka, tk, k0, r0, t);
    store_rows(dv + khead * D, dva, tk, k0, r0, t);
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

// the backward launchers: `rows` own rows a CTA (a multiple of 16 up to 128,
// one warp per 16), a streamed tile of kBt rows, and the wrapper's count of
// the shared memory (kernels/attention.py::dq_smem, dkv_smem), which must
// equal the launcher's own
template <int D, int kBt, bool kDkv>
cudaError_t bwd_plan(int rows, int smem_planned, size_t& smem) {
    smem = BwdTile<D, kBt, kDkv>::smem(rows);
    if (rows % 16 || rows < 16 || 2 * rows > kBwdMaxThreads ||
        smem != static_cast<size_t>(smem_planned) || smem > 227 * 1024)
        return cudaErrorInvalidValue;
    return cudaSuccess;
}

template <int D, int kBk>
cudaError_t launch_dq_tile(const float* q, const float* k, const float* v, const float* dout,
                           const float* lse, const float* delta, float* dq, int bh, int tq,
                           int tk, int bq, int smem_planned, cudaStream_t s) {
    size_t smem;
    cudaError_t err = bwd_plan<D, kBk, false>(bq, smem_planned, smem);
    if (err == cudaSuccess) err = allow_dynamic_smem(flash_bwd_dq_kernel<D, kBk>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (tq + bq - 1) / bq);
    flash_bwd_dq_kernel<D, kBk><<<grid, 2 * bq, smem, s>>>(q, k, v, dout, lse, delta, dq, tq, tk);
    return cudaGetLastError();
}

template <int D, int kBq>
cudaError_t launch_dkv_tile(const float* q, const float* k, const float* v, const float* dout,
                            const float* lse, const float* delta, float* dk, float* dv, int bh,
                            int tq, int tk, int bk, int smem_planned, cudaStream_t s) {
    size_t smem;
    cudaError_t err = bwd_plan<D, kBq, true>(bk, smem_planned, smem);
    if (err == cudaSuccess) err = allow_dynamic_smem(flash_bwd_dkv_kernel<D, kBq>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (tk + bk - 1) / bk);
    flash_bwd_dkv_kernel<D, kBq><<<grid, 2 * bk, smem, s>>>(q, k, v, dout, lse, delta, dk, dv,
                                                             tq, tk);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v, const float* dout,
                      const float* lse, const float* delta, float* dq, int bh, int tq, int tk,
                      int bq, int bk, int sp, cudaStream_t s) {
    if (bk != 32 && bk != 64 && bk != 128) return cudaErrorInvalidValue;
    if constexpr (D > 64) {  // BwdTile: 32-row stages at D = 128, whatever the tile
        return launch_dq_tile<D, 32>(q, k, v, dout, lse, delta, dq, bh, tq, tk, bq, sp, s);
    } else {
        switch (bk) {
            case 32: return launch_dq_tile<D, 32>(q, k, v, dout, lse, delta, dq, bh, tq, tk, bq, sp, s);
            case 64: return launch_dq_tile<D, 64>(q, k, v, dout, lse, delta, dq, bh, tq, tk, bq, sp, s);
            default: return launch_dq_tile<D, 128>(q, k, v, dout, lse, delta, dq, bh, tq, tk, bq, sp, s);
        }
    }
}

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v, const float* dout,
                       const float* lse, const float* delta, float* dk, float* dv, int bh,
                       int tq, int tk, int bq, int bk, int sp, cudaStream_t s) {
    if (bq != 32 && bq != 64 && bq != 128) return cudaErrorInvalidValue;
    if constexpr (D > 64) {  // BwdTile: 32-row stages at D = 128, whatever the tile
        return launch_dkv_tile<D, 32>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, bk, sp, s);
    } else {
        switch (bq) {
            case 32: return launch_dkv_tile<D, 32>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, bk, sp, s);
            case 64: return launch_dkv_tile<D, 64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, bk, sp, s);
            default: return launch_dkv_tile<D, 128>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, bk, sp, s);
        }
    }
}

}  // namespace

// D must be 8, 16, 32, 64 or 128 (the wrapper checks). Each kernel takes a
// tile of own rows a CTA (a multiple of 16 up to 128: one warp per 16) and a
// streamed tile (32, 64 or 128 rows): the forward and dQ block_q query rows
// and block_k keys a tile, dK/dV block_k key rows and block_q queries a
// tile; and smem_planned, the wrapper's count of its shared memory.
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
                                int block_k, int smem_planned, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int bq = block_q, bk = block_k, sp = smem_planned;
    switch (D) {
        case 8: return launch_dq<8>(q, k, v, dout, lse, delta, dq, BH, tq, tk, bq, bk, sp, s);
        case 16: return launch_dq<16>(q, k, v, dout, lse, delta, dq, BH, tq, tk, bq, bk, sp, s);
        case 32: return launch_dq<32>(q, k, v, dout, lse, delta, dq, BH, tq, tk, bq, bk, sp, s);
        case 64: return launch_dq<64>(q, k, v, dout, lse, delta, dq, BH, tq, tk, bq, bk, sp, s);
        case 128: return launch_dq<128>(q, k, v, dout, lse, delta, dq, BH, tq, tk, bq, bk, sp, s);
        default: return cudaErrorInvalidValue;
    }
}

extern "C" int msa_flash_bwd_dkv(const float* q, const float* k, const float* v,
                                 const float* dout, const float* lse, const float* delta,
                                 float* dk, float* dv, int BH, int tq, int tk, int D,
                                 int block_q, int block_k, int smem_planned, int device,
                                 void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int bq = block_q, bk = block_k, sp = smem_planned;
    switch (D) {
        case 8: return launch_dkv<8>(q, k, v, dout, lse, delta, dk, dv, BH, tq, tk, bq, bk, sp, s);
        case 16: return launch_dkv<16>(q, k, v, dout, lse, delta, dk, dv, BH, tq, tk, bq, bk, sp, s);
        case 32: return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, BH, tq, tk, bq, bk, sp, s);
        case 64: return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, BH, tq, tk, bq, bk, sp, s);
        case 128: return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, BH, tq, tk, bq, bk, sp, s);
        default: return cudaErrorInvalidValue;
    }
}
