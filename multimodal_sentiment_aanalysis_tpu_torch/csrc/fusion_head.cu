// The ME-MHACL fusion and classification head in one launch, forward only,
// fp32 and bf16.
//
// Replaces multimodal_sentiment_aanalysis_tpu/kernels/fusion_head.py::_kernel:
// the three modality embeddings (B, F) as a length-3 sequence; Q, K and V
// projections (the packed in_proj of nn.MultiheadAttention); per head a 3x3
// softmax of q_i . k_j / sqrt(F / H); the out projection; the mean over the
// three modalities; the shared Linear + ReLU and the two heads. Nothing
// between the embeddings and the logits reaches device memory.
//
// What bounds it on the H100: at the reference batch (B = 32, F = 256, 8
// heads, hidden 128, 2 classes) ~52 MFLOP over ~1.1 MB, mostly the weights:
// a bound of ~1 us, so latency rules, and where one block per batch row
// streamed every weight from L2 for every row (~38 MB of L2 reads at B = 32),
// the weights must be read once per batch tile and split across SMs. What
// is left (scripts/profile_fusion_head.py) is each CTA's chain of phases:
// the products' mma.sync issue and a barrier a ring stage, and the four
// cluster barriers.
//
// Design: one thread-block cluster of K CTAs per batch tile of R rows (R
// 4, 8 or 16: the wrapper takes the smallest whose clusters fit the card's
// 132 SMs at one CTA an SM, so a small batch spreads over many SMs), K the
// largest divisor of the head count up to 8. CTA r owns heads r, r + K,
// ..., the out projection's columns [r F/K, (r + 1) F/K) and the shared
// layer's units [r u, (r + 1) u), u = ceil(hidden / K): each weight byte is
// read once per cluster, 1/K of it by each CTA. The tile's rows sit in
// shared memory modality-major, row m R + i for modality m of batch row i,
// padded with zero rows to whole m16 tiles of mma.sync (every row is
// independent, so the padding never reaches a real row):
// 1. the tile's three embeddings (3R, F), staged with cp.async beside the
//    first chunks of the CTA's in_proj rows;
// 2. Q, K and V of the CTA's heads: the tile times those in_proj rows,
//    which stream through a cp.async ring (2 stages of 2 chunks of 32
//    features, 128-byte rows; a barrier a stage);
// 3. the 3x3 softmax and p . v of each (row, own head), 8 lanes a task,
//    from the CTA's own Q, K and V; each value is pushed into every CTA's
//    copy of the attention output (DSMEM stores: nothing waits on a remote
//    read);
// 4. after a cluster barrier, each CTA's out projection columns over the
//    whole attention output, and the mean over the three modalities, pushed
//    to every CTA;
// 5. after a cluster barrier, the CTA's shared units, with ReLU;
// 6. each CTA's units' share of the two heads' logits, pushed to CTA 0;
//    after a cluster barrier CTA 0 adds the K shares in rank order and the
//    biases and writes (B, classes) twice.
// A split barrier (arrive after zeroing the pushed-to buffers, wait before
// the first push) keeps every push behind every CTA's start. The next
// product's first weight chunks are copied while the previous product's
// epilogue, the attention or the mean run. Every sum has a fixed order: no
// atomics.
//
// Products (tile_gemm): 12 warps, 12 / mt on each of the mt m16 tiles, each
// owning every (12 / mt)-th n8 tile of the output columns; a weight slice
// whose chunks all fit the ring (the out projection's and the shared
// layer's at the reference shape) is copied whole and split across the
// warps by chunk as well, the parts' sums added in order. A chunk's features are summed in a permuted order, the same
// for both operands, so that a lane reads 32 contiguous bytes of a row
// (infonce.cu's scheme): lane (g, t) holds elements 8t .. 8t + 7 of a
// 32-element chunk, and k-step s takes elements 8t + 2s and 8t + 2s + 1 as
// the m16n8k8 columns t and t + 4. fp32 x fp32 takes three TF32 passes (small
// terms first; tf32_mma.cuh's split, the low word truncated); an fp32
// intermediate times a bf16 weight (exact in TF32) two; the bf16 form's
// first product (bf16 embeddings x bf16 in_proj) one m16n8k16 pass over
// 64-element chunks, its products exact and summed in fp32, as JAX's dot
// with preferred_element_type=float32. A chunk's k-steps are summed by the
// tensor cores into fresh fragments (four independent chains where a warp
// has one n8 tile), added to the accumulator in fp32. Every
// intermediate is fp32 in both forms; the bf16 form rounds only the logits
// (JAX's _kernel upcasts the same way and returns the input dtype).

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "lstm_cluster.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kMeanRows = 16;               // the mean's rows: one m16 tile (R <= 16)
constexpr int kStages = 2;                  // the weight ring's stages
constexpr int kSub = 2;                     // chunks a stage: one barrier a stage
constexpr int kRingLd = 144;                // bytes a ring row: a 128-byte chunk + 16
constexpr int kMaxSmem = 232448;            // a block's shared memory on the H100

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// One 16-byte cp.async of which the first `bytes` come from global memory
// and the rest are zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
                 : "memory");
}

// The k-chunk of a product: 64 elements where both operands are bf16 (one
// m16n8k16 pass), else 32 (TF32 passes); a ring row holds one chunk of a
// weight row, 144 bytes for a 128-byte chunk (a quarter warp's 16-byte
// reads hit 32 banks), 64 for a bf16 weight's 32 elements (two rows fill
// the banks)
template <typename EA, typename EW>
struct Prod {
    static constexpr bool kK16 = std::is_same_v<EA, bf16> && std::is_same_v<EW, bf16>;
    static constexpr int kChunk = kK16 ? 64 : 32;
    static constexpr int kRowBytes = kChunk * static_cast<int>(sizeof(EW));
    static constexpr int kLdW = kRowBytes == 128 ? kRingLd : kRowBytes;
};

// Elements a resident A row holds: F rounded up to its product's chunk, plus
// 16 bytes (rows 16 mod 128 bytes apart: conflict-free 16-byte reads)
template <typename EA, typename EW>
__host__ __device__ constexpr int a_ld(int F) {
    return round_up(F, Prod<EA, EW>::kChunk) + 16 / static_cast<int>(sizeof(EA));
}

// 8 consecutive 32-bit words of a row at `p` (16-byte aligned)
__device__ __forceinline__ void load8(const void* p, uint32_t (&w)[8]) {
    const uint4 a = reinterpret_cast<const uint4*>(p)[0];
    const uint4 b = reinterpret_cast<const uint4*>(p)[1];
    w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w, w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
}

// Elements 8t .. 8t + 7 of a TF32 chunk row as fp32 bits: 32 bytes of fp32,
// or 16 bytes of bf16 widened (exact)
template <typename E>
__device__ __forceinline__ void load_tf32_row(const E* p, uint32_t (&w)[8]) {
    if constexpr (std::is_same_v<E, float>) {
        load8(p, w);
    } else {
        const uint4 a = *reinterpret_cast<const uint4*>(p);
        const uint32_t h[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) w[2 * i] = h[i] << 16, w[2 * i + 1] = h[i] & 0xFFFF0000u;
    }
}

// A weight slice streamed through the ring: np rows (a multiple of 8) of F
// elements, its row n being row wrow(n) of W (< 0: a zero row), in chunks of
// the product's k-chunk. A thread copies the same pieces of every chunk:
// piece slot k is idx = threadIdx.x + k kThreads, ring row idx / kPieces,
// 16-byte piece idx % kPieces; its weight row is looked up once, when the
// stream is made, not once a chunk. A slice whose chunks all fit the ring,
// for a product of one m16 tile, is resident: its chunks are copied in one
// group and the product splits them across the warps (tile_gemm). Else kSub
// chunks make a ring stage, kStages stages deep.
constexpr int kMaxPieces = 8;  // np * kPieces <= 8 kThreads

template <typename EA, typename EW>
struct Stream {
    using P = Prod<EA, EW>;
    static constexpr int kPieces = P::kRowBytes / 16;
    static constexpr int kPer = 16 / static_cast<int>(sizeof(EW));  // elements a piece
    const EW* W;
    int F, np, chunks, stages;
    bool resident;
    int grow[kMaxPieces];

    template <typename RowMap>
    __device__ __forceinline__ Stream(const EW* W_, int F_, int np_, RowMap wrow, int mt,
                                      int ring_bytes)
        : W(W_), F(F_), np(np_), chunks((F_ + P::kChunk - 1) / P::kChunk),
          stages((chunks + kSub - 1) / kSub),
          resident(mt == 1 && chunks * np_ * P::kLdW <= ring_bytes && np_ / 8 <= kWarps) {
#pragma unroll
        for (int k = 0; k < kMaxPieces; ++k) {
            const int idx = threadIdx.x + k * kThreads;
            grow[k] = idx < np * kPieces ? wrow(idx / kPieces) : -1;
        }
    }

    // chunk kc's weight rows in the ring
    __device__ __forceinline__ const unsigned char* chunk(const unsigned char* ring, int kc) const {
        const int slot = resident ? kc : (kc / kSub % kStages) * kSub + kc % kSub;
        return ring + slot * np * P::kLdW;
    }

    __device__ __forceinline__ void load_chunk(int kc, unsigned char* ring) const {
        unsigned char* dst = const_cast<unsigned char*>(chunk(ring, kc));
#pragma unroll
        for (int k = 0; k < kMaxPieces; ++k) {
            const int idx = threadIdx.x + k * kThreads;
            if (idx >= np * kPieces) break;
            const int pc = idx % kPieces, e0 = kc * P::kChunk + pc * kPer;
            const int bytes = grow[k] < 0 ? 0 : max(0, min(kPer, F - e0)) * static_cast<int>(sizeof(EW));
            const EW* src = W + static_cast<size_t>(max(grow[k], 0)) * F + (bytes ? e0 : 0);
            cp_async16(dst + idx / kPieces * P::kLdW + pc * 16, src, bytes);
        }
    }

    // ring stage st's chunks, as one cp.async group (an empty group past the
    // last stage keeps the count)
    __device__ __forceinline__ void load(int st, unsigned char* ring) const {
#pragma unroll
        for (int sub = 0; sub < kSub; ++sub)
            if (st * kSub + sub < chunks) load_chunk(st * kSub + sub, ring);
        cp_async_commit();
    }

    // the pipeline's prologue: every chunk of a resident slice in one
    // group, else the first kStages - 1 stages
    __device__ __forceinline__ void prime(unsigned char* ring) const {
        if (resident) {
            for (int kc = 0; kc < chunks; ++kc) load_chunk(kc, ring);
            cp_async_commit();
            return;
        }
#pragma unroll
        for (int s = 0; s < kStages - 1; ++s) load(s, ring);
    }
};

// The products of one k-chunk (`chunk`: its weight rows in the ring) for one
// warp's rows r0, r0 + 8 and its n8 tiles j0 + jj jstep < nt, added to acc.
// The chunk's k-steps go to kCh fresh fragments an n8 tile (k-step s to
// fragment s mod kCh), so that a warp with few n8 tiles still has several
// independent chains of mma.sync; the fragments are added to acc in fp32,
// in order.
template <typename EA, typename EW, int kNt, int kCh>
__device__ __forceinline__ void chunk_products(const EA* A, int lda, int r0, int kc,
                                               const unsigned char* chunk, int j0, int jstep,
                                               int nt, int g, int t, float (&acc)[kNt][4]) {
    using P = Prod<EA, EW>;
    float c[kNt][kCh][4] = {};
    if constexpr (P::kK16) {
        // lane (g, t): words 8t .. 8t + 7 of a 64-element chunk; k-step s
        // takes words 8t + 2s (pair 2t, 2t + 1) and 8t + 2s + 1 (2t + 8, 2t + 9)
        uint32_t a0[8], a1[8];
        load8(A + r0 * lda + kc * 64 + 16 * t, a0);
        load8(A + (r0 + 8) * lda + kc * 64 + 16 * t, a1);
#pragma unroll
        for (int jj = 0; jj < kNt; ++jj) {
            const int j = j0 + jj * jstep;
            if (j >= nt) break;
            uint32_t b[8];
            load8(chunk + (8 * j + g) * P::kLdW + 32 * t, b);
#pragma unroll
            for (int s = 0; s < 4; ++s) {
                float(&f)[4] = c[jj][s % kCh];
                asm volatile(
                    "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                    "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                    : "+f"(f[0]), "+f"(f[1]), "+f"(f[2]), "+f"(f[3])
                    : "r"(a0[2 * s]), "r"(a1[2 * s]), "r"(a0[2 * s + 1]), "r"(a1[2 * s + 1]),
                      "r"(b[2 * s]), "r"(b[2 * s + 1]));
            }
        }
    } else {
        // lane (g, t): elements 8t .. 8t + 7 of a 32-element chunk; k-step s
        // takes 8t + 2s and 8t + 2s + 1 as the columns t and t + 4. The
        // passes small terms first, each over the four k-steps before the next
        constexpr bool kSplitW = std::is_same_v<EW, float>;
        uint32_t a0[8], a1[8];
        load_tf32_row(A + r0 * lda + kc * 32 + 8 * t, a0);
        load_tf32_row(A + (r0 + 8) * lda + kc * 32 + 8 * t, a1);
        uint32_t ahi[4][4], alo[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            const uint32_t a[4] = {a0[2 * s], a1[2 * s], a0[2 * s + 1], a1[2 * s + 1]};
#pragma unroll
            for (int e = 0; e < 4; ++e) split_tf32_trunc(__uint_as_float(a[e]), ahi[s][e], alo[s][e]);
        }
#pragma unroll
        for (int jj = 0; jj < kNt; ++jj) {
            const int j = j0 + jj * jstep;
            if (j >= nt) break;
            uint32_t b[8], bhi[8], blo[8];
            load_tf32_row(reinterpret_cast<const EW*>(chunk + (8 * j + g) * P::kLdW) + 8 * t, b);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                if constexpr (kSplitW) {
                    split_tf32_trunc(__uint_as_float(b[e]), bhi[e], blo[e]);
                } else {
                    bhi[e] = b[e], blo[e] = 0u;  // a bf16 weight is exact in TF32
                }
            }
#pragma unroll
            for (int s = 0; s < 4; ++s) mma_tf32(c[jj][s % kCh], alo[s], bhi[2 * s], bhi[2 * s + 1]);
            if constexpr (kSplitW) {
#pragma unroll
                for (int s = 0; s < 4; ++s)
                    mma_tf32(c[jj][s % kCh], ahi[s], blo[2 * s], blo[2 * s + 1]);
            }
#pragma unroll
            for (int s = 0; s < 4; ++s) mma_tf32(c[jj][s % kCh], ahi[s], bhi[2 * s], bhi[2 * s + 1]);
        }
    }
#pragma unroll
    for (int jj = 0; jj < kNt; ++jj)
#pragma unroll
        for (int ch = 0; ch < kCh; ++ch)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[jj][e] += c[jj][ch][e];
}

// out(row, n) = sum_k A[row][k] W[wrow(n)][k] for the mt m16 tiles of A
// (resident in shared memory, rows lda elements apart, zero past F) and the
// stream's np output columns; epi(row, n, value) stores each result. The
// stream's first chunks are in flight already (Stream::prime, by the caller
// or by the previous product's `then`). then() runs once the ring and A are
// free, before the epilogue: it may prime the next product's stream, whose
// copies then overlap this epilogue and whatever comes before that product.
//
// A streamed slice: warp w takes m16 tile w / (12 / mt) and every (12 /
// mt)-th n8 tile, one ring stage a barrier. A resident slice (one m16
// tile): warp w takes n8 tile w mod nt and every kp-th chunk from w / nt
// (kp = 12 / nt parts of the k axis, so that a product with few n8 tiles
// still keeps every warp busy); the parts' sums meet in `scratch`, added in
// part order.
template <typename EA, typename EW, int kNt, typename Epi, typename Then>
__device__ __forceinline__ void tile_gemm(const EA* A, int lda, int mt,
                                          const Stream<EA, EW>& w, unsigned char* ring,
                                          float* scratch, Epi epi, Then then) {
    constexpr int kCh = kNt >= 4 ? 1 : 4 / kNt;
    const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
    const int nt = w.np / 8;
    if (w.resident) {
        cp_async_wait<0>();
        __syncthreads();
        const int parts = kWarps / nt, j = warp % nt, part = warp / nt;
        float acc[1][4] = {};
        if (part < parts)
            for (int kc = part; kc < w.chunks; kc += parts)
                chunk_products<EA, EW, 1, 4>(A, lda, g, kc, w.chunk(ring, kc), j, 1, nt, g, t,
                                             acc);
        if (part < parts) {
            float* dst = scratch + part * 16 * w.np + 8 * j + 2 * t;
            dst[g * w.np] = acc[0][0];
            dst[g * w.np + 1] = acc[0][1];
            dst[(g + 8) * w.np] = acc[0][2];
            dst[(g + 8) * w.np + 1] = acc[0][3];
        }
        __syncthreads();  // every warp is done with A and the ring
        then();
        for (int idx = threadIdx.x; idx < 16 * w.np; idx += kThreads) {
            float v = 0.0f;
            for (int p = 0; p < parts; ++p) v += scratch[p * 16 * w.np + idx];
            epi(idx / w.np, idx % w.np, v);
        }
        return;
    }
    const int wpm = kWarps / mt;  // warps on one m16 tile
    const int j0 = warp % wpm, r0 = 16 * (warp / wpm) + g;
    float acc[kNt][4] = {};
    for (int st = 0; st < w.stages; ++st) {
        cp_async_wait<kStages - 2>();  // this stage has landed (this thread's copies)
        __syncthreads();               // ... every thread's; the oldest stage is free
        w.load(st + kStages - 1, ring);
        if (j0 >= nt) continue;  // a warp with no n8 tile skips the products
#pragma unroll
        for (int sub = 0; sub < kSub; ++sub) {
            const int kc = st * kSub + sub;
            if (kc >= w.chunks) break;
            chunk_products<EA, EW, kNt, kCh>(A, lda, r0, kc, w.chunk(ring, kc), j0, wpm, nt, g, t,
                                             acc);
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with A and the ring
    then();
#pragma unroll
    for (int jj = 0; jj < kNt; ++jj) {
        const int j = j0 + jj * wpm;
        if (j >= nt) break;
        const int n = 8 * j + 2 * t;
        epi(r0, n, acc[jj][0]);
        epi(r0, n + 1, acc[jj][1]);
        epi(r0 + 8, n, acc[jj][2]);
        epi(r0 + 8, n + 1, acc[jj][3]);
    }
}

// Shared memory of one CTA, in bytes from the start; a tile of R batch rows
// has 3R rows (modality-major) padded to rows = 16 mt:
//   ring: the weight ring, kStages stages of the widest product's rows
//   xs: the embeddings (rows, ldx) E -> the shared layer (16, np_sh) fp32
//   att: the attention output (rows, lda) fp32, pushed by the cluster
//   r2: q | k | v of the own heads (rows, ldq) -> the out projection
//       (rows, np_out), fp32
//   mean: the modality mean (16, lda) fp32, pushed by the cluster
//   part: each CTA's share of the logits (K, 16, 2 classes) fp32, pushed to
//       CTA 0
//   cols: q | k | v's in_proj rows (np_in) int, the three products' biases
//       (np_in, np_out, np_sh) fp32
//   scratch: a resident product's partial sums (parts, 16, np), parts np / 8
//       <= 12 n8 tiles
struct Layout {
    int rows, np_in, np_out, np_sh, ldx, lda, ldq, units;
    int ring, xs, att, r2, mean, part, cols, scratch, total;
};

template <typename E>
__host__ __device__ inline Layout layout(int R, int F, int H, int hidden, int ncls, int K) {
    Layout l;
    const int nh = H / K, dh = F / H;
    l.rows = round_up(3 * R, 16);
    l.units = (hidden + K - 1) / K;
    l.np_in = round_up(3 * nh * dh, 8);
    l.np_out = round_up(F / K, 8);
    l.np_sh = round_up(l.units, 8);
    l.ldx = a_ld<E, E>(F);
    l.lda = a_ld<float, E>(F);
    l.ldq = l.np_in + 4;  // rows 4 banks apart: the attention's reads hit 32 banks
    const int np = imax(l.np_in, imax(l.np_out, l.np_sh));
    l.ring = 0;
    l.xs = kStages * kSub * np * kRingLd;
    l.att = l.xs + round_up(imax(l.rows * l.ldx * static_cast<int>(sizeof(E)),
                                 4 * kMeanRows * l.np_sh), 16);
    l.r2 = l.att + 4 * l.rows * l.lda;
    l.mean = l.r2 + 4 * l.rows * imax(l.ldq, l.np_out);
    l.part = l.mean + 4 * kMeanRows * l.lda;
    l.cols = l.part + 4 * K * kMeanRows * 2 * ncls;
    l.scratch = l.cols + round_up(4 * (2 * l.np_in + l.np_out + l.np_sh), 16);
    l.total = l.scratch + 4 * kWarps * 16 * 8;
    return l;
}

template <typename E, int kNt>
__global__ void __launch_bounds__(kThreads, 1)
fusion_head_kernel(const E* __restrict__ xe, const E* __restrict__ xy, const E* __restrict__ xp,
                   const E* __restrict__ w_in, const E* __restrict__ b_in,    // (3F, F), (3F,)
                   const E* __restrict__ w_out, const E* __restrict__ b_out,  // (F, F), (F,)
                   const E* __restrict__ w_sh, const E* __restrict__ b_sh,    // (Hd, F), (Hd,)
                   const E* __restrict__ w_a, const E* __restrict__ b_a,      // (C, Hd), (C,)
                   const E* __restrict__ w_v, const E* __restrict__ b_v,      // (C, Hd), (C,)
                   E* __restrict__ oa, E* __restrict__ ov,                    // (B, C)
                   int B, int R, int F, int H, int hidden, int ncls) {
    extern __shared__ __align__(16) unsigned char smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int K = static_cast<int>(cluster.num_blocks());
    const int r = static_cast<int>(cluster.block_rank());
    const int b0 = blockIdx.x / K * R;
    const Layout l = layout<E>(R, F, H, hidden, ncls, K);
    const int nh = H / K, dh = F / H, fk = F / K, own = nh * dh, mt = l.rows / 16;
    unsigned char* ring = smem + l.ring;
    E* xs = reinterpret_cast<E*>(smem + l.xs);
    float* sh = reinterpret_cast<float*>(smem + l.xs);
    float* att = reinterpret_cast<float*>(smem + l.att);
    float* qkv = reinterpret_cast<float*>(smem + l.r2);
    float* outp = qkv;
    float* mean = reinterpret_cast<float*>(smem + l.mean);
    float* part = reinterpret_cast<float*>(smem + l.part);
    int* col_in = reinterpret_cast<int*>(smem + l.cols);
    float* bias_in = reinterpret_cast<float*>(col_in + l.np_in);
    float* bias_out = bias_in + l.np_in;
    float* bias_sh = bias_out + l.np_out;
    float* scratch = reinterpret_cast<float*>(smem + l.scratch);
    const int ring_bytes = l.xs - l.ring;

    // 1. the tile's embeddings (rows past 3R or B and features past F
    // zero): a warp a row, a lane a 16-byte piece
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    {
        constexpr int kPer = 16 / sizeof(E);
        const int pieces = l.ldx / kPer - 1;  // the row's chunks, not its pad
        for (int row = warp; row < l.rows; row += kWarps) {
            const int m = row < R ? 0 : row < 2 * R ? 1 : row < 3 * R ? 2 : 3;
            const int b = b0 + row - m * R;
            const E* x = m == 0 ? xe : (m == 1 ? xy : xp);
            const bool real = m < 3 && b < B;
            for (int pc = lane; pc < pieces; pc += 32) {
                const int e0 = pc * kPer;
                const int bytes = real ? max(0, min(kPer, F - e0)) * static_cast<int>(sizeof(E)) : 0;
                cp_async16(xs + row * l.ldx + e0,
                           x + static_cast<size_t>(bytes ? b : 0) * F + (bytes ? e0 : 0), bytes);
            }
        }
        cp_async_commit();
    }
    // each product's local columns, looked up once: in_proj row and bias of
    // q | k | v column (p nh + j) dh + d, row p F + (r + j K) dh + d (p 0, 1,
    // 2: q, k, v; -1 past them); the out projection's and shared layer's
    // biases (0 past their columns)
    const int u0 = r * l.units, units = max(0, min(hidden - u0, l.units));
    for (int n = threadIdx.x; n < l.np_in; n += kThreads) {
        int grow = -1;
        if (n < 3 * own) {
            const int p = n / own, j = n % own / dh;
            grow = p * F + (r + j * K) * dh + n % dh;
        }
        col_in[n] = grow;
        bias_in[n] = grow < 0 ? 0.0f : to_float(b_in[grow]);
    }
    for (int n = threadIdx.x; n < l.np_out; n += kThreads)
        bias_out[n] = n < fk ? to_float(b_out[r * fk + n]) : 0.0f;
    for (int n = threadIdx.x; n < l.np_sh; n += kThreads)
        bias_sh[n] = n < units ? to_float(b_sh[u0 + n]) : 0.0f;
    __syncthreads();
    auto in_row = [&](int n) { return col_in[n]; };
    auto out_row = [&](int n) { return n < fk ? r * fk + n : -1; };
    auto sh_row = [&](int n) { return n < units ? u0 + n : -1; };
    const Stream<E, E> s_in(w_in, F, l.np_in, in_row, mt, ring_bytes);
    s_in.prime(ring);
    // the buffers the cluster pushes into start at zero (their padding rows
    // and columns stay so); then the barrier's first half: no CTA writes to
    // another before both have started and zeroed
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = threadIdx.x; i < l.rows * l.lda / 4; i += kThreads)
        reinterpret_cast<float4*>(att)[i] = zero;
    for (int i = threadIdx.x; i < kMeanRows * l.lda / 4; i += kThreads)
        reinterpret_cast<float4*>(mean)[i] = zero;
    cluster_arrive();

    // 2. q | k | v of the own heads; the out projection's first chunks are
    // copied during the epilogue and the attention
    tile_gemm<E, E, kNt>(
        xs, l.ldx, mt, s_in, ring, scratch,
        [&](int row, int n, float v) {
            if (n < 3 * own) qkv[row * l.ldq + n] = v + bias_in[n];
        },
        [&] { Stream<float, E>(w_out, F, l.np_out, out_row, mt, ring_bytes).prime(ring); });
    __syncthreads();

    // 3. per (row, own head), 8 lanes: the three scores by xor shuffles
    // within the 8, the 3x3 softmax, p . v, each value pushed to every CTA
    // of the cluster (the barrier's second half first). Where dh is a
    // multiple of 32 a lane owns dh / 8 consecutive entries and pushes them
    // as 16-byte stores; else entries sub, sub + 8, ...
    cluster_wait();
    {
        const float scale = 1.0f / sqrtf(static_cast<float>(dh));
        const int sub = threadIdx.x % 8;
        const bool vec = dh % 32 == 0;
        const int d0 = vec ? sub * (dh / 8) : sub, step = vec ? 1 : 8;
        const int d1 = vec ? d0 + dh / 8 : dh;
        for (int task = threadIdx.x / 8; task < 3 * R * nh; task += kThreads / 8) {
            const int row = task % (3 * R), j = task / (3 * R);
            const int i = row % R;
            const float* q = qkv + row * l.ldq + j * dh;
            float s[3];
#pragma unroll
            for (int mj = 0; mj < 3; ++mj) {
                const float* k = qkv + (mj * R + i) * l.ldq + own + j * dh;
                float acc = 0.0f;
                for (int d = d0; d < d1; d += step) acc = fmaf(q[d], k[d], acc);
#pragma unroll
                for (int off = 4; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
                s[mj] = acc * scale;
            }
            const float mx = fmaxf(fmaxf(s[0], s[1]), s[2]);
            float e[3];
#pragma unroll
            for (int mj = 0; mj < 3; ++mj) e[mj] = expf(s[mj] - mx);
            const float den = e[0] + e[1] + e[2];
            const float p0 = e[0] / den, p1 = e[1] / den, p2 = e[2] / den;
            const float* v0 = qkv + i * l.ldq + 2 * own + j * dh;
            const float* v1 = v0 + R * l.ldq;
            const float* v2 = v1 + R * l.ldq;
            const int at = row * l.lda + (r + j * K) * dh;
            if (vec) {
                for (int d = d0; d < d1; d += 4) {
                    float4 v;
                    v.x = p0 * v0[d] + p1 * v1[d] + p2 * v2[d];
                    v.y = p0 * v0[d + 1] + p1 * v1[d + 1] + p2 * v2[d + 1];
                    v.z = p0 * v0[d + 2] + p1 * v1[d + 2] + p2 * v2[d + 2];
                    v.w = p0 * v0[d + 3] + p1 * v1[d + 3] + p2 * v2[d + 3];
                    for (int q2 = 0; q2 < K; ++q2)
                        *reinterpret_cast<float4*>(cluster.map_shared_rank(att, q2) + at + d) = v;
                }
            } else {
                for (int d = d0; d < d1; d += step) {
                    const float v = p0 * v0[d] + p1 * v1[d] + p2 * v2[d];
                    for (int q2 = 0; q2 < K; ++q2) cluster.map_shared_rank(att, q2)[at + d] = v;
                }
            }
        }
    }
    cluster.sync();

    // 4. the out projection's own columns over the whole attention output;
    // the shared layer's first chunks are copied during the epilogue and
    // the mean; the mean over the modalities pushed to every CTA
    tile_gemm<float, E, kNt>(
        att, l.lda, mt, Stream<float, E>(w_out, F, l.np_out, out_row, mt, ring_bytes), ring, scratch,
        [&](int row, int n, float v) {
            if (n < fk) outp[row * l.np_out + n] = v + bias_out[n];
        },
        [&] { Stream<float, E>(w_sh, F, l.np_sh, sh_row, 1, ring_bytes).prime(ring); });
    __syncthreads();
    for (int idx = threadIdx.x; idx < R * fk; idx += kThreads) {
        const int i = idx / fk, n = idx % fk;
        const float v = (outp[i * l.np_out + n] + outp[(R + i) * l.np_out + n] +
                         outp[(2 * R + i) * l.np_out + n]) / 3.0f;
        for (int q2 = 0; q2 < K; ++q2) cluster.map_shared_rank(mean, q2)[i * l.lda + r * fk + n] = v;
    }
    cluster.sync();

    // 5. the own shared units, with ReLU
    tile_gemm<float, E, kNt>(
        mean, l.lda, 1, Stream<float, E>(w_sh, F, l.np_sh, sh_row, 1, ring_bytes), ring, scratch,
        [&](int row, int n, float v) {
            if (n < units) sh[row * l.np_sh + n] = fmaxf(v + bias_sh[n], 0.0f);
        },
        [] {});
    __syncthreads();

    // 6. the own units' share of each logit, pushed to CTA 0, which adds the
    // K shares in rank order and the biases
    const int per = kMeanRows * 2 * ncls;
    float* part0 = cluster.map_shared_rank(part, 0);
    for (int idx = threadIdx.x; idx < R * 2 * ncls; idx += kThreads) {
        const int i = idx / (2 * ncls), c = idx % (2 * ncls);
        const E* w = (c < ncls ? w_a + c * hidden : w_v + (c - ncls) * hidden) + u0;
        float acc = 0.0f;
        for (int u = 0; u < units; ++u) acc = fmaf(to_float(w[u]), sh[i * l.np_sh + u], acc);
        part0[r * per + idx] = acc;
    }
    cluster.sync();
    if (r == 0) {
        for (int idx = threadIdx.x; idx < R * 2 * ncls; idx += kThreads) {
            const int i = idx / (2 * ncls), c = idx % (2 * ncls);
            if (b0 + i >= B) continue;
            float acc = 0.0f;
            for (int q2 = 0; q2 < K; ++q2) acc += part[q2 * per + idx];
            if (c < ncls)
                oa[(b0 + i) * ncls + c] = from_float<E>(acc + to_float(b_a[c]));
            else
                ov[(b0 + i) * ncls + c - ncls] = from_float<E>(acc + to_float(b_v[c - ncls]));
        }
    }
}

// n8 tiles a warp owns in the widest product: kWarps / mt warps on each m16
// tile of q | k | v and of the out projection, all of them on the shared
// layer's one
inline int tiles_per_warp(const Layout& l) {
    const int per = kWarps / (l.rows / 16);
    return imax(imax((l.np_in / 8 + per - 1) / per, (l.np_out / 8 + per - 1) / per),
                (l.np_sh / 8 + kWarps - 1) / kWarps);
}

template <typename E>
int launch(const E* xe, const E* xy, const E* xp, const E* w_in, const E* b_in, const E* w_out,
           const E* b_out, const E* w_sh, const E* b_sh, const E* w_a, const E* b_a,
           const E* w_v, const E* b_v, E* oa, E* ov, int B, int R, int F, int H, int hidden,
           int ncls, int K, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    // the wrapper's limits (kernels/fusion_head.py::plan)
    if (K < 1 || K > 8 || H % K || F % H || F % 4 || B < 1 || (R != 4 && R != 8 && R != 16))
        return cudaErrorInvalidValue;
    const Layout l = layout<E>(R, F, H, hidden, ncls, K);
    const int nt = tiles_per_warp(l);
    const int kPieces = 8;  // 16-byte pieces of a 128-byte ring row, the most a row has
    if (l.total > kMaxSmem || nt > 8 ||
        imax(l.np_in, imax(l.np_out, l.np_sh)) * kPieces > kMaxPieces * kThreads)
        return cudaErrorInvalidValue;
    const int nclusters = (B + R - 1) / R;
    auto run = [&](auto kernel) {
        return launch_cluster(kernel, K, nclusters, kThreads, l.total, stream, xe, xy, xp, w_in,
                              b_in, w_out, b_out, w_sh, b_sh, w_a, b_a, w_v, b_v, oa, ov, B, R,
                              F, H, hidden, ncls);
    };
    if (nt <= 1) return run(fusion_head_kernel<E, 1>);
    if (nt <= 2) return run(fusion_head_kernel<E, 2>);
    if (nt <= 4) return run(fusion_head_kernel<E, 4>);
    return run(fusion_head_kernel<E, 8>);
}

}  // namespace

extern "C" int msa_fusion_head(const float* xe, const float* xy, const float* xp,
                               const float* w_in, const float* b_in, const float* w_out,
                               const float* b_out, const float* w_sh, const float* b_sh,
                               const float* w_a, const float* b_a, const float* w_v,
                               const float* b_v, float* oa, float* ov, int B, int R, int F,
                               int H, int hidden, int ncls, int K, int device, void* stream) {
    return launch(xe, xy, xp, w_in, b_in, w_out, b_out, w_sh, b_sh, w_a, b_a, w_v, b_v, oa, ov,
                  B, R, F, H, hidden, ncls, K, device, stream);
}

extern "C" int msa_fusion_head_bf16(const bf16* xe, const bf16* xy, const bf16* xp,
                                    const bf16* w_in, const bf16* b_in, const bf16* w_out,
                                    const bf16* b_out, const bf16* w_sh, const bf16* b_sh,
                                    const bf16* w_a, const bf16* b_a, const bf16* w_v,
                                    const bf16* b_v, bf16* oa, bf16* ov, int B, int R, int F,
                                    int H, int hidden, int ncls, int K, int device,
                                    void* stream) {
    return launch(xe, xy, xp, w_in, b_in, w_out, b_out, w_sh, b_sh, w_a, b_a, w_v, b_v, oa, ov,
                  B, R, F, H, hidden, ncls, K, device, stream);
}
