// The bf16 flash-attention backward for Hopper: dQ by query tile and dK/dV
// by key tile, on wgmma, TMA and mbarriers (sm90.cuh). The bf16 forms of
// flash_attn.cu's two backward kernels.
//
// Replaces multimodal_sentiment_aanalysis_tpu/kernels/attention.py as the TPU
// kernels run on bf16 q, k, v and dO (Precision.DEFAULT):
// - msa_flash_bwd_dq_bf16   -> _bwd_dq_kernel: dQ = sum_j dS_ij K_j with
//                              P = exp(S - LSE) and dS = P (dO V^T - delta);
// - msa_flash_bwd_dkv_bf16  -> _bwd_dkv_kernel: dV = P^T dO, dK = dS^T Q.
// Q is pre-scaled by 1/sqrt(D) in bf16 by the wrapper, as the JAX entry
// scales it; delta = rowsum(dO * O) is formed by the wrapper as JAX forms it,
// in the operands' dtype (a bf16 sum of the bf16 products), and passed as
// fp32. Arithmetic, the TPU's under DEFAULT precision: every product is bf16
// x bf16 with fp32 accumulation; P = exp(S - LSE) and dS = P (dP - delta) are
// formed in fp32 and rounded to bf16 only as the A operand of a product; dQ,
// dK and dV are stored as bf16. Masking: rows past the end arrive as zeros
// (TMA's out-of-bounds fill), the P of keys past tk (dQ) and of queries past
// tq (dK/dV) is set to 0, and no row past the end is stored.
//
// What bounds them on the H100: at the attention phase's (BH = 512, T = 585,
// D = 32) dQ's three products are 33.6 GFLOP and dK/dV's four 44.9, 0.034
// and 0.045 ms at 989 TFLOP/s; their bf16 operands and outputs 77-96 MB,
// 0.023-0.029 ms at 3.35 TB/s. Each kernel also recomputes P: 175.2 M exp2,
// ~0.042 ms at 16 a clock an SM (132 SMs, 1.98 GHz), as long as the products.
// So the design must keep the tensor cores and the exp units busy at once.
//
// Design. One persistent CTA an SM walks work items: a block of 128 own rows
// of one head (dQ: queries; dK/dV: keys), whatever the wrapper's block for
// that side, a head's blocks adjacent so that its streamed side comes from
// memory once and from L2 for the rest. Two consumer warpgroups hold 64 of
// the rows each, 16 a warp; a producer warpgroup feeds them (384 threads;
// setmaxnreg moves the producer's registers to the consumers). The output
// rows are independent and each one's sum runs over the streamed side in
// one order, so the tiling of the own side changes no bit of the result.
// No atomics: each output is owned by one warpgroup, and the gradients are
// deterministic.
// - TMA: one producer thread loads an item's two own operands (once the
//   consumers have taken the last item's), then streams the other side's
//   tiles (block rows of two operands: dQ K and V, dK/dV Q and dO) through
//   a ring of 2-4 stages that runs on from item to item, so that the next
//   item's loads overlap this item's work. Each stage is an mbarrier the
//   loads complete (expect_tx) and another the consumers' eight warps
//   arrive on when its last product has retired. Each operand is a 3-D map
//   {D, T, BH}, so rows past T arrive as zeros, not as the next head's; a
//   row is one swizzle span (32, 64 or 128 bytes for D = 16, 32, 64) or, at
//   D = 128, two boxes of 64 columns.
// - wgmma: the consumer takes a stage in sub-tiles of kSub streamed rows. dQ
//   forms S = Q K^T and dP = dO V^T (m64n{kSub}k16, B the streamed tile
//   K-major), then dQ += dS K; dK/dV forms S^T = K Q^T and dP^T = V dO^T,
//   then dV += P^T dO and dK += dS^T Q. The own operands are A: up to D = 64
//   as register fragments read once from the own tiles (so that the tensor
//   cores read only B from shared memory), at D = 128 from the own tiles
//   through descriptors. The accumulators of S and dP, turned into P, dS
//   (dQ) or P^T, dS^T (dK/dV) and packed to bf16 pairs, are the register A
//   operand of the accumulating products (m64n{D}k16, two m64n64k16 at D =
//   128), whose B is the streamed tile read MN-major through the transpose
//   bit. LSE and delta do not go through TMA (a head's fp32 row is not a
//   multiple of 16 bytes): a second producer warp loads an item's own rows'
//   (dQ) or each stage's queries' (dK/dV) with ordinary loads into shared
//   memory beside the tiles (a wgmma.fence waits for the loads a warp has in
//   flight, so consumer loads ahead of a sub-tile stalled every fence: 0.35
//   against 0.19 ms at the attention phase's shape without them,
//   scripts/bench_flash_bwd.py on the H100).
// - Overlap: the next sub-tile's S and dP are issued before this sub-tile's
//   exp and dS arithmetic (two register sets, one commit group each), so the
//   tensor cores run them while the warps run the exp2; the accumulating
//   products follow in their own group, and every group retires within the
//   sub-tile (a wgmma in flight across a branch or the loop's back edge,
//   whose registers ordinary code writes elsewhere in the loop, makes ptxas
//   serialise every wgmma).
// - The exp loop is bound by instruction issue and the exp units: one
//   ex2.approx.ftz a score (exp2f's subnormal handling costs three more
//   instructions), and the mask of the streamed side's end only in the last
//   sub-tile.
// kSub is 32 (dK/dV at D = 128: 16, so that dK, dV and two sets of S^T and
// dP^T fit the consumer's registers; 64 measured no faster).

#include <math.h>

#include <cstdint>

#include "flash_sm90.cuh"

namespace {

using namespace flash_sm90;

// A backward CTA's shared memory, from a 1024-byte boundary (the 128-byte
// swizzle's period): the two own tiles (kOwnRows rows), a ring of kStages
// stages of two streamed tiles (kBt rows), for dK/dV each stage's columns
// (the kBt queries' LSE log2 e, then their delta, fp32), for dQ the own
// rows' LSE log2 e and delta, then the mbarriers (own_full, own_empty,
// full[], empty[]). A tile is one box of rows of span_of(D) bytes, two at D
// = 128. kStages: as many as fit 64 KiB of tiles, 2 to 4
template <int D, int kBt, bool kDkv>
struct BwdPlan {
    static constexpr bool kIsDkv = kDkv;
    static constexpr int kSub = kDkv && D == 128 ? 16 : 32;
    static constexpr int kOwnTile = kOwnRows * 2 * D;
    static constexpr int kTile = kBt * 2 * D;
    static constexpr int kStage = 2 * kTile;
    static constexpr int kFit = 65536 / kStage;
    static constexpr int kStages = kFit < 2 ? 2 : kFit > 4 ? 4 : kFit;
    static constexpr int kColBytes = kDkv ? 2 * kBt * 4 : 0;  // a stage's columns
    static constexpr int kOwnColBytes = kDkv ? 0 : 2 * kOwnRows * 4;  // the own rows' (dQ)
    static constexpr size_t kSmem = 1024 + 2 * kOwnTile + kStages * (kStage + kColBytes) +
                                    kOwnColBytes + 8 * (2 + 2 * kStages);
    static_assert(kBt % kSub == 0, "a stage holds whole sub-tiles");
};

// The shared memory of a plan, its tiles from a 1024-byte boundary
struct BwdSmem {
    uint8_t *own0, *own1, *ring;
    float* cols;      // dK/dV: kStages x (LSE log2 e, delta) of kBt queries
    float* own_cols;  // dQ: (LSE log2 e, delta) of the kOwnRows own queries
    uint64_t *own_full, *own_empty, *full, *empty;
};

template <typename Plan>
__device__ __forceinline__ BwdSmem carve(uint8_t* raw) {
    uint8_t* base = raw + ((1024 - (sm90::smem_addr(raw) & 1023)) & 1023);
    BwdSmem m;
    m.own0 = base;
    m.own1 = base + Plan::kOwnTile;
    m.ring = base + 2 * Plan::kOwnTile;
    m.cols = reinterpret_cast<float*>(m.ring + Plan::kStages * Plan::kStage);
    m.own_cols = m.cols + Plan::kStages * Plan::kColBytes / 4;
    m.own_full = reinterpret_cast<uint64_t*>(m.own_cols + Plan::kOwnColBytes / 4);
    m.own_empty = m.own_full + 1;
    m.full = m.own_full + 2;
    m.empty = m.full + Plan::kStages;
    if (threadIdx.x == 0) {
        // arrivals: the TMA thread's expect_tx, and where the producer's
        // second warp fills columns, its lanes; one a consumer warp
        sm90::mbar_init(m.own_full, Plan::kIsDkv ? 1 : 33);
        sm90::mbar_init(m.own_empty, 4 * kConsumers);
        for (int st = 0; st < Plan::kStages; ++st) {
            sm90::mbar_init(m.full + st, Plan::kIsDkv ? 33 : 1);
            sm90::mbar_init(m.empty + st, 4 * kConsumers);
        }
        sm90::fence_barrier_init();
    }
    __syncthreads();
    return m;
}

// The producer warpgroup: gives up registers. Its first warp's lane 0 loads
// each item's own tiles (once the consumers are done with the last item's)
// and then its n streamed tiles by TMA through the ring; its second warp
// fills, with ordinary loads, dQ's own rows' LSE and delta or each dK/dV
// stage's columns, and its lanes arrive. Those loads stay out of the
// consumers: a wgmma.fence waits for a warp's loads in flight
template <typename Plan, int D>
__device__ __forceinline__ void produce(const BwdSmem& m, const CUtensorMap* own0_map,
                                        const CUtensorMap* own1_map, const CUtensorMap* a_map,
                                        const CUtensorMap* b_map, Work w, int n,
                                        const float* lse, const float* delta, int tq) {
    sm90::setmaxnreg_dec<kProducerRegs>();
    constexpr int kStages = Plan::kStages, kBt = Plan::kTile / (2 * D);
    const int warp = threadIdx.x / 32 - 4 * kConsumers, lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0) {
        sm90::prefetch_map(a_map);
        sm90::prefetch_map(b_map);
        int it = 0, k = 0;
        for (int item = blockIdx.x; item < w.items; item += gridDim.x, ++k) {
            const int bh = w.head(item), own0 = w.row0(item);
            if (k > 0) sm90::mbar_wait(m.own_empty, (k - 1) & 1);
            sm90::mbar_expect_tx(m.own_full, 2 * Plan::kOwnTile);
            load_tile<D>(m.own0, own0_map, m.own_full, own0, bh, kOwnRows);
            load_tile<D>(m.own1, own1_map, m.own_full, own0, bh, kOwnRows);
            for (int t = 0; t < n; ++t, ++it) {
                const int slot = it % kStages;
                // the stage's previous tile (it - kStages) has been released
                if (it >= kStages) sm90::mbar_wait(m.empty + slot, ((it / kStages) & 1) ^ 1);
                uint8_t* stage = m.ring + slot * Plan::kStage;
                sm90::mbar_expect_tx(m.full + slot, Plan::kStage);
                load_tile<D>(stage, a_map, m.full + slot, t * kBt, bh, kBt);
                load_tile<D>(stage + Plan::kTile, b_map, m.full + slot, t * kBt, bh, kBt);
            }
        }
    } else if (warp == 1) {
        int it = 0, k = 0;
        for (int item = blockIdx.x; item < w.items; item += gridDim.x, ++k) {
            const size_t head = static_cast<size_t>(w.head(item)) * tq;
            if constexpr (!Plan::kIsDkv) {
                if (k > 0) sm90::mbar_wait(m.own_empty, (k - 1) & 1);
                for (int e = lane; e < kOwnRows; e += 32) {
                    const int c = w.row0(item) + e;
                    m.own_cols[e] = c < tq ? lse[head + c] * kLog2e : 0.0f;
                    m.own_cols[kOwnRows + e] = c < tq ? delta[head + c] : 0.0f;
                }
                sm90::mbar_arrive(m.own_full);  // release: visible to its waiters
            } else {
                for (int t = 0; t < n; ++t, ++it) {
                    const int slot = it % kStages;
                    if (it >= kStages) sm90::mbar_wait(m.empty + slot, ((it / kStages) & 1) ^ 1);
                    float* cols = m.cols + slot * 2 * kBt;
                    for (int e = lane; e < kBt; e += 32) {
                        const int c = t * kBt + e;
                        cols[e] = c < tq ? lse[head + c] * kLog2e : 0.0f;
                        cols[kBt + e] = c < tq ? delta[head + c] : 0.0f;
                    }
                    sm90::mbar_arrive(m.full + slot);
                }
            }
        }
    }
}

// A consumer warpgroup's walk over one item's streamed sub-tiles (its 64
// own rows from own_row; the item's first tile the ring's it0-th), shared
// by the two kernels: Op holds what differs (the sub-tile's products and its
// P / dS arithmetic). Each body(i) starts with S and dP of sub-tile i
// retired into s and p. With kNext it first issues S and dP of i + 1 into
// sn and pn (waiting for that stage), so that the tensor cores run them
// beside this sub-tile's exp; then the arithmetic and the products of i; then
// it waits for all of it, so that no wgmma is in flight across a branch or
// the loop's back edge (ptxas would serialise every wgmma), and releases
// the stage i finishes. The two register sets alternate, the loop unrolled
// by two, so that every register index is static
template <typename Op>
struct Consumer {
    static constexpr int N = Op::kSub, kRegs = N / 2, kSpt = Op::kBt / N;
    static constexpr int kStages = Op::Plan::kStages;
    // up to D = 64 the own rows wait in registers as A fragments (the S and
    // dP products then read only B from shared memory); at D = 128 the
    // accumulators leave no room, and A comes from the own tile
    static constexpr bool kOwnRegs = Op::kD <= 64;
    Op& op;
    const BwdSmem& m;
    int lane, own_row, it0;
    uint32_t own0[kOwnRegs ? Op::kD / 16 : 1][4], own1[kOwnRegs ? Op::kD / 16 : 1][4];

    __device__ __forceinline__ const uint8_t* stage(int i) const {
        return m.ring + ((it0 + i / kSpt) % kStages) * Op::Plan::kStage;
    }
    // this sub-tile's columns (dK/dV)
    __device__ __forceinline__ const float* cols(int i) const {
        return m.cols + ((it0 + i / kSpt) % kStages) * 2 * Op::kBt + (i % kSpt) * N;
    }
    // the own rows' A fragments, up to D = 64
    __device__ __forceinline__ void load_own() {
        if constexpr (kOwnRegs) {
            const int r0 = 16 * (threadIdx.x / 32) + lane / 4;
            own_fragments<Op::kD>(own0, m.own0, r0);
            own_fragments<Op::kD>(own1, m.own1, r0);
        }
    }
    // S and dP (dK/dV: their transposes) of sub-tile i into s and p, one
    // commit group
    __device__ __forceinline__ void issue(int i, float (&s)[kRegs], float (&p)[kRegs]) {
        sm90::fence_regs(s);
        sm90::fence_regs(p);
        sm90::fence_regs(own0);
        sm90::fence_regs(own1);
        sm90::wgmma_fence();
        const uint8_t* st = stage(i);
        const int row = (i % kSpt) * N;
        if constexpr (kOwnRegs) {
            rs_product_k<Op::kD>(s, own0, st, Op::kBt, row);
            rs_product_k<Op::kD>(p, own1, st + Op::Plan::kTile, Op::kBt, row);
        } else {
            ss_product<Op::kD>(s, m.own0, own_row, st, Op::kBt, row);
            ss_product<Op::kD>(p, m.own1, own_row, st + Op::Plan::kTile, Op::kBt, row);
        }
        sm90::wgmma_commit();
        sm90::fence_regs(s);
        sm90::fence_regs(p);
        sm90::fence_regs(own0);
        sm90::fence_regs(own1);
    }
    template <bool kNext>
    __device__ __forceinline__ void body(int i, float (&s)[kRegs], float (&p)[kRegs],
                                         float (&sn)[kRegs], float (&pn)[kRegs]) {
        if constexpr (kNext) {
            const int tile = it0 + (i + 1) / kSpt;
            if ((i + 1) % kSpt == 0) sm90::mbar_wait(m.full + tile % kStages, (tile / kStages) & 1);
            issue(i + 1, sn, pn);
        }
        // only the last sub-tile reaches past the end of the streamed side
        op.template products<!kNext>(i, s, p, stage(i), (i % kSpt) * N, cols(i));
        sm90::wgmma_wait<0>();
        op.retired();
        if constexpr (kNext) {
            sm90::fence_regs(sn);
            sm90::fence_regs(pn);
        }
        // the item's last sub-tile finishes its (perhaps partial) last tile
        if ((!kNext || (i + 1) % kSpt == 0) && lane == 0)
            sm90::mbar_arrive(m.empty + (it0 + i / kSpt) % kStages);
    }
    __device__ __forceinline__ void run(int nsub) {
        float s0[kRegs], p0[kRegs], s1[kRegs], p1[kRegs];
        sm90::mbar_wait(m.full + it0 % kStages, (it0 / kStages) & 1);
        issue(0, s0, p0);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s0);
        sm90::fence_regs(p0);
        int i = 0;
        for (; i + 2 < nsub; i += 2) {
            body<true>(i, s0, p0, s1, p1);
            body<true>(i + 1, s1, p1, s0, p0);
        }
        if (i + 1 < nsub) {
            body<true>(i, s0, p0, s1, p1);
            body<false>(i + 1, s1, p1, s0, p0);
        } else {
            body<false>(i, s0, p0, s1, p1);
        }
    }
};

// dQ's side of the walk: own Q and dO, streamed K and V
template <int D, int kBk>
struct DqOp {
    using Plan = BwdPlan<D, kBk, false>;
    static constexpr int kD = D, kBt = kBk, kSub = Plan::kSub, kRegs = kSub / 2;
    float ml[2], dl[2];        // LSE log2 e and delta of rows 16 warp + g, + 8
    float acc[D / 2];          // dQ of those rows
    uint32_t da[kSub / 16][4];  // dS of a sub-tile, as A fragments
    int tk, t;

    __device__ __forceinline__ explicit DqOp(int tk_) : tk(tk_), t(threadIdx.x % 4) {}
    // an item's start: its rows' LSE log2 e and delta from own_cols (0 past
    // tq), dQ zeroed
    __device__ __forceinline__ void begin(const float* own_cols) {
        const int row = 16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            ml[h] = own_cols[row + 8 * h];
            dl[h] = own_cols[kOwnRows + row + 8 * h];
        }
#pragma unroll
        for (int r = 0; r < D / 2; ++r) acc[r] = 0.0f;
        sm90::fence_regs(acc);  // the zeros are written here, not sunk between wgmmas
    }
    // dS = P (dP - delta) in fp32, P = exp(S - LSE) = 2^(S log2 e - LSE log2
    // e), 0 for keys past tk; register r holds key i N + 8 (r / 4) + 2t + r %
    // 2 of row (r % 4) / 2. Then dQ += dS K, dS rounded to bf16: k16 step kk
    // takes the stage's rows row + 16kk ..
    template <bool kEdge>
    __device__ __forceinline__ void products(int i, float (&s)[kRegs], float (&p)[kRegs],
                                             const uint8_t* stage, int row, const float*) {
        const int keys = tk - i * kSub - 2 * t;  // real keys from this thread's first
#pragma unroll
        for (int r = 0; r < kRegs; ++r) {
            const int h = (r % 4) / 2;
            float pr = exp2_ftz(fmaf(s[r], kLog2e, -ml[h]));
            if (kEdge && 8 * (r / 4) + (r & 1) >= keys) pr = 0.0f;
            p[r] = pr * (p[r] - dl[h]);
        }
        acc_as_a(p, da);
        sm90::fence_regs(da);
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk)
            rs_product<D>(acc, da[kk], stage, kBk, row + 16 * kk);
        sm90::wgmma_commit();
    }
    __device__ __forceinline__ void retired() {
        sm90::fence_regs(da);
        sm90::fence_regs(acc);
    }
};

// dK/dV's side: own K and V, streamed Q and dO, and each sub-tile's
// columns' LSE and delta from the stage
template <int D, int kBq>
struct DkvOp {
    using Plan = BwdPlan<D, kBq, true>;
    static constexpr int kD = D, kBt = kBq, kSub = Plan::kSub, kRegs = kSub / 2;
    float dka[D / 2], dva[D / 2];                 // dK, dV of keys 16 warp + g, + 8
    uint32_t pa[kSub / 16][4], sa[kSub / 16][4];  // P^T, dS^T of a sub-tile, A fragments
    int tq, t;

    __device__ __forceinline__ explicit DkvOp(int tq_) : tq(tq_), t(threadIdx.x % 4) {}
    // an item's start: dK, dV zeroed
    __device__ __forceinline__ void begin(const float*) {
#pragma unroll
        for (int r = 0; r < D / 2; ++r) dka[r] = dva[r] = 0.0f;
        sm90::fence_regs(dka);  // the zeros are written here, not sunk between wgmmas
        sm90::fence_regs(dva);
    }
    // P^T = exp(S^T - LSE) with each column's query's LSE, exactly 0 for
    // queries past tq; dS^T = P^T (dP^T - delta), both fp32; register r holds
    // query i N + 8 (r / 4) + 2t + r % 2, whose LSE log2 e and delta are
    // cols[8 (r / 4) + 2t + r % 2] and cols[kBq + ...]. Then dV += P^T dO and
    // dK += dS^T Q, P^T and dS^T rounded to bf16: k16 step kk takes the
    // stage's rows row + 16kk ..
    template <bool kEdge>
    __device__ __forceinline__ void products(int i, float (&s)[kRegs], float (&p)[kRegs],
                                             const uint8_t* stage, int row, const float* cols) {
        const int queries = tq - i * kSub - 2 * t;  // real queries from this thread's first
#pragma unroll
        for (int j = 0; j < kSub / 8; ++j) {
            const float2 ml = *reinterpret_cast<const float2*>(cols + 8 * j + 2 * t);
            const float2 dl = *reinterpret_cast<const float2*>(cols + kBq + 8 * j + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = 4 * j + e;
                float pr = exp2_ftz(fmaf(s[r], kLog2e, -(e & 1 ? ml.y : ml.x)));
                if (kEdge && 8 * j + (e & 1) >= queries) pr = 0.0f;
                s[r] = pr;
                p[r] = pr * (p[r] - (e & 1 ? dl.y : dl.x));
            }
        }
        acc_as_a(s, pa);
        acc_as_a(p, sa);
        sm90::fence_regs(pa);
        sm90::fence_regs(sa);
        sm90::fence_regs(dka);
        sm90::fence_regs(dva);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk) {
            rs_product<D>(dva, pa[kk], stage + Plan::kTile, kBq, row + 16 * kk);
            rs_product<D>(dka, sa[kk], stage, kBq, row + 16 * kk);
        }
        sm90::wgmma_commit();
    }
    __device__ __forceinline__ void retired() {
        sm90::fence_regs(pa);
        sm90::fence_regs(sa);
        sm90::fence_regs(dka);
        sm90::fence_regs(dva);
    }
};

// A consumer warpgroup's items: wait for the item's own tiles, take its A
// fragments (and dQ's LSE and delta) and, where they are registers, free
// the own tiles for the next item at once; walk the item's sub-tiles; store
// its rows of the outputs (store(item, op))
template <typename Op, typename Store>
__device__ __forceinline__ void consume(const BwdSmem& m, Work w, int streamed, Store store) {
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int lane = threadIdx.x % 32;
    Op op(streamed);
    Consumer<Op> c{op, m, lane, 64 * static_cast<int>(threadIdx.x / 128), 0};
    const int n = (streamed + Op::kBt - 1) / Op::kBt, nsub = (streamed + Op::kSub - 1) / Op::kSub;
    int k = 0;
    for (int item = blockIdx.x; item < w.items; item += gridDim.x, ++k, c.it0 += n) {
        sm90::mbar_wait(m.own_full, k & 1);
        c.load_own();
        op.begin(m.own_cols);
        if (Consumer<Op>::kOwnRegs && lane == 0) sm90::mbar_arrive(m.own_empty);
        c.run(nsub);
        if (!Consumer<Op>::kOwnRegs && lane == 0) sm90::mbar_arrive(m.own_empty);
        store(item, op);
    }
}

template <int D, int kBk>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap q_map,   // (BH, tq, D) pre-scaled
                         const __grid_constant__ CUtensorMap k_map,   // (BH, tk, D)
                         const __grid_constant__ CUtensorMap v_map,   // (BH, tk, D)
                         const __grid_constant__ CUtensorMap do_map,  // (BH, tq, D)
                         const float* __restrict__ lse,               // (BH, tq)
                         const float* __restrict__ delta,             // (BH, tq)
                         bf16* __restrict__ dq,                       // (BH, tq, D)
                         int bh, int tq, int tk) {  // q, dO in own boxes; k, v in kBk rows
    using Op = DqOp<D, kBk>;
    extern __shared__ uint8_t dq_bf16_smem[];
    const BwdSmem m = carve<typename Op::Plan>(dq_bf16_smem);
    const int blocks = (tq + kOwnRows - 1) / kOwnRows;
    const Work w{bh * blocks, blocks};
    if (threadIdx.x >= 128 * kConsumers) {
        produce<typename Op::Plan, D>(m, &q_map, &do_map, &k_map, &v_map, w,
                                      (tk + kBk - 1) / kBk, lse, delta, tq);
        return;
    }
    consume<Op>(m, w, tk, [&](int item, const Op& op) {
        store_rows<D>(dq + static_cast<size_t>(w.head(item)) * tq * D, op.acc, tq, w.row0(item));
    });
}

template <int D, int kBq>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap q_map,   // (BH, tq, D) pre-scaled
                          const __grid_constant__ CUtensorMap k_map,   // (BH, tk, D)
                          const __grid_constant__ CUtensorMap v_map,   // (BH, tk, D)
                          const __grid_constant__ CUtensorMap do_map,  // (BH, tq, D)
                          const float* __restrict__ lse,               // (BH, tq)
                          const float* __restrict__ delta,             // (BH, tq)
                          bf16* __restrict__ dk,                       // (BH, tk, D)
                          bf16* __restrict__ dv,                       // (BH, tk, D)
                          int bh, int tq, int tk) {  // q, dO in kBq rows; k, v in own boxes
    using Op = DkvOp<D, kBq>;
    extern __shared__ uint8_t dkv_bf16_smem[];
    const BwdSmem m = carve<typename Op::Plan>(dkv_bf16_smem);
    const int blocks = (tk + kOwnRows - 1) / kOwnRows;
    const Work w{bh * blocks, blocks};
    if (threadIdx.x >= 128 * kConsumers) {
        produce<typename Op::Plan, D>(m, &k_map, &v_map, &q_map, &do_map, w,
                                      (tq + kBq - 1) / kBq, lse, delta, tq);
        return;
    }
    consume<Op>(m, w, tq, [&](int item, const Op& op) {
        const size_t khead = static_cast<size_t>(w.head(item)) * tk;
        store_rows<D>(dk + khead * D, op.dka, tk, w.row0(item));
        store_rows<D>(dv + khead * D, op.dva, tk, w.row0(item));
    });
}

// The wrapper's block for the own side: 32, 64 or 128 rows (the kernels tile
// it by kOwnRows); smem_planned, its count of the shared memory
// (kernels/attention.py::dq_smem, dkv_smem at bf16), must equal the plan's
inline bool bad_plan(int rows, size_t smem, int smem_planned) {
    return (rows != 32 && rows != 64 && rows != 128) || smem != static_cast<size_t>(smem_planned);
}

template <int D, int kBk>
cudaError_t launch_dq_tile(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                           const float* lse, const float* delta, bf16* dq, int bh, int tq,
                           int tk, int bq, int smem_planned, cudaStream_t s) {
    constexpr size_t smem = BwdPlan<D, kBk, false>::kSmem;
    if (bad_plan(bq, smem, smem_planned)) return cudaErrorInvalidValue;
    CUtensorMap qm, km, vm, dom;
    cudaError_t err;
    if ((err = rows_map(&qm, q, D, tq, bh, kOwnRows)) != cudaSuccess ||
        (err = rows_map(&dom, dout, D, tq, bh, kOwnRows)) != cudaSuccess ||
        (err = rows_map(&km, k, D, tk, bh, kBk)) != cudaSuccess ||
        (err = rows_map(&vm, v, D, tk, bh, kBk)) != cudaSuccess ||
        (err = allow_dynamic_smem_once(flash_bwd_dq_bf16_kernel<D, kBk>, smem)) != cudaSuccess)
        return err;
    unsigned grid;
    err = persistent_grid(static_cast<long long>(bh) * ((tq + kOwnRows - 1) / kOwnRows), grid);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_bf16_kernel<D, kBk><<<grid, kThreads, smem, s>>>(qm, km, vm, dom, lse, delta,
                                                                  dq, bh, tq, tk);
    return cudaGetLastError();
}

template <int D, int kBq>
cudaError_t launch_dkv_tile(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                            const float* lse, const float* delta, bf16* dk, bf16* dv, int bh,
                            int tq, int tk, int bk, int smem_planned, cudaStream_t s) {
    constexpr size_t smem = BwdPlan<D, kBq, true>::kSmem;
    if (bad_plan(bk, smem, smem_planned)) return cudaErrorInvalidValue;
    CUtensorMap qm, km, vm, dom;
    cudaError_t err;
    if ((err = rows_map(&qm, q, D, tq, bh, kBq)) != cudaSuccess ||
        (err = rows_map(&dom, dout, D, tq, bh, kBq)) != cudaSuccess ||
        (err = rows_map(&km, k, D, tk, bh, kOwnRows)) != cudaSuccess ||
        (err = rows_map(&vm, v, D, tk, bh, kOwnRows)) != cudaSuccess ||
        (err = allow_dynamic_smem_once(flash_bwd_dkv_bf16_kernel<D, kBq>, smem)) != cudaSuccess)
        return err;
    unsigned grid;
    err = persistent_grid(static_cast<long long>(bh) * ((tk + kOwnRows - 1) / kOwnRows), grid);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_bf16_kernel<D, kBq><<<grid, kThreads, smem, s>>>(qm, km, vm, dom, lse, delta,
                                                                   dk, dv, bh, tq, tk);
    return cudaGetLastError();
}

}  // namespace

// D must be 16, 32, 64 or 128 (the wrapper zero-pads a head dim of 8 to 16).
// dQ streams block_k keys a tile, dK/dV block_q queries; the other block
// (32, 64 or 128) is checked and the own side tiled by 64 rows. smem_planned
// is the wrapper's count of the kernel's shared memory. q, k, v, dO and the
// outputs dQ, dK, dV are bf16, each on a 16-byte boundary; LSE and delta
// fp32.
extern "C" int msa_flash_bwd_dq_bf16(const bf16* q, const bf16* k, const bf16* v,
                                     const bf16* dout, const float* lse, const float* delta,
                                     bf16* dq, int BH, int tq, int tk, int D, int block_q,
                                     int block_k, int smem_planned, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return by_dim(D, [&](auto d) {
        return by_tile(block_k, [&](auto bk) {
            return launch_dq_tile<decltype(d)::value, decltype(bk)::value>(
                q, k, v, dout, lse, delta, dq, BH, tq, tk, block_q, smem_planned, s);
        });
    });
}

extern "C" int msa_flash_bwd_dkv_bf16(const bf16* q, const bf16* k, const bf16* v,
                                      const bf16* dout, const float* lse, const float* delta,
                                      bf16* dk, bf16* dv, int BH, int tq, int tk, int D,
                                      int block_q, int block_k, int smem_planned, int device,
                                      void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return by_dim(D, [&](auto d) {
        return by_tile(block_q, [&](auto bq) {
            return launch_dkv_tile<decltype(d)::value, decltype(bq)::value>(
                q, k, v, dout, lse, delta, dk, dv, BH, tq, tk, block_k, smem_planned, s);
        });
    });
}
