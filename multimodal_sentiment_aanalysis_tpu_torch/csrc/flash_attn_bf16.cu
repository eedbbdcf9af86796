// Flash attention over (BH, T, D) in bf16: the forward with its per-row
// log-sum-exp, for Hopper, on wgmma, TMA and mbarriers (sm90.cuh,
// flash_sm90.cuh). The bf16 form of flash_attn.cu's forward; the bf16
// backward is flash_bwd_bf16.cu, whose shape it shares.
//
// Replaces multimodal_sentiment_aanalysis_tpu/kernels/attention.py, as the
// TPU kernel runs on bf16 q, k and v (Precision.DEFAULT: one bf16 pass a
// product, fp32 accumulation, bf16 output):
// - msa_flash_fwd_bf16 -> _fwd_kernel: O = softmax(Q K^T) V by online
//                         softmax over key tiles, LSE = m + log(l).
// Q is pre-scaled by 1/sqrt(D) in bf16 by the wrapper, as the JAX entry
// scales it. Masking: rows past the end arrive as zeros (TMA's
// out-of-bounds fill), keys past tk are -inf in the last sub-tile, and no
// row past the end is stored.
//
// Arithmetic, the TPU's under DEFAULT precision: every product is one bf16
// pass with fp32 accumulation (wgmma). The online-softmax state (the row
// max m, the row sum l, the O accumulator) is fp32; l sums the fp32 P; P is
// rounded to bf16 only as the A operand of P V (the TPU's DEFAULT dot of an
// fp32 p with a bf16 v rounds p so); O = acc / l in fp32, stored as bf16;
// LSE = m + log(l), fp32.
//
// What bounds it on the H100: at the attention phase's (BH = 512, T = 585,
// D = 32) its two products are 22.4 GFLOP, 0.023 ms at 989 TFLOP/s, plus ~4
// fp32 operations a score for the softmax, 0.010 ms at 67 TFLOP/s; its bf16
// operands and output 77 MB, 0.023 ms at 3.35 TB/s. Its 175.2 M exps take
// ~0.042-0.047 ms at 16 a clock an SM (132 SMs), above both: the exp units
// set the floor, and the products must run beside them.
//
// Design: flash_bwd_bf16.cu's. One persistent CTA an SM walks work items of
// 128 query rows of one head, a head's items adjacent (its K and V come
// from memory once and from L2 for the rest), whatever the wrapper's
// block_q. Two consumer warpgroups hold 64 rows each, 16 a warp; a producer
// warpgroup feeds them (384 threads; setmaxnreg moves the producer's
// registers to the consumers). Each output row is independent and sums its
// keys in one order, with no atomics: two runs give the same bits.
// - TMA: one producer thread loads an item's Q tile (once the consumers
//   have taken the last item's), then streams the head's K and V tiles of
//   block_k rows through a ring of 2-4 stages that runs on from item to
//   item. Each stage is an mbarrier the loads complete (expect_tx) and
//   another the consumers' eight warps arrive on when its last product has
//   retired. Each operand is a 3-D map {D, T, BH}, so rows past T arrive
//   as zeros, not as the next head's.
// - wgmma: a consumer takes a stage in sub-tiles of kSub keys (64, or 32
//   for 32-key tiles): S = Q K^T (m64n{kSub}k16; Q as register A fragments
//   read once an item up to D = 64, through a descriptor of the Q tile at
//   D = 128; K read K-major), the online softmax on the accumulator, then
//   O += P V with P packed from the accumulator as the register A operand
//   (m64n{D}k16, two m64n64k16 at D = 128; V read MN-major through the
//   transpose bit).
// - Overlap: the next sub-tile's S is issued before this sub-tile's
//   softmax (two register sets, one commit group each), so the tensor cores
//   run it while the warps run the exps; P V follows in its own group, and
//   every group retires within the sub-tile (a wgmma in flight across a
//   branch or the loop's back edge makes ptxas serialise every wgmma).
// - Exps: one ex2.approx.ftz a score, the 1/ln 2 scale folded into one
//   FFMA with the row max (exp2f's subnormal handling costs three more
//   instructions); the mask of the last keys only in the last sub-tile.

#include <math.h>

#include <cstdint>

#include "flash_sm90.cuh"

namespace {

using namespace flash_sm90;

// A forward CTA's shared memory, from a 1024-byte boundary (the 128-byte
// swizzle's period): the Q tile (kOwnRows rows), a ring of kStages stages
// of a K tile and a V tile (kBk rows each), then the mbarriers (own_full,
// own_empty, full[], empty[]). A tile is one box of rows of span_of(D)
// bytes, two at D = 128. kStages: as many as fit 64 KiB of tiles, 2 to 4
template <int D, int kBk>
struct FwdPlan {
    static constexpr int kSub = kBk < 64 ? kBk : 64;  // keys of one S product
    static constexpr int kOwnTile = kOwnRows * 2 * D;
    static constexpr int kTile = kBk * 2 * D;
    static constexpr int kStage = 2 * kTile;
    static constexpr int kFit = 65536 / kStage;
    static constexpr int kStages = kFit < 2 ? 2 : kFit > 4 ? 4 : kFit;
    static constexpr size_t kSmem = 1024 + kOwnTile + kStages * kStage + 8 * (2 + 2 * kStages);
};

struct FwdSmem {
    uint8_t *own, *ring;
    uint64_t *own_full, *own_empty, *full, *empty;
};

template <typename Plan>
__device__ __forceinline__ FwdSmem carve(uint8_t* raw) {
    uint8_t* base = raw + ((1024 - (sm90::smem_addr(raw) & 1023)) & 1023);
    FwdSmem m;
    m.own = base;
    m.ring = base + Plan::kOwnTile;
    m.own_full = reinterpret_cast<uint64_t*>(m.ring + Plan::kStages * Plan::kStage);
    m.own_empty = m.own_full + 1;
    m.full = m.own_full + 2;
    m.empty = m.full + Plan::kStages;
    if (threadIdx.x == 0) {
        // arrivals: the TMA thread's expect_tx; one a consumer warp
        sm90::mbar_init(m.own_full, 1);
        sm90::mbar_init(m.own_empty, 4 * kConsumers);
        for (int st = 0; st < Plan::kStages; ++st) {
            sm90::mbar_init(m.full + st, 1);
            sm90::mbar_init(m.empty + st, 4 * kConsumers);
        }
        sm90::fence_barrier_init();
    }
    __syncthreads();
    return m;
}

// The producer warpgroup: gives up registers; its first thread loads each
// item's Q tile (once the consumers are done with the last item's) and then
// the head's n K and V tiles by TMA through the ring
template <typename Plan, int D, int kBk>
__device__ __forceinline__ void produce(const FwdSmem& m, const CUtensorMap* q_map,
                                        const CUtensorMap* k_map, const CUtensorMap* v_map,
                                        Work w, int n) {
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != 128 * kConsumers) return;
    sm90::prefetch_map(k_map);
    sm90::prefetch_map(v_map);
    int it = 0, k = 0;
    for (int item = blockIdx.x; item < w.items; item += gridDim.x, ++k) {
        const int bh = w.head(item);
        if (k > 0) sm90::mbar_wait(m.own_empty, (k - 1) & 1);
        sm90::mbar_expect_tx(m.own_full, Plan::kOwnTile);
        load_tile<D>(m.own, q_map, m.own_full, w.row0(item), bh, kOwnRows);
        for (int t = 0; t < n; ++t, ++it) {
            const int slot = it % Plan::kStages;
            // the stage's previous tile (it - kStages) has been released
            if (it >= Plan::kStages)
                sm90::mbar_wait(m.empty + slot, ((it / Plan::kStages) & 1) ^ 1);
            uint8_t* stage = m.ring + slot * Plan::kStage;
            sm90::mbar_expect_tx(m.full + slot, Plan::kStage);
            load_tile<D>(stage, k_map, m.full + slot, t * kBk, bh, kBk);
            load_tile<D>(stage + Plan::kTile, v_map, m.full + slot, t * kBk, bh, kBk);
        }
    }
}

// A consumer warpgroup's walk over one item's key sub-tiles (its 64 query
// rows from own_row; the item's first tile the ring's it0-th). Each
// body(i) starts with S of sub-tile i retired into s. With kNext it first
// issues S of i + 1 into sn (waiting for that stage), so that the tensor
// cores run it beside this sub-tile's exps; then the softmax and P V of i;
// then it waits for all of it, so that no wgmma is in flight across a
// branch or the loop's back edge, and releases the stage i finishes. The
// two register sets alternate, the loop unrolled by two, so that every
// register index is static
template <int D, int kBk>
struct FwdConsumer {
    using Plan = FwdPlan<D, kBk>;
    static constexpr int N = Plan::kSub, kRegs = N / 2, kSpt = kBk / N;
    static constexpr int kStages = Plan::kStages;
    // up to D = 64 Q waits in registers as A fragments (S then reads only K
    // from shared memory); at D = 128 A comes from the Q tile
    static constexpr bool kOwnRegs = D <= 64;
    const FwdSmem& m;
    int lane, own_row, it0, tk;
    uint32_t qa[kOwnRegs ? D / 16 : 1][4];  // Q of this warpgroup's rows, every k16 step
    uint32_t pa[N / 16][4];                 // P of a sub-tile, as A fragments
    float acc[D / 2];                       // O of rows 16 warp + g, + 8
    float mrow[2], lrow[2];                 // their running max, this thread's share of l

    __device__ __forceinline__ const uint8_t* stage(int i) const {
        return m.ring + ((it0 + i / kSpt) % kStages) * Plan::kStage;
    }
    // an item's start: Q's A fragments (up to D = 64), O, m and l reset
    __device__ __forceinline__ void begin() {
        if constexpr (kOwnRegs) own_fragments<D>(qa, m.own, 16 * (threadIdx.x / 32) + lane / 4);
#pragma unroll
        for (int r = 0; r < D / 2; ++r) acc[r] = 0.0f;
        sm90::fence_regs(acc);  // the zeros are written here, not sunk between wgmmas
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            mrow[h] = -INFINITY;
            lrow[h] = 0.0f;
        }
    }
    // S of sub-tile i into s, one commit group
    __device__ __forceinline__ void issue(int i, float (&s)[kRegs]) {
        sm90::fence_regs(s);
        sm90::fence_regs(qa);
        sm90::wgmma_fence();
        const int row = (i % kSpt) * N;
        if constexpr (kOwnRegs)
            rs_product_k<D>(s, qa, stage(i), kBk, row);
        else
            ss_product<D>(s, m.own, own_row, stage(i), kBk, row);
        sm90::wgmma_commit();
        sm90::fence_regs(s);
        sm90::fence_regs(qa);
    }
    // the online softmax of sub-tile i (register r holds key i N + 8 (r / 4)
    // + 2t + r % 2 of row (r % 4) / 2; keys past tk -inf where kEdge), then
    // O += P V, P rounded to bf16: k16 step kk takes the stage's V rows row +
    // 16kk ..
    template <bool kEdge>
    __device__ __forceinline__ void softmax_pv(int i, float (&s)[kRegs]) {
        const int t = lane % 4;
        if constexpr (kEdge) {
            const int keys = tk - i * N - 2 * t;  // real keys from this thread's first
#pragma unroll
            for (int r = 0; r < kRegs; ++r)
                if (8 * (r / 4) + (r & 1) >= keys) s[r] = -INFINITY;
        }
        float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
        for (int r = 0; r < kRegs; ++r) mx[(r % 4) / 2] = fmaxf(mx[(r % 4) / 2], s[r]);
        float alpha[2], ml[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            // every sub-tile has a real key, so the max is finite
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
            alpha[h] = exp2_ftz((mrow[h] - mx[h]) * kLog2e);  // 0 on the first (m = -inf)
            mrow[h] = mx[h];
            ml[h] = mx[h] * kLog2e;
            lrow[h] *= alpha[h];
        }
        // P = exp(S - m) = 2^(S log2 e - m log2 e) in fp32, summed into l
        // (skipping the exps of rows past tq or keys past tk measured slower:
        // the branches cost more issue than the exps they save)
#pragma unroll
        for (int r = 0; r < kRegs; ++r) {
            s[r] = exp2_ftz(fmaf(s[r], kLog2e, -ml[(r % 4) / 2]));
            lrow[(r % 4) / 2] += s[r];
        }
#pragma unroll
        for (int r = 0; r < D / 2; ++r) acc[r] *= alpha[(r % 4) / 2];
        acc_as_a(s, pa);
        sm90::fence_regs(pa);
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
        const uint8_t* v = stage(i) + Plan::kTile;
        const int row = (i % kSpt) * N;
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) rs_product<D>(acc, pa[kk], v, kBk, row + 16 * kk);
        sm90::wgmma_commit();
    }
    template <bool kNext>
    __device__ __forceinline__ void body(int i, float (&s)[kRegs], float (&sn)[kRegs]) {
        if constexpr (kNext) {
            const int tile = it0 + (i + 1) / kSpt;
            if ((i + 1) % kSpt == 0) sm90::mbar_wait(m.full + tile % kStages, (tile / kStages) & 1);
            issue(i + 1, sn);
        }
        // only the last sub-tile reaches past the last key
        softmax_pv<!kNext>(i, s);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(pa);
        sm90::fence_regs(acc);
        if constexpr (kNext) sm90::fence_regs(sn);
        // the item's last sub-tile finishes its (perhaps partial) last tile
        if ((!kNext || (i + 1) % kSpt == 0) && lane == 0)
            sm90::mbar_arrive(m.empty + (it0 + i / kSpt) % kStages);
    }
    __device__ __forceinline__ void run(int nsub) {
        float s0[kRegs], s1[kRegs];
        sm90::mbar_wait(m.full + it0 % kStages, (it0 / kStages) & 1);
        issue(0, s0);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s0);
        int i = 0;
        for (; i + 2 < nsub; i += 2) {
            body<true>(i, s0, s1);
            body<true>(i + 1, s1, s0);
        }
        if (i + 1 < nsub) {
            body<true>(i, s0, s1);
            body<false>(i + 1, s1, s0);
        } else {
            body<false>(i, s0, s1);
        }
    }
    // an item's end: l summed over the row's four threads, LSE = m + log(l)
    // of the rows below tq, O = acc / l stored as bf16
    __device__ __forceinline__ void finish(bf16* o, float* lse, int tq, int row0) {
        const int r0 = row0 + 16 * (threadIdx.x / 32) + lane / 4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 1);
            lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 2);
            if (r0 + 8 * h < tq && lane % 4 == 0) lse[r0 + 8 * h] = mrow[h] + logf(lrow[h]);
        }
#pragma unroll
        for (int r = 0; r < D / 2; ++r) acc[r] = acc[r] / lrow[(r % 4) / 2];
        store_rows<D>(o, acc, tq, row0);
    }
};

template <int D, int kBk>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,  // (BH, tq, D) pre-scaled
                      const __grid_constant__ CUtensorMap k_map,  // (BH, tk, D)
                      const __grid_constant__ CUtensorMap v_map,  // (BH, tk, D)
                      bf16* __restrict__ o,                       // (BH, tq, D)
                      float* __restrict__ lse,                    // (BH, tq)
                      int bh, int tq, int tk) {  // q in own boxes; k, v in kBk rows
    using Plan = FwdPlan<D, kBk>;
    extern __shared__ uint8_t fwd_bf16_smem[];
    const FwdSmem m = carve<Plan>(fwd_bf16_smem);
    const int blocks = (tq + kOwnRows - 1) / kOwnRows;
    const Work w{bh * blocks, blocks};
    const int n = (tk + kBk - 1) / kBk;
    if (threadIdx.x >= 128 * kConsumers) {
        produce<Plan, D, kBk>(m, &q_map, &k_map, &v_map, w, n);
        return;
    }
    sm90::setmaxnreg_inc<kConsumerRegs>();
    using Consumer = FwdConsumer<D, kBk>;
    Consumer c{m, static_cast<int>(threadIdx.x % 32), 64 * static_cast<int>(threadIdx.x / 128),
               0, tk};
    const int nsub = (tk + Plan::kSub - 1) / Plan::kSub;
    int k = 0;
    for (int item = blockIdx.x; item < w.items; item += gridDim.x, ++k, c.it0 += n) {
        sm90::mbar_wait(m.own_full, k & 1);
        c.begin();
        if (Consumer::kOwnRegs && c.lane == 0) sm90::mbar_arrive(m.own_empty);
        c.run(nsub);
        if (!Consumer::kOwnRegs && c.lane == 0) sm90::mbar_arrive(m.own_empty);
        const size_t head = static_cast<size_t>(w.head(item)) * tq;
        c.finish(o + head * D, lse + head, tq, w.row0(item));
    }
}

// The wrapper's block_q: 32, 64 or 128 rows (the kernel tiles the queries
// by kOwnRows); smem_planned, its count of the shared memory
// (kernels/attention.py::fwd_smem at bf16), must equal the plan's
inline bool bad_plan(int rows, size_t smem, int smem_planned) {
    return (rows != 32 && rows != 64 && rows != 128) || smem != static_cast<size_t>(smem_planned);
}

template <int D, int kBk>
cudaError_t launch_fwd_tile(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                            int bh, int tq, int tk, int bq, int smem_planned, cudaStream_t s) {
    constexpr size_t smem = FwdPlan<D, kBk>::kSmem;
    if (bad_plan(bq, smem, smem_planned)) return cudaErrorInvalidValue;
    CUtensorMap qm, km, vm;
    cudaError_t err;
    if ((err = rows_map(&qm, q, D, tq, bh, kOwnRows)) != cudaSuccess ||
        (err = rows_map(&km, k, D, tk, bh, kBk)) != cudaSuccess ||
        (err = rows_map(&vm, v, D, tk, bh, kBk)) != cudaSuccess ||
        (err = allow_dynamic_smem_once(flash_fwd_bf16_kernel<D, kBk>, smem)) != cudaSuccess)
        return err;
    unsigned grid;
    err = persistent_grid(static_cast<long long>(bh) * ((tq + kOwnRows - 1) / kOwnRows), grid);
    if (err != cudaSuccess) return err;
    flash_fwd_bf16_kernel<D, kBk><<<grid, kThreads, smem, s>>>(qm, km, vm, o, lse, bh, tq, tk);
    return cudaGetLastError();
}

}  // namespace

// D must be 16, 32, 64 or 128 (the wrapper zero-pads a head dim of 8 to 16).
// The kernel streams block_k keys a tile (32, 64 or 128); block_q (32, 64
// or 128) is checked and the queries tiled by 128 rows. smem_planned is the
// wrapper's count of its shared memory. q, k, v and O are bf16, each on a
// 16-byte boundary; LSE fp32.
extern "C" int msa_flash_fwd_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                                  float* lse, int BH, int tq, int tk, int D, int block_q,
                                  int block_k, int smem_planned, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return by_dim(D, [&](auto d) {
        return by_tile(block_k, [&](auto bk) {
            return launch_fwd_tile<decltype(d)::value, decltype(bk)::value>(
                q, k, v, o, lse, BH, tq, tk, block_q, smem_planned, s);
        });
    });
}
