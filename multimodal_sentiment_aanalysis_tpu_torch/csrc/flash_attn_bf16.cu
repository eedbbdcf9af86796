// Flash attention over (BH, T, D) in bf16: the forward with its per-row
// log-sum-exp. The bf16 form of flash_attn.cu's forward; the bf16 backward
// is flash_bwd_bf16.cu.
//
// Replaces multimodal_sentiment_aanalysis_tpu/kernels/attention.py, as the
// TPU kernel runs on bf16 q, k and v (Precision.DEFAULT: one bf16 pass a
// product, fp32 accumulation, bf16 output):
// - msa_flash_fwd_bf16 -> _fwd_kernel: O = softmax(Q K^T) V by online
//                         softmax over key tiles, LSE = m + log(l).
// Q is pre-scaled by 1/sqrt(D) in bf16 by the wrapper, as the JAX entry
// scales it. The masking is flash_attn.cu's: zero-filled rows past the end,
// keys past tk at -inf, no row past the end stored.
//
// Arithmetic, the TPU's under DEFAULT precision: every product is one
// mma.sync.m16n8k16 bf16 pass with fp32 accumulation. The forward keeps the
// online-softmax state (m, l, the O accumulator) in fp32, sums l over the
// fp32 P, and rounds P to bf16 only as the A operand of P V (the TPU's
// DEFAULT dot of an fp32 p with a bf16 v rounds p so); O = acc / l in fp32,
// stored as bf16, LSE fp32.
//
// What bounds it on the H100: at the attention phase's (BH = 512, T = 585,
// D = 32) its two products are 22.4 GFLOP, 0.023 ms at 989 TFLOP/s, plus ~4
// fp32 operations a score for the softmax, 0.010 ms at 67 TFLOP/s; its bf16
// operands and output 77 MB, 0.023 ms at 3.35 TB/s. So the products bound
// it, at a third of the fp32 form's three TF32 passes.
//
// Design: flash_attn.cu's, with one bf16 pass where that file takes three
// TF32 passes. A CTA owns block_q queries, one warp per 16 of them (the m16
// of m16n8k16), and streams key tiles through a 2-3 deep cp.async ring of
// bf16 rows padded to D + 8 elements: a row is then 16 bytes past a multiple
// of 128, so the 8 rows one ldmatrix matrix reads hit distinct bank groups.
// Q is held as A fragments (packed bf16 pairs) loaded once into registers.
// The B fragments come from ldmatrix: as K lies for S = Q K^T (a K row holds
// a B column's k pairs), transposed (.trans) for P V (a B column runs down
// the V rows). An m16n8k16 accumulator's two n8 tiles are exactly the A
// fragment of the next product's k16 step (a[0], a[1] of tile 2jj, a[2],
// a[3] of tile 2jj + 1), so P goes from the accumulator to the next mma.sync
// as packed bf16 pairs, with no shuffle and no trip through shared memory.
// The O accumulator is fp32 registers summed on the tensor cores over all of
// T (an fp32 sum of exact bf16 products). wgmma and TMA for it are later
// work (csrc/sm90.cuh has the pieces).
//
// Shared memory: bf16 tiles are half fp32's bytes, so every pair of head dim
// and tiles fits the 227 KB a block may use, the 128-key tile at D = 128
// included (two stages of 68 KB).

#include <math.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "tf32_mma.cuh"  // the commit / wait of the cp.async groups

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 256;  // own rows <= 128, 16 a warp
constexpr float kLog2e = 1.4426950408889634f;

// c += a b: one mma.sync.m16n8k16 bf16 pass, fp32 accumulation. Fragments
// (g = lane / 4, t = lane % 4): A (16 x 16, row) a[0] at (g, 2t..2t+1), a[1]
// (g + 8, 2t..2t+1), a[2] (g, 2t+8..2t+9), a[3] (g + 8, 2t+8..2t+9); B (16 x
// 8, col) b0 at (k = 2t..2t+1, n = g), b1 (k = 2t+8..2t+9, n = g); C (16 x
// 8) c[0], c[1] at (g, 2t), (g, 2t + 1), c[2], c[3] at row g + 8. A register
// holds its lower-indexed element in its low half.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to nearest even into a packed bf16 pair
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8 x 8 matrices of 16-bit elements from shared memory: lane l gives
// the address of row l % 8 of matrix l / 8 (16 bytes). Plain, lane (g, t)
// of register i gets row g, elements 2t and 2t + 1 of matrix i; .trans,
// elements (2t, g) and (2t + 1, g)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
}

// A lane's ldmatrix row in a tile of rows of ld elements, for a 16 x 16
// block whose four 8 x 8 matrices are taken
// - kRowPairs: rows 0-7, cols 0-7; rows 0-7, cols 8-15; rows 8-15, cols
//   0-7; rows 8-15, cols 8-15. Plain, the B fragments (b0, b1) of two n8
//   tiles whose n runs down the rows (K for S = Q K^T): registers 0, 1 of
//   rows 0-7 and 2, 3 of rows 8-15;
// - otherwise: rows 0-7, cols 0-7; rows 8-15, cols 0-7; rows 0-7, cols
//   8-15; rows 8-15, cols 8-15. Plain, an A fragment (a[0..3]) of a 16 x 16
//   block; .trans, the B fragments (b0, b1) of two n8 tiles whose k runs
//   down the rows (V for P V): registers 0, 1 of cols 0-7 and 2, 3 of cols
//   8-15
template <bool kRowPairs>
__device__ __forceinline__ int lane_row(int lane, int ld) {
    const int m = lane >> 3, r = lane & 7;
    return kRowPairs ? ((m >> 1) * 8 + r) * ld + (m & 1) * 8 : ((m & 1) * 8 + r) * ld + (m >> 1) * 8;
}

// Copies 16 bytes (or zeros, where !valid) into shared memory, asynchronously
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool valid) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
}

// The CTA's Q as A fragments of this warp's 16 rows at every 16-deep step
// of D, loaded once into registers
template <int D>
struct OwnFrags {
    static constexpr int kKSteps = D / 16;
    uint32_t a[kKSteps][4];

    // src: the operand's rows of this head, n of them; the CTA owns rows row0
    // on (this thread r0 and r0 + 8), rows past n are 0
    __device__ __forceinline__ void load(const bf16* src, int n, int row0, int r0, int t) {
        auto pair = [&](int r, int c) {
            return row0 + r < n
                       ? *reinterpret_cast<const uint32_t*>(src + static_cast<size_t>(row0 + r) * D + c)
                       : 0u;
        };
#pragma unroll
        for (int kd = 0; kd < kKSteps; ++kd) {
            const int c = kd * 16 + 2 * t;
            a[kd][0] = pair(r0, c);
            a[kd][1] = pair(r0 + 8, c);
            a[kd][2] = pair(r0, c + 8);
            a[kd][3] = pair(r0 + 8, c + 8);
        }
    }
};

// c[j] += a b over the n8 tiles j of kTiles: b's B fragments from the
// streamed tile at `p` (this lane's row, lane_row<true>), two n8 tiles (16
// rows) an ldmatrix
template <int kTiles, int kLd>
__device__ __forceinline__ void mma_rows(float (&c)[kTiles][4], const uint32_t (&a)[4],
                                         const bf16* p) {
#pragma unroll
    for (int j = 0; j < kTiles; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, p + j * 8 * kLd);
        mma_bf16(c[j], a, b[0], b[1]);
        mma_bf16(c[j + 1], a, b[2], b[3]);
    }
}

// acc[nd] += a b over D's n8 tiles: b's B fragments from the streamed tile
// at `p` (this lane's row, lane_row<false>, at the k16 step's first row),
// transposed, two n8 tiles (16 columns) an ldmatrix
template <int kDSteps>
__device__ __forceinline__ void mma_cols(float (&acc)[kDSteps][4], const uint32_t (&a)[4],
                                         const bf16* p) {
#pragma unroll
    for (int nd = 0; nd < kDSteps; nd += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, p + nd * 8);
        mma_bf16(acc[nd], a, b[0], b[1]);
        mma_bf16(acc[nd + 1], a, b[2], b[3]);
    }
}

// n8 accumulator tiles 2jj and 2jj + 1 (columns 16jj .. 16jj + 15) as the A
// fragment of the next product's k16 step, rounded to bf16
template <int kTiles>
__device__ __forceinline__ void acc_as_a(const float (&c)[kTiles][4], int jj, uint32_t (&a)[4]) {
    a[0] = pack_bf16(c[2 * jj][0], c[2 * jj][1]);
    a[1] = pack_bf16(c[2 * jj][2], c[2 * jj][3]);
    a[2] = pack_bf16(c[2 * jj + 1][0], c[2 * jj + 1][1]);
    a[3] = pack_bf16(c[2 * jj + 1][2], c[2 * jj + 1][3]);
}

// this thread's two rows of acc (times scale[h]) to rows row0 + r0 and row0
// + r0 + 8 of out (those below n), as bf16
template <int kDSteps>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[kDSteps][4], int n,
                                           int row0, int r0, int t, const float (&scale)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int i = row0 + r0 + 8 * h;
        if (i >= n) continue;
        bf16* oi = out + static_cast<size_t>(i) * (kDSteps * 8) + 2 * t;
#pragma unroll
        for (int nd = 0; nd < kDSteps; ++nd)
            *reinterpret_cast<__nv_bfloat162*>(oi + nd * 8) =
                __floats2bfloat162_rn(acc[nd][2 * h] * scale[h], acc[nd][2 * h + 1] * scale[h]);
    }
}

// the copies of `count` rows from row r0 on of two (rows, D) operands into a
// stage's two tiles of `tile` rows (rows past n zero-filled)
template <int D>
__device__ __forceinline__ void load_pair(bf16* stage, int tile, const bf16* a, const bf16* b,
                                          int r0, int n) {
    constexpr int kLd = D + 8, kVecs = D / 8;
    for (int e = threadIdx.x; e < tile * kVecs; e += blockDim.x) {
        const int r = e / kVecs, c = (e % kVecs) * 8;
        const bool real = r0 + r < n;
        const size_t at = static_cast<size_t>(real ? r0 + r : 0) * D + c;
        cp_async16(stage + r * kLd + c, a + at, real);
        cp_async16(stage + (tile + r) * kLd + c, b + at, real);
    }
}

// ---- forward ----

// A forward CTA's shared memory: a ring of kStages stages of kBk rows of K
// and of V, D + 8 bf16 each; 3 stages, 2 where 3 would pass 120 KiB
template <int D, int kBk>
struct FwdTile {
    static constexpr int kLd = D + 8;
    static constexpr int kStage = 2 * kBk * kLd;  // bf16 of one stage
    static constexpr int kStages = 3 * 2 * kStage <= 120 * 1024 ? 3 : 2;
    static constexpr size_t kSmem = sizeof(bf16) * kStages * kStage;
};

template <int D, int kBk>
__global__ void __launch_bounds__(kMaxThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q,  // (BH, tq, D), pre-scaled
                      const bf16* __restrict__ k,  // (BH, tk, D)
                      const bf16* __restrict__ v,  // (BH, tk, D)
                      bf16* __restrict__ o,        // (BH, tq, D)
                      float* __restrict__ lse,     // (BH, tq)
                      int tq, int tk) {
    using Tile = FwdTile<D, kBk>;
    constexpr int kLd = Tile::kLd, kStages = Tile::kStages;
    constexpr int kKeySteps = kBk / 8, kDSteps = D / 8, kKSteps = D / 16;
    extern __shared__ float4 fwd_bf16_smem[];  // 16-byte aligned
    bf16* ring = reinterpret_cast<bf16*>(fwd_bf16_smem);  // kStages x (K, V) tiles (kBk, kLd)
    const int rows = blockDim.x / 2;                      // 16 a warp of 32 threads
    const int bh = blockIdx.x;
    const int q0 = blockIdx.y * rows;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = (threadIdx.x / 32) * 16 + g;  // this thread's tile rows: r0, r0 + 8
    const bf16* kb = k + static_cast<size_t>(bh) * tk * D;
    const bf16* vb = v + static_cast<size_t>(bh) * tk * D;
    const int at_k = lane_row<true>(lane, kLd), at_v = lane_row<false>(lane, kLd);

    OwnFrags<D> qf;
    qf.load(q + static_cast<size_t>(bh) * tq * D, tq, q0, r0, t);

    float acc[kDSteps][4] = {};           // O of rows r0, r0 + 8, as C fragments
    float m[2] = {-INFINITY, -INFINITY};  // running max of the two rows
    float l[2] = {0.0f, 0.0f};            // this lane's share of the row sums
    const int nk = (tk + kBk - 1) / kBk;
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
        if (st < nk) load_pair<D>(ring + st * Tile::kStage, kBk, kb, vb, st * kBk, tk);
        cp_async_commit();  // an empty group past the end keeps the count
    }
    for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<kStages - 2>();  // key tile kt has landed (this thread's copies)
        __syncthreads();               // (everyone's), and tile kt - 1 is consumed
        const int next = kt + kStages - 1;
        if (next < nk)
            load_pair<D>(ring + (next % kStages) * Tile::kStage, kBk, kb, vb, next * kBk, tk);
        cp_async_commit();
        const bf16* ks = ring + (kt % kStages) * Tile::kStage;
        const bf16* vs = ks + kBk * kLd;

        // S = Q K^T: key tile j holds keys 8j + 2t, 8j + 2t + 1 in s[j][0..1]
        // (row r0) and s[j][2..3] (row r0 + 8)
        float s[kKeySteps][4] = {};
#pragma unroll
        for (int kd = 0; kd < kKSteps; ++kd)
            mma_rows<kKeySteps, kLd>(s, qf.a[kd], ks + at_k + kd * 16);
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
        // P = exp(S - m) = 2^(S log2 e - m log2 e) in fp32, summed into l
#pragma unroll
        for (int j = 0; j < kKeySteps; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s[j][e] = exp2f(fmaf(s[j][e], kLog2e, -ml[e >> 1]));
                l[e >> 1] += s[j][e];
            }
#pragma unroll
        for (int nd = 0; nd < kDSteps; ++nd)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e >> 1];

        // acc += P V, P rounded to bf16: k16 step jj takes keys 16jj .. 16jj + 15
#pragma unroll
        for (int jj = 0; jj < kBk / 16; ++jj) {
            uint32_t a[4];
            acc_as_a(s, jj, a);
            mma_cols<kDSteps>(acc, a, vs + at_v + jj * 16 * kLd);
        }
    }
    cp_async_wait<0>();  // no copy outlives the block

    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        inv[h] = 1.0f / l[h];
        const int i = q0 + r0 + 8 * h;
        if (i < tq && t == 0) lse[static_cast<size_t>(bh) * tq + i] = m[h] + logf(l[h]);
    }
    store_rows(o + static_cast<size_t>(bh) * tq * D, acc, tq, q0, r0, t, inv);
}

// The launcher takes `rows` own rows a CTA (a multiple of 16 up to 128, one
// warp per 16) and the wrapper's count of the shared memory
// (kernels/attention.py::fwd_smem at bf16), which must equal its own
inline bool bad_plan(int rows, size_t smem, int smem_planned) {
    return rows % 16 || rows < 16 || 2 * rows > kMaxThreads ||
           smem != static_cast<size_t>(smem_planned) || smem > 227 * 1024;
}

template <int D, int kBk>
cudaError_t launch_fwd_tile(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                            int bh, int tq, int tk, int bq, int smem_planned, cudaStream_t s) {
    const size_t smem = FwdTile<D, kBk>::kSmem;
    if (bad_plan(bq, smem, smem_planned)) return cudaErrorInvalidValue;
    cudaError_t err = allow_dynamic_smem(flash_fwd_bf16_kernel<D, kBk>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (tq + bq - 1) / bq);
    flash_fwd_bf16_kernel<D, kBk><<<grid, 2 * bq, smem, s>>>(q, k, v, o, lse, tq, tk);
    return cudaGetLastError();
}

// a streamed tile of 32, 64 or 128 rows: fn(std::integral_constant<int, tile>)
template <typename Fn>
cudaError_t by_tile(int tile, Fn fn) {
    switch (tile) {
        case 32: return fn(std::integral_constant<int, 32>());
        case 64: return fn(std::integral_constant<int, 64>());
        case 128: return fn(std::integral_constant<int, 128>());
        default: return cudaErrorInvalidValue;
    }
}

// a head dim of 16, 32, 64 or 128: fn(std::integral_constant<int, D>)
template <typename Fn>
cudaError_t by_dim(int d, Fn fn) {
    switch (d) {
        case 16: return fn(std::integral_constant<int, 16>());
        case 32: return fn(std::integral_constant<int, 32>());
        case 64: return fn(std::integral_constant<int, 64>());
        case 128: return fn(std::integral_constant<int, 128>());
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// D must be 16, 32, 64 or 128 (the wrapper zero-pads a head dim of 8 to 16).
// The kernel takes block_q query rows a CTA (a multiple of 16 up to 128: one
// warp per 16) and block_k keys a tile (32, 64 or 128), and smem_planned, the
// wrapper's count of its shared memory. q, k, v and O are bf16, LSE fp32.
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
