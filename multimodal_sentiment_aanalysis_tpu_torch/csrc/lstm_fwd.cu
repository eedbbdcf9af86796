// Bidirectional LSTM layer forward: the serial recurrence kernels.
//
// msa_bilstm_rec (fp32) and msa_bilstm_rec_bf16, the recurrence half of row 1,
// replace multimodal_sentiment_aanalysis_tpu/kernels/lstm.py::_fwd_xproj_kernel
// together with the input projection of lstm_gemm.cu (mode kProj), which the
// wrapper (kernels/lstm.py::bilstm_fwd) launches first: xp = x . W_ih^T + b,
// packed (S, B, T, 8H) [fwd | bwd] in actual time, fp32. Per step this kernel
// computes only gates = xp_t + h_{t-1} . W_hh^T in torch (i, f, g, o) order,
// then the cell; the reverse direction walks time by index (no flipped copy);
// h and c stay fp32 on chip across the whole sweep, and only h_seq is written
// (in the storage type: the bf16 form reads bf16 W_hh and stores bf16 h_seq,
// all arithmetic and the h it exchanges fp32, as the JAX kernel accumulates
// with preferred_element_type=float32 and carries h/c in fp32 scratch).
//
// What bounds it on the H100, at the flagship layer (B=64, T=73, H=128): the
// T=73 dependent steps. Each is a (B x H) . (H x 4H) product, 2.1 MFMA a
// direction, too small to fill the card; the earlier design (one block per 8
// batch rows, 16 blocks at S=1) re-read W_ih (512 KiB) and W_hh (256 KiB)
// from L2 every step, each weight feeding only 8 rows, with the input product
// inside the serial loop.
//
// Design: the input product is a tensor-core GEMM ahead of the loop, so the
// loop holds only h . W_hh^T. One thread-block cluster per (model, direction,
// batch tile of up to 64 rows) (lstm_cluster.cuh): CTA k keeps W_hh^T for its
// U = H / C units' four gate columns (H x 4U, 128 KiB in fp32 at C = 2)
// resident in shared memory for all T steps, computes those gates for every
// row of the tile on CUDA cores from h_{t-1} in shared memory (float4 reads
// along H, broadcast across the lanes of a row chunk), updates c in registers
// and all-gathers its h slice into every CTA's next-step h buffer through
// distributed shared memory; one cluster barrier per step, the h buffer
// double-buffered so that no CTA overwrites what another still reads. The
// next step's xp is loaded into registers while the current step's product
// runs. The wrapper picks the cluster size, batch tile and rows per thread
// from the shapes (kernels/lstm.py::cluster_plan) so that the grid fits one
// wave of the 132 SMs with the least serial work a step: C = 8 over tiles of
// 16 rows, 2 rows a thread, at S=1 (64 CTAs); C = 2 over all 64 rows, 8 a
// thread, at S=24 (96 CTAs).
//
// msa_bilstm_rec_cseq (fp32) and msa_bilstm_rec_cseq_bf16, row 4, replace
// ::_fwd_kernel (the v5 forward): the same recurrence over the same packed
// xp (which the v5 schedule makes by one matmul outside the kernel), with
// each thread also storing the fp32 c of its rows and unit at every step
// from registers into c_seq (S, 2, T, B, H), which the v5 backward
// (lstm_bwd.cu) reads. It needs no more shared memory than row 1; the plan
// is row 1's plan for the storage type. In the bf16 form xp is bf16 too, as
// the v5 schedule's bf16 matmul writes it and JAX's _fwd_kernel reads it
// (upcast in registers as it is loaded: no fp32 copy of xp is made, which
// at S=24 would add ~230 MB of writes and ~460 MB of reads to a kernel that
// moves ~400 MB); h_seq is stored bf16, c_seq fp32.

#include "lstm_cluster.cuh"

namespace {

// ---- row 1: the recurrence over xp on a cluster ----

// X: xp's storage type (float for row 1, whose GEMM writes fp32 xp; E for
// row 4). kStoreC: row 4's form, which also stores c into c_seq (unread
// otherwise); a template flag, so that row 1's forms compile as they did
// without it
template <typename E, typename X, int kRt, bool kStoreC>
__global__ void __launch_bounds__(kClusterMaxThreads)
bilstm_rec_kernel(const X* __restrict__ xp,      // (S, B, T, 8H)
                  const E* __restrict__ w_hh,    // (S, 2, 4H, H)
                  E* __restrict__ h_seq,         // (S, B, T, 2H)
                  float* __restrict__ c_seq,     // (S, 2, T, B, H)
                  int B, int T, int H, int bt, int ntiles) {
    cg::cluster_group cluster = cg::this_cluster();
    const ClusterPos pos = cluster_pos(ntiles);
    const int d = pos.d, C = pos.C;
    const int U = H / C, U4 = 4 * U, j0 = pos.rank * U;
    const int G = 4 * H;
    const int H4 = (H + 3) & ~3;  // h rows padded to whole float4s
    const int hs = H4 + 4;        // h buffer row stride
    const int groups = (bt + kRt - 1) / kRt;
    const int rows = groups * kRt;
    extern __shared__ float4 cluster_smem[];  // 16-byte aligned
    unsigned char* smem = reinterpret_cast<unsigned char*>(cluster_smem);
    E* wt = reinterpret_cast<E*>(smem);  // (H4, 4U): wt[k][q U + u] = W_hh[q H + j0 + u][k]
    float* hbuf = reinterpret_cast<float*>(smem + align16(sizeof(E) * H4 * U4));  // (2, rows, hs)

    const E* w = w_hh + (pos.model * 2 + d) * G * H;
    for (int idx = threadIdx.x; idx < H4 * U4; idx += blockDim.x) {
        const int c = idx / H4, k = idx % H4;  // k fastest: reads along a row of W_hh
        wt[k * U4 + c] = k < H ? w[static_cast<size_t>((c / U) * H + j0 + c % U) * H + k]
                               : from_float<E>(0.0f);
    }
    for (int idx = threadIdx.x; idx < 2 * rows * hs; idx += blockDim.x) hbuf[idx] = 0.0f;

    const bool active = threadIdx.x < groups * U;
    const int u = active ? threadIdx.x % U : 0;
    const int rc = active ? threadIdx.x / U : 0;
    const int j = j0 + u;
    const int b0 = pos.tile * bt;
    xp += pos.model * B * T * 2 * G + d * G + j;
    h_seq += pos.model * B * T * 2 * H + d * H + j;
    if constexpr (kStoreC) c_seq += (pos.model * 2 + d) * T * B * H + j;
    bool valid[kRt];
#pragma unroll
    for (int q = 0; q < kRt; ++q) {
        const int r = rc + groups * q;
        valid[q] = active && r < bt && b0 + r < B;
    }
    // gate pre-activations of step s from xp (zero on rows past the batch)
    auto load_xp = [&](int s, float (&v)[kRt][4]) {
        const int t = d == 0 ? s : T - 1 - s;
#pragma unroll
        for (int q = 0; q < kRt; ++q) {
            const size_t at = (static_cast<size_t>(b0 + rc + groups * q) * T + t) * 2 * G;
#pragma unroll
            for (int g = 0; g < 4; ++g) v[q][g] = valid[q] ? to_float(xp[at + g * H]) : 0.0f;
        }
    };
    float c[kRt] = {}, acc[kRt][4], nxt[kRt][4];
    load_xp(0, nxt);
    cluster.sync();  // every CTA's buffers are ready before any remote write

    for (int s = 0; s < T; ++s) {
        const int t = d == 0 ? s : T - 1 - s;
#pragma unroll
        for (int q = 0; q < kRt; ++q)
#pragma unroll
            for (int g = 0; g < 4; ++g) acc[q][g] = nxt[q][g];
        if (s + 1 < T) load_xp(s + 1, nxt);  // in flight during the product
        const float* hc = hbuf + (s & 1) * rows * hs;
        float* hn = hbuf + ((s + 1) & 1) * rows * hs;
        if (active) {
            for (int k = 0; k < H4; k += 4) {
                float wv[4][4];
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                    for (int g = 0; g < 4; ++g) wv[g][kk] = to_float(wt[(k + kk) * U4 + g * U + u]);
#pragma unroll
                for (int q = 0; q < kRt; ++q) {
                    const float4 hv = *reinterpret_cast<const float4*>(hc + (rc + groups * q) * hs + k);
#pragma unroll
                    for (int g = 0; g < 4; ++g)
                        acc[q][g] = fmaf(hv.w, wv[g][3], fmaf(hv.z, wv[g][2],
                                    fmaf(hv.y, wv[g][1], fmaf(hv.x, wv[g][0], acc[q][g]))));
                }
            }
#pragma unroll
            for (int q = 0; q < kRt; ++q) {
                if (!valid[q]) continue;  // its h stays zero
                const float ig = sigmoid_f(acc[q][0]);
                const float fg = sigmoid_f(acc[q][1]);
                const float gg = tanhf(acc[q][2]);
                const float og = sigmoid_f(acc[q][3]);
                c[q] = fg * c[q] + ig * gg;
                const float h = og * tanhf(c[q]);
                const int r = rc + groups * q;
                h_seq[(static_cast<size_t>(b0 + r) * T + t) * 2 * H] = from_float<E>(h);
                if constexpr (kStoreC) c_seq[(static_cast<size_t>(t) * B + b0 + r) * H] = c[q];
                for (int k = 0; k < C; ++k) cluster.map_shared_rank(hn, k)[r * hs + j] = h;
            }
        }
        cluster.sync();  // h_t is everywhere before step s + 1 reads it
    }
}

template <typename E, typename X, bool kStoreC>
int launch_rec(const X* xp, const E* w_hh, E* h_seq, float* c_seq, int S, int B, int T,
               int H, int C, int bt, int rows, int smem_planned, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (C < 1 || H % C != 0 || bt < 1 || rows < 1) return cudaErrorInvalidValue;
    const int groups = (bt + rows - 1) / rows;
    const int threads = (groups * (H / C) + 31) / 32 * 32;
    if (threads > kClusterMaxThreads) return cudaErrorInvalidConfiguration;
    const int H4 = (H + 3) & ~3;
    const size_t smem = ((sizeof(E) * H4 * 4 * (H / C) + 15) & ~size_t{15}) +
                        sizeof(float) * 2 * groups * rows * (H4 + 4);
    // the wrapper planned the cluster with its own count of these bytes
    // (kernels/lstm.py::_cluster_smem): a plan made on another layout is refused
    if (smem != static_cast<size_t>(smem_planned)) return cudaErrorInvalidValue;
    const int ntiles = (B + bt - 1) / bt;
    return by_rows(rows, [&](auto r) {
        return launch_cluster(bilstm_rec_kernel<E, X, decltype(r)::value, kStoreC>, C, ntiles * 2 * S,
                              threads, smem, stream, xp, w_hh, h_seq, c_seq, B, T, H, bt, ntiles);
    });
}

}  // namespace

// row 1's recurrence: xp (S, B, T, 8H) fp32, W_hh (S, 2, 4H, H) -> h_seq
// (S, B, T, 2H); clusters of C CTAs over batch tiles of bt rows, `rows`
// (2, 4 or 8) batch rows a thread, smem_planned bytes of shared memory a CTA
extern "C" int msa_bilstm_rec(const float* xp, const float* w_hh, float* h_seq, int S, int B,
                              int T, int H, int C, int bt, int rows, int smem_planned, int device,
                              void* stream) {
    return launch_rec<float, float, false>(xp, w_hh, h_seq, nullptr, S, B, T, H, C, bt, rows,
                                           smem_planned, device, stream);
}

extern "C" int msa_bilstm_rec_bf16(const float* xp, const __nv_bfloat16* w_hh,
                                   __nv_bfloat16* h_seq, int S, int B, int T, int H, int C,
                                   int bt, int rows, int smem_planned, int device, void* stream) {
    return launch_rec<__nv_bfloat16, float, false>(xp, w_hh, h_seq, nullptr, S, B, T, H, C, bt,
                                                   rows, smem_planned, device, stream);
}

// row 4, the v5 forward: row 1's recurrence, also storing c_seq
// (S, 2, T, B, H) in fp32; xp, W_hh and h_seq in the storage type
extern "C" int msa_bilstm_rec_cseq(const float* xp, const float* w_hh, float* h_seq,
                                   float* c_seq, int S, int B, int T, int H, int C, int bt,
                                   int rows, int smem_planned, int device, void* stream) {
    return launch_rec<float, float, true>(xp, w_hh, h_seq, c_seq, S, B, T, H, C, bt, rows,
                                          smem_planned, device, stream);
}

extern "C" int msa_bilstm_rec_cseq_bf16(const __nv_bfloat16* xp, const __nv_bfloat16* w_hh,
                                        __nv_bfloat16* h_seq, float* c_seq, int S, int B, int T,
                                        int H, int C, int bt, int rows, int smem_planned,
                                        int device, void* stream) {
    return launch_rec<__nv_bfloat16, __nv_bfloat16, true>(xp, w_hh, h_seq, c_seq, S, B, T, H, C,
                                                          bt, rows, smem_planned, device, stream);
}

