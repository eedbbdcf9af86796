// Bidirectional LSTM layer backward, both directions and all S models in each
// launch:
//
//   msa_bilstm_cscan  (a) the c checkpoints at segment boundaries, from the
//                     gate activations of lstm_gemm.cu (mode kGates); with
//                     that product it replaces
//                     multimodal_sentiment_aanalysis_tpu/kernels/lstm.py::_cbnd_kernel
//   msa_bilstm_sweep  (b) the serial half of the reverse sweep over K-step
//                     segments, which with three products of lstm_gemm.cu
//                     replaces ::_segbwd_kernel
//
// and the JAX package's other backward schedules (v5, v6, v8, v9.1), each
// built from these two kernels and lstm_gemm.cu, in the same two forms (the
// sweep's bf16 form, the scan's one form over fp32 activations):
//
//   msa_bilstm_cscan  at K = 1: the full fp32 c_seq (S, 2, T, B, H), (a)'s
//                     checkpoints at K = 1 (slot t is c at actual time t in
//                     both directions). With the kGates product before it
//                     (kernels/lstm.py::bilstm_cseq) it replaces
//                     ::_cseq_kernel (v8, v6); the v8 and v6 layer backwards
//                     (kernels/lstm.py::bilstm_v8_bwd, ::bilstm_v6_bwd)
//                     compute the activations once for it and (b)
//   msa_bilstm_sweep  at K = 1 over that full c_seq. With the gates GEMM
//                     before it and the dx and dW_cat GEMMs after it
//                     (kernels/lstm.py::bilstm_bwdc) it replaces
//                     ::_bwd_bwdc_kernel (v8); with the gates GEMM alone, its
//                     dgates the packed gate gradients dxp
//                     (kernels/lstm.py::bilstm_bwd_split), ::_bwd_xproj_kernel
//                     (v6); over the v5 forward's c_seq, with the kGatesXp
//                     product before it (act(xp + h_prev . W_hh^T), the gates
//                     from the v5 projection xp), its dgates dxp
//                     (kernels/lstm.py::bilstm_bwd_xp), ::_bwd_kernel (v5)
//   msa_bilstm_cscan  with the kGates product before it
//                     (kernels/lstm.py::bilstm_cbndk) replaces ::_cbndk_kernel
//                     (v9.1), the checkpoints of (a) with the gate products
//                     of KC time rows batched a block: the GEMM batches them
//                     over all T rows; the v9.1 layer backward runs v9's
//                     (kernels/lstm.py::bilstm_v9_bwd)
//
// The forward (lstm_fwd.cu) stores only h_seq. The gates at actual time a
// depend only on x_a and the stored h_prev (h at the previous recurrence
// step), so they are parallel in time, and only c = f c + i g is a
// recurrence, elementwise. The checkpoint kernels walk each direction in
// recurrence order with c in registers and write c only where a segment of K
// actual time steps ends, in the JAX package's slot convention (direction 0
// stores c at a % K == K-1 into slot a / K, the entry of block a / K + 1;
// direction 1 stores c at a % K == 0, the entry of block a / K - 1). K need
// not divide T: the last segment is partial and only its real rows are
// visited.
//
// (a), row 9. The JAX kernel computes each step's gates on the matrix unit
// inside its serial grid over T. On the H100 that product, run inside the
// serial walk, is small per step and streams 768 KiB of W_ih and W_hh a
// direction from L2 at every step on CUDA cores; and (b) needs the same
// activations. Design: the wrapper (kernels/lstm.py::bilstm_cbnd) computes
// the activations of every (b, t) first, as one tensor-core GEMM, and the v9
// layer backward (kernels/lstm.py::bilstm_v9_bwd) computes them once for both
// (a) and (b). This kernel is then only the c recurrence: one thread per
// (model, direction, batch row, unit), threads along H, so each step's loads
// of i, f and g are coalesced rows; the loads do not depend on c, so the next
// kScanAhead steps' loads are issued before the current steps' c chain runs
// (two register buffers). What bounds it: the bytes (6H of act's 8H columns
// read, c_bnd written) at many models; at one model of the flagship layer
// (B=64, H=128: 16,384 threads), the T dependent steps' latency. Each step
// rounds f c and i g, then their sum, as the plain version does (no fused
// multiply-add), so c equals kernels/lstm.py::bilstm_cscan_plain's bit for
// bit. At K = 1 (row 6) every step writes a slot: c_seq is 4x row 9's
// stores at K = 4.
//
// Rows 10, 6 and 5 ran per-block walks on CUDA cores (one block per batch
// tile, the time loop inside it, a thread per gate column, the weights
// streaming from L2 at every step or block of steps; row 5 with a second
// product a step for the dh carry) until they were rebuilt from the pieces
// above: the gates of every (b, t) on the tensor cores first, then only the
// serial recurrence. No such walk is left.
//
// (b), row 11. What bounds it on the H100, at the flagship layer (B=64,
// T=73, I=256, H=128, fp32): T=73 dependent steps per direction, each carrying
// dh through a (B x 4H) . (4H x H) product; the rest of ::_segbwd_kernel's
// work is parallel in time: the gate recompute from x and the stored h_prev
// (8H (I + H) FLOP a row), dx = dgates . W_ih and dW_cat = [x | h_prev | 1]^T
// . dgates (2 x 4672 x 385 x 512 FMAs per layer). The earlier design ran all
// of it inside the serial sweep on CUDA cores, one block per 8 batch rows (16
// blocks at S=1), re-reading 1 MiB of weights per direction from L2 per step
// and read-modify-writing a per-tile dW_cat partial buffer (302 MB at S=24).
//
// Design: the wrapper (kernels/lstm.py::bilstm_segbwd) runs the time-parallel
// work as tensor-core GEMMs of lstm_gemm.cu around this kernel: the gate
// activations of every (b, t) first (mode kGates) into an (S, B, T, 8H) fp32
// buffer, then this sweep, which overwrites that buffer in place with dgates,
// then dx (kDx) and dW_cat (kDw) from dgates. The sweep runs one
// thread-block cluster per (model, direction, batch tile) (lstm_cluster.cuh),
// CTA k owning U = H / C units and holding their 4U rows of W_hh (128 KiB in
// fp32 at C = 2) in shared memory for the whole sweep. Per K-segment, in
// reverse recurrence order, and per row of it from the last: each thread
// rebuilds c of its cells from the segment's entry checkpoint and the stored
// activations (elementwise, rows 0..r again for row r: K(K+1)/2 steps a
// segment where K would do, their loads L1 hits of rows the thread has just
// read; keeping the segment's c instead takes kRt x K registers, which the
// kRt = 8 form, already spilling at 128, does not have; at K = 1, over the
// full c_seq of v8, v6 and v5, one step a segment), runs the cell
// backward with its dh and dc carries in registers, writes dgates over the
// activations and into shared memory; the CTA multiplies its 4U gate columns
// of dgates by its W_hh rows into a partial dh over all H units; the partials are
// reduce-scattered through distributed shared memory (CTA k sums the C
// partials of its units, rank 0 first: a fixed order); two cluster barriers
// a step, split into arrive and wait so the cell work overlaps them.
//
// Rows 8, 7 and 5 (v8's ::_bwd_bwdc_kernel, v6's ::_bwd_xproj_kernel, v5's
// ::_bwd_kernel) have the same serial step and the same time-parallel work,
// so they are this design at K = 1: the wrappers (kernels/lstm.py::
// bilstm_bwdc, ::bilstm_bwd_split, ::bilstm_bwd_xp) pass a full c_seq (row
// 6's, or the v5 forward's) as the checkpoints; row 5's gates come from xp
// (lstm_gemm.cu kGatesXp) instead of x. At K = 1 every slot holds its
// step's c, so each step reads c from its own slot instead of rebuilding it
// from the previous one, as ::_bwd_kernel, ::_bwd_xproj_kernel and
// ::_bwd_bwdc_kernel read c_cur. For row 5 the two differ in bf16: the v5
// forward carried h in fp32 and its c_seq is that recurrence's, while the
// backward's gates come from the stored h_seq, rounded to bf16.
//
// msa_bilstm_sweep has an fp32 and a bf16 form (suffix _bf16), one template
// over the element type of dh_seq and W_hh, as the JAX kernels are Mosaic
// instances at either dtype. The c checkpoints, the gate activations and
// dgates stay fp32 in both, and so does all arithmetic: the bf16 form only
// reads half the bytes. msa_bilstm_cscan has one form: its input, the gate
// activations, is fp32 in both. The wrapper rounds dx and the weight
// gradients to the inputs' dtype, as the JAX layer's VJP does.

#include "lstm_cluster.cuh"

namespace {

// (a), row 9's c recurrence over the gate activations
constexpr int kScanThreads = 128;
constexpr int kScanAhead = 8;  // steps whose loads are issued ahead of the c chain

__global__ void __launch_bounds__(kScanThreads)
bilstm_cscan_kernel(const float* __restrict__ act,  // (S, B, T, 8H): i, f, g, o per direction
                    float* __restrict__ c_bnd,      // (S, 2, NSEG, B, H)
                    int S, int B, int T, int H, int K, int nseg) {
    const size_t cell = static_cast<size_t>(blockIdx.x) * kScanThreads + threadIdx.x;
    const size_t units = static_cast<size_t>(B) * H;  // c_bnd's stride along the slots
    if (cell >= static_cast<size_t>(S) * 2 * units) return;
    const int j = static_cast<int>(cell % H);
    const size_t b = cell / H % B;
    const int d = static_cast<int>(cell / units % 2);
    const size_t model = cell / (2 * units);
    const size_t row = 8 * static_cast<size_t>(H);  // act's stride along T
    const float* a = act + (model * B + b) * T * row + d * 4 * H + j;
    float* out = c_bnd + (model * 2 + d) * nseg * units + b * H + j;
    // step s of the recurrence is at actual time s (d = 0) or T - 1 - s (d = 1)
    auto load = [&](float (&i)[kScanAhead], float (&f)[kScanAhead], float (&g)[kScanAhead],
                    int s0) {
#pragma unroll
        for (int u = 0; u < kScanAhead; ++u) {
            const int s = s0 + u;
            if (s < T) {
                const float* p = a + static_cast<size_t>(d == 0 ? s : T - 1 - s) * row;
                i[u] = __ldg(p);
                f[u] = __ldg(p + H);
                g[u] = __ldg(p + 2 * H);
            }
        }
    };
    float ni[kScanAhead] = {}, nf[kScanAhead] = {}, ng[kScanAhead] = {};  // in flight
    load(ni, nf, ng, 0);
    float c = 0.0f;
    for (int s0 = 0; s0 < T; s0 += kScanAhead) {
        float ci[kScanAhead], cf[kScanAhead], cg[kScanAhead];
#pragma unroll
        for (int u = 0; u < kScanAhead; ++u) {
            ci[u] = ni[u];
            cf[u] = nf[u];
            cg[u] = ng[u];
        }
        load(ni, nf, ng, s0 + kScanAhead);
#pragma unroll
        for (int u = 0; u < kScanAhead; ++u) {
            const int s = s0 + u;
            if (s < T) {
                c = __fadd_rn(__fmul_rn(cf[u], c), __fmul_rn(ci[u], cg[u]));
                const int t = d == 0 ? s : T - 1 - s;
                if (d == 0 ? t % K == K - 1 : t % K == 0) out[(t / K) * units] = c;
            }
        }
    }
    // the partial last segment of direction 0 ends at no boundary: its slot,
    // which no block reads, is written zero, so every slot is written
    if (d == 0 && T % K != 0) out[(nseg - 1) * units] = 0.0f;
}

// (b), row 11's serial half: the reverse sweep over the gate activations
template <typename E, int kRt>
__global__ void __launch_bounds__(kClusterMaxThreads)
bilstm_sweep_kernel(float* __restrict__ act,          // (S, B, T, 8H): i, f, g, o in; dgates out
                    const E* __restrict__ dh_seq,     // (S, B, T, 2H)
                    const float* __restrict__ c_bnd,  // (S, 2, NSEG, B, H)
                    const E* __restrict__ w_hh,       // (S, 2, 4H, H)
                    int B, int T, int H, int K, int bt, int ntiles) {
    const ClusterPos pos = cluster_pos(ntiles);
    const int d = pos.d, C = pos.C;
    const int U = H / C, U4 = 4 * U, j0 = pos.rank * U;
    const int G = 4 * H;
    const int nseg = (T + K - 1) / K;
    const int groups = (bt + kRt - 1) / kRt;
    const int rows = groups * kRt;
    const int ds = U4 + 4;  // dgates tile row stride (float4 reads along the gates)
    const int ps = H + 1;   // partial dh row stride
    extern __shared__ float4 cluster_smem[];  // 16-byte aligned
    unsigned char* smem = reinterpret_cast<unsigned char*>(cluster_smem);
    E* ws = reinterpret_cast<E*>(smem);  // (4U, H): ws[q U + u][k] = W_hh[q H + j0 + u][k]
    float* dgs = reinterpret_cast<float*>(smem + align16(sizeof(E) * U4 * H));  // (rows, ds)
    float* pbuf = dgs + rows * ds;  // (rows, ps): this CTA's partial dh, all H units

    const E* w = w_hh + (pos.model * 2 + d) * G * H;
    for (int idx = threadIdx.x; idx < U4 * H; idx += blockDim.x) {
        const int c = idx / H;
        ws[idx] = w[static_cast<size_t>((c / U) * H + j0 + c % U) * H + idx % H];
    }
    for (int idx = threadIdx.x; idx < rows * ds; idx += blockDim.x) dgs[idx] = 0.0f;
    __syncthreads();

    const bool active = threadIdx.x < groups * U;
    const int u = active ? threadIdx.x % U : 0;
    const int rc = active ? threadIdx.x / U : 0;
    const int j = j0 + u;
    const int b0 = pos.tile * bt;
    act += pos.model * B * T * 2 * G + d * G + j;
    dh_seq += pos.model * B * T * 2 * H + d * H + j;
    c_bnd += (pos.model * 2 + d) * nseg * B * H + j;
    bool valid[kRt];
#pragma unroll
    for (int q = 0; q < kRt; ++q) {
        const int r = rc + groups * q;
        valid[q] = active && r < bt && b0 + r < B;
    }
    float dhc[kRt] = {}, dcc[kRt] = {};  // dh and dc carried into the current row
    cluster_arrive();  // pairs with the first row's wait

    for (int gi = 0; gi < nseg; ++gi) {
        const int m = d == 0 ? nseg - 1 - gi : gi;
        const int a_lo = m * K;
        const int nr = min(K, T - a_lo);
        // recurrence-order row r of this segment -> actual time
        auto a_of = [&](int r) { return d == 0 ? a_lo + r : a_lo + nr - 1 - r; };
        const bool first_seg = gi == nseg - 1;  // where the recurrence starts
        const int slot = d == 0 ? m - 1 : m + 1;
        float ce[kRt];  // c entering the segment
#pragma unroll
        for (int q = 0; q < kRt; ++q) {
            const size_t b = b0 + rc + groups * q;
            ce[q] = (valid[q] && !first_seg) ? c_bnd[(static_cast<size_t>(slot) * B + b) * H] : 0.0f;
        }
        for (int r = nr - 1; r >= 0; --r) {
            const int a = a_of(r);
            // row r's o gate and output gradient, then c of rows r - 1 and r
            // rebuilt from the entry; each row's loads for all kRt batch rows
            // are issued together, so a row of the rebuild waits on memory once
            float og[kRt], dho[kRt], c[kRt], cp[kRt], ig[kRt], fg[kRt], gg[kRt];
#pragma unroll
            for (int q = 0; q < kRt; ++q) {
                const size_t at = (static_cast<size_t>(b0 + rc + groups * q) * T + a);
                og[q] = valid[q] ? act[at * 2 * G + 3 * H] : 0.0f;
                dho[q] = valid[q] ? to_float(dh_seq[at * 2 * H]) : 0.0f;
                c[q] = ce[q];
            }
            for (int rr = 0; rr <= r; ++rr) {
                const int ar = a_of(rr);
#pragma unroll
                for (int q = 0; q < kRt; ++q) {
                    const float* g = act + (static_cast<size_t>(b0 + rc + groups * q) * T + ar) * 2 * G;
                    ig[q] = valid[q] ? g[0] : 0.0f;
                    fg[q] = valid[q] ? g[H] : 0.0f;
                    gg[q] = valid[q] ? g[2 * H] : 0.0f;
                }
#pragma unroll
                for (int q = 0; q < kRt; ++q) {
                    cp[q] = c[q];
                    c[q] = fg[q] * c[q] + ig[q] * gg[q];
                }
            }
            if (K == 1) {  // the full c: the row's own slot holds its c
#pragma unroll
                for (int q = 0; q < kRt; ++q) {
                    const size_t b = b0 + rc + groups * q;
                    c[q] = valid[q] ? c_bnd[(static_cast<size_t>(m) * B + b) * H] : 0.0f;
                }
            }
#pragma unroll
            for (int q = 0; q < kRt; ++q) {
                if (!valid[q]) continue;
                const float dh = dhc[q] + dho[q];
                const float tc = tanhf(c[q]);
                const float dc = dcc[q] + dh * og[q] * (1.0f - tc * tc);
                const float di = dc * gg[q] * ig[q] * (1.0f - ig[q]);
                const float df = dc * cp[q] * fg[q] * (1.0f - fg[q]);
                const float dg = dc * ig[q] * (1.0f - gg[q] * gg[q]);
                const float d_o = dh * tc * og[q] * (1.0f - og[q]);
                dcc[q] = dc * fg[q];
                float* ar = act + (static_cast<size_t>(b0 + rc + groups * q) * T + a) * 2 * G;
                ar[0] = di;
                ar[H] = df;
                ar[2 * H] = dg;
                ar[3 * H] = d_o;
                float* dr = dgs + (rc + groups * q) * ds + u;
                dr[0] = di;
                dr[U] = df;
                dr[2 * U] = dg;
                dr[3 * U] = d_o;
            }
            __syncthreads();  // the dgates tile is complete
            cluster_wait();   // every CTA has read the partials of the last row
            // this CTA's partial dh: its 4U gate columns of dgates . W_hh, all H units
            for (int task = threadIdx.x; task < groups * H; task += blockDim.x) {
                const int k = task % H, rc2 = task / H;
                float part[kRt] = {};
                for (int gl = 0; gl < U4; gl += 4) {
                    const float w0 = to_float(ws[gl * H + k]), w1 = to_float(ws[(gl + 1) * H + k]);
                    const float w2 = to_float(ws[(gl + 2) * H + k]), w3 = to_float(ws[(gl + 3) * H + k]);
#pragma unroll
                    for (int q = 0; q < kRt; ++q) {
                        const float4 v = *reinterpret_cast<const float4*>(dgs + (rc2 + groups * q) * ds + gl);
                        part[q] = fmaf(v.w, w3, fmaf(v.z, w2, fmaf(v.y, w1, fmaf(v.x, w0, part[q]))));
                    }
                }
#pragma unroll
                for (int q = 0; q < kRt; ++q) pbuf[(rc2 + groups * q) * ps + k] = part[q];
            }
            cluster_arrive();
            cluster_wait();  // every CTA's partials are complete
            // reduce-scatter: dh of this CTA's units, the C partials in rank order
#pragma unroll
            for (int q = 0; q < kRt; ++q) dhc[q] = 0.0f;
            for (int k = 0; k < C; ++k) {
                const float* pk = cg::this_cluster().map_shared_rank(pbuf, k);
#pragma unroll
                for (int q = 0; q < kRt; ++q) dhc[q] += valid[q] ? pk[(rc + groups * q) * ps + j] : 0.0f;
            }
            cluster_arrive();  // done reading the partials
        }
    }
    cluster_wait();  // no CTA leaves while another reads its shared memory
}

template <typename E>
int launch_sweep(float* act, const E* dh_seq, const float* c_bnd, const E* w_hh, int S, int B,
                 int T, int H, int K, int C, int bt, int rows, int smem_planned, int device,
                 void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (C < 1 || H % C != 0 || bt < 1 || K < 1 || rows < 1) return cudaErrorInvalidValue;
    const int groups = (bt + rows - 1) / rows;
    const int U = H / C;
    const int threads = (groups * U + 31) / 32 * 32;
    if (threads > kClusterMaxThreads) return cudaErrorInvalidConfiguration;
    const size_t smem = ((sizeof(E) * 4 * U * H + 15) & ~size_t{15}) +
                        sizeof(float) * groups * rows * ((4 * U + 4) + (H + 1));
    // the wrapper planned the cluster with its own count of these bytes
    // (kernels/lstm.py::_cluster_smem): a plan made on another layout is refused
    if (smem != static_cast<size_t>(smem_planned)) return cudaErrorInvalidValue;
    const int ntiles = (B + bt - 1) / bt;
    return by_rows(rows, [&](auto r) {
        return launch_cluster(bilstm_sweep_kernel<E, decltype(r)::value>, C, ntiles * 2 * S,
                              threads, smem, stream, act, dh_seq, c_bnd, w_hh, B, T, H, K, bt,
                              ntiles);
    });
}

}  // namespace

using bf16 = __nv_bfloat16;

// row 9's c scan: act (S, B, T, 8H) fp32 gate activations (i, f, g, o of
// each direction, lstm_gemm.cu's kGates output), c_bnd (S, 2, NSEG, B, H)
// fp32, every slot written
extern "C" int msa_bilstm_cscan(const float* act, float* c_bnd, int S, int B, int T, int H, int K,
                                int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (S < 1 || B < 1 || T < 1 || H < 1 || K < 1) return cudaErrorInvalidValue;
    const size_t blocks = (static_cast<size_t>(S) * 2 * B * H + kScanThreads - 1) / kScanThreads;
    if (blocks > 0x7fffffffu) return cudaErrorInvalidConfiguration;
    bilstm_cscan_kernel<<<static_cast<unsigned>(blocks), kScanThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(act, c_bnd, S, B, T, H, K,
                                                               (T + K - 1) / K);
    return cudaGetLastError();
}

// row 11's serial sweep: act (S, B, T, 8H) fp32 gate activations, overwritten
// in place by dgates; dh_seq (S, B, T, 2H), c_bnd (S, 2, NSEG, B, H) fp32,
// W_hh (S, 2, 4H, H); clusters of C CTAs over batch tiles of bt rows, `rows`
// (2, 4 or 8) batch rows a thread, smem_planned bytes of shared memory a CTA
extern "C" int msa_bilstm_sweep(float* act, const float* dh_seq, const float* c_bnd,
                                const float* w_hh, int S, int B, int T, int H, int K, int C,
                                int bt, int rows, int smem_planned, int device, void* stream) {
    return launch_sweep(act, dh_seq, c_bnd, w_hh, S, B, T, H, K, C, bt, rows, smem_planned,
                        device, stream);
}

extern "C" int msa_bilstm_sweep_bf16(float* act, const bf16* dh_seq, const float* c_bnd,
                                     const bf16* w_hh, int S, int B, int T, int H, int K, int C,
                                     int bt, int rows, int smem_planned, int device,
                                     void* stream) {
    return launch_sweep(act, dh_seq, c_bnd, w_hh, S, B, T, H, K, C, bt, rows, smem_planned,
                        device, stream);
}
