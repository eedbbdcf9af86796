// Bidirectional LSTM layer forward, both directions and all S models in one
// launch.
//
// Replaces multimodal_sentiment_aanalysis_tpu/kernels/lstm.py::_fwd_xproj_kernel
// (the v6 in-kernel-projection forward): per step the gates are
// x_t . W_ih^T + h . W_hh^T + (b_ih + b_hh) in torch (i, f, g, o) order, the
// reverse direction walks time by index (no flipped copy), h and c stay fp32
// on chip across the whole sweep, and only h_seq is written.
//
// Two forms of one template: fp32 (msa_bilstm_fwd) and bf16
// (msa_bilstm_fwd_bf16), the JAX kernel's two Mosaic instances. The bf16
// form reads x, the weights and the bias as bf16 and stores h_seq as bf16;
// every product and sum, h and c, and the h_{t-1} it broadcasts in shared
// memory stay fp32, as the JAX kernel accumulates with
// preferred_element_type=float32 and carries h/c in fp32 scratch.
//
// What bounds it on the H100, at the flagship layer (B=64, T=73, I=256,
// H=128, fp32): 3.67 GFLOP per layer, but T=73 dependent steps, and the
// weights of one direction (W_ih 512 KiB + W_hh 256 KiB) do not fit the
// 227 KB of shared memory a block can hold. So each block re-reads them from
// L2 every step: the kernel is bound by the per-SM L2 read rate and the
// serial step chain, not by FLOPs.
//
// Design: one block per (batch tile of kBt rows, direction, model) with a
// loop over T inside the block; that loop takes the place of the TPU grid's
// sequential time axis. The model axis S (the LOSO trainer's 24 models under
// torch.func.vmap) is the grid's z axis: each block offsets every operand by
// its model, so shared memory per block does not grow with S. Thread g of the 4H threads owns gate column g: it
// streams column g of W_ih^T and W_hh^T (coalesced across the warp) and
// reuses each weight for the kBt batch rows held in registers, against x_t
// and h_{t-1} broadcast from shared memory. A cell phase then applies the
// gate nonlinearities, with each thread owning two (row, unit) cells whose
// c lives in registers. A cluster that splits the gate columns over SMs and
// exchanges h through DSMEM, or bf16 weights resident in shared memory, is
// later work.
//
// msa_bilstm_fwd_xp, the same body with the input product taken out (kXp),
// replaces ::_fwd_kernel (the v5 forward): the gate pre-activation of step t
// is xp[b, t, d*4H + g], a projection x . W_ih^T + b made by one matmul
// outside the kernel, packed [fwd | bwd] along the last axis with both
// halves in actual time; and c is stored in fp32 beside h, into
// c_seq (S, 2, T, B, H), for the v5 backward (lstm_bwd.cu). Only h . W_hh^T
// stays in the step: a quarter of the forward's gate products at I = 2H,
// but xp is 4x the bytes of x. fp32 only.

#include "common.cuh"

namespace {

constexpr int kBt = 8;  // batch rows per block; kBt * H == 2 * (4H threads)

// kXp: x is xp (S, B, T, 8H) and I is unused (w_ih_t and bias may be null);
// c is written to c_seq (S, 2, T, B, H). Otherwise c_seq is unused.
template <typename E, bool kXp>
__global__ void bilstm_fwd_kernel(const E* __restrict__ x,       // (S, B, T, I)
                                  const E* __restrict__ w_ih_t,  // (S, 2, I, 4H)
                                  const E* __restrict__ w_hh_t,  // (S, 2, H, 4H)
                                  const E* __restrict__ bias,    // (S, 2, 4H)
                                  E* __restrict__ h_seq,         // (S, B, T, 2H)
                                  float* __restrict__ c_seq,     // (S, 2, T, B, H)
                                  int B, int T, int I, int H) {
    extern __shared__ float smem[];
    const int G = 4 * H;
    const int xw = kXp ? 2 * G : I;  // row width of x
    const size_t model = blockIdx.z;
    x += model * B * T * xw;
    w_hh_t += model * 2 * H * G;
    h_seq += model * B * T * 2 * H;
    float* xs = smem;                     // (kBt, I): x_t of this tile (not kXp)
    float* hs = xs + (kXp ? 0 : kBt * I);  // (kBt, H): h_{t-1}
    float* gs = hs + kBt * H;             // (kBt, G): gate pre-activations

    const int d = blockIdx.y;
    const int b0 = blockIdx.x * kBt;
    const int g = threadIdx.x;
    const E* wh = w_hh_t + static_cast<size_t>(d) * H * G;
    const E* wi = nullptr;
    float bg = 0.0f;
    if constexpr (kXp) {
        c_seq += (model * 2 + d) * T * B * H;
    } else {
        w_ih_t += model * 2 * I * G;
        bias += model * 2 * G;
        wi = w_ih_t + static_cast<size_t>(d) * I * G;
        bg = to_float(bias[d * G + g]);
    }

    for (int idx = g; idx < kBt * H; idx += G) hs[idx] = 0.0f;
    if constexpr (kXp) __syncthreads();  // no x staging barrier ahead of the first step
    float c[2] = {0.0f, 0.0f};

    for (int s = 0; s < T; ++s) {
        const int t = d == 0 ? s : T - 1 - s;
        float acc[kBt];
        if constexpr (kXp) {
#pragma unroll
            for (int r = 0; r < kBt; ++r) {
                const int b = b0 + r;
                acc[r] = b < B ? to_float(x[(static_cast<size_t>(b) * T + t) * xw + d * G + g]) : 0.0f;
            }
        } else {
            for (int idx = g; idx < kBt * I; idx += G) {
                const int r = idx / I;
                const int b = b0 + r;
                xs[idx] = b < B ? to_float(x[(static_cast<size_t>(b) * T + t) * I + (idx - r * I)]) : 0.0f;
            }
            __syncthreads();

#pragma unroll
            for (int r = 0; r < kBt; ++r) acc[r] = bg;
            for (int k = 0; k < I; ++k) {
                const float w = to_float(wi[static_cast<size_t>(k) * G + g]);
#pragma unroll
                for (int r = 0; r < kBt; ++r) acc[r] = fmaf(xs[r * I + k], w, acc[r]);
            }
        }
        for (int k = 0; k < H; ++k) {
            const float w = to_float(wh[static_cast<size_t>(k) * G + g]);
#pragma unroll
            for (int r = 0; r < kBt; ++r) acc[r] = fmaf(hs[r * H + k], w, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < kBt; ++r) gs[r * G + g] = acc[r];
        __syncthreads();

#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int cell = g + q * G;
            const int r = cell / H;
            const int j = cell - r * H;
            const float* gr = gs + r * G;
            const float ig = sigmoid_f(gr[j]);
            const float fg = sigmoid_f(gr[H + j]);
            const float gg = tanhf(gr[2 * H + j]);
            const float og = sigmoid_f(gr[3 * H + j]);
            c[q] = fg * c[q] + ig * gg;
            const float h = og * tanhf(c[q]);
            hs[r * H + j] = h;
            const int b = b0 + r;
            if (b < B) {
                h_seq[(static_cast<size_t>(b) * T + t) * 2 * H + d * H + j] = from_float<E>(h);
                if constexpr (kXp) c_seq[(static_cast<size_t>(t) * B + b) * H + j] = c[q];
            }
        }
        __syncthreads();
    }
}

template <typename E, bool kXp>
int launch_fwd(const E* x, const E* w_ih_t, const E* w_hh_t, const E* bias, E* h_seq,
               float* c_seq, int S, int B, int T, int I, int H, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const size_t smem = sizeof(float) * kBt * ((kXp ? 0 : I) + H + 4 * H);
    err = allow_dynamic_smem(bilstm_fwd_kernel<E, kXp>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((B + kBt - 1) / kBt, 2, S);
    bilstm_fwd_kernel<E, kXp><<<grid, 4 * H, smem, static_cast<cudaStream_t>(stream)>>>(
        x, w_ih_t, w_hh_t, bias, h_seq, c_seq, B, T, I, H);
    return cudaGetLastError();
}

}  // namespace

extern "C" int msa_bilstm_fwd(const float* x, const float* w_ih_t, const float* w_hh_t,
                              const float* bias, float* h_seq, int S, int B, int T, int I,
                              int H, int device, void* stream) {
    return launch_fwd<float, false>(x, w_ih_t, w_hh_t, bias, h_seq, nullptr, S, B, T, I, H,
                                    device, stream);
}

extern "C" int msa_bilstm_fwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w_ih_t,
                                   const __nv_bfloat16* w_hh_t, const __nv_bfloat16* bias,
                                   __nv_bfloat16* h_seq, int S, int B, int T, int I, int H,
                                   int device, void* stream) {
    return launch_fwd<__nv_bfloat16, false>(x, w_ih_t, w_hh_t, bias, h_seq, nullptr, S, B, T, I,
                                            H, device, stream);
}

// v5 forward: xp (S, B, T, 8H) packed [fwd | bwd] in actual time, W_hh^T
// (S, 2, H, 4H) -> h_seq (S, B, T, 2H), c_seq (S, 2, T, B, H), fp32
extern "C" int msa_bilstm_fwd_xp(const float* xp, const float* w_hh_t, float* h_seq,
                                 float* c_seq, int S, int B, int T, int H, int device,
                                 void* stream) {
    return launch_fwd<float, true>(xp, nullptr, w_hh_t, nullptr, h_seq, c_seq, S, B, T, 0, H,
                                   device, stream);
}
