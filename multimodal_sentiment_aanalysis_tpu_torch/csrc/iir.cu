// Zero-phase IIR filtering of N independent series: a cascade of S
// second-order sections run forward and then backward over each series,
// scipy.signal.filtfilt's semantics, in fp32 and fp64.
//
// Replaces no Pallas kernel. The JAX package filters with a lax.scan over
// time, vmapped over every series (multimodal_sentiment_aanalysis_tpu/ops/
// dsp.py::_filtfilt_1d and ::_sosfilt_1d); PyTorch has no scan, and the
// recurrence written as tensor ops is ~9 launches a section a sample (some
// 46,000 launches for one order-4 band-pass over 585 samples).
//
// What one series needs, as _filtfilt_1d does it:
// 1. its odd extension by padlen samples at both ends, ext = [2 x[0] -
//    x[padlen..1], x, 2 x[T-1] - x[T-2..T-1-padlen]] of length L = T + 2
//    padlen, read here by index arithmetic rather than built;
// 2. a forward pass over ext through the S sections in cascade, each
//    section's transposed-direct-form-II state started at zi * ext[0];
// 3. a reverse pass over the forward pass's output, its state started at
//    zi * y_fwd[L-1];
// 4. the central T samples of the reverse pass.
// Each section does JAX's operations in JAX's order (ops/dsp.py:73-77):
// y = b0 x + z0; z0' = b1 x - a1 y + z1; z1' = b2 x - a2 y.
//
// What bounds it on the H100: at the port's largest stack (the synthetic
// MAHNOB-HCI raw EEG, 480 x 32 series of T = 585, an order-4 band-pass: S =
// 4, padlen 27) the bytes that must move are x read once and y written
// once, 72 MB in fp32 (~0.02 ms at 3.35 TB/s), and the arithmetic ~0.7
// GFLOP (~0.01 ms at 67 TFLOP/s). Neither is what holds a simple kernel
// back: each series is a serial chain of some 1,250 steps (L forward, L -
// padlen backward), each S dependent multiply-adds deep, and 15,360 series
// are one partial wave on 132 SMs. So the design is one thread per series,
// the sections' state in registers (S is a template parameter, 1 to 8),
// the coefficients and zi staged in shared memory (the coefficients then
// held in registers), and the forward pass's output in a time-major scratch
// buffer (L, N), so that the warp's stores and the reverse pass's loads of
// one time step are coalesced rows. x and y are
// series-major (N, T): each thread walks its own row, and the L1 cache keeps
// the lines it reads. The reverse pass stops at the first output sample:
// the padlen samples before it change no output. Later work (ROADMAP A12):
// a time-major x for coalesced loads, and a chunked parallel scan over time
// for long single recordings, where N is small.

#include "common.cuh"

namespace {

constexpr int kMaxSections = 8;  // an order-8 band-pass
constexpr int kThreads = 64;     // 240 blocks over the 132 SMs at N = 15,360

// One time step through the cascade, the coefficients c (S rows of b0 b1 b2
// 1 a1 a2) in registers: returns the last section's output.
template <typename T, int S>
__device__ __forceinline__ T cascade(T v, const T (&c)[S * 6], T (&z0)[S], T (&z1)[S]) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
        const T out = c[6 * k] * v + z0[k];
        z0[k] = c[6 * k + 1] * v - c[6 * k + 4] * out + z1[k];
        z1[k] = c[6 * k + 2] * v - c[6 * k + 5] * out;
        v = out;
    }
    return v;
}

template <typename T, int S>
__device__ __forceinline__ void start(const T* zi, T v, T (&z0)[S], T (&z1)[S]) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
        z0[k] = zi[2 * k] * v;
        z1[k] = zi[2 * k + 1] * v;
    }
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
sos_filtfilt_kernel(const T* __restrict__ x,    // (N, T)
                    T* __restrict__ y,          // (N, T)
                    T* __restrict__ fwd,        // (L, N) scratch
                    const T* __restrict__ sos_g,  // (S, 6)
                    const T* __restrict__ zi_g,   // (S, 2)
                    int n, int t, int padlen) {
    __shared__ T sos_s[S * 6];
    __shared__ T zi[S * 2];
    for (int i = threadIdx.x; i < S * 6; i += blockDim.x) sos_s[i] = sos_g[i];
    for (int i = threadIdx.x; i < S * 2; i += blockDim.x) zi[i] = zi_g[i];
    __syncthreads();
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= n) return;
    T sos[S * 6];
#pragma unroll
    for (int k = 0; k < S * 6; ++k) sos[k] = sos_s[k];
    const T* xs = x + static_cast<size_t>(s) * t;
    T* ys = y + static_cast<size_t>(s) * t;
    const int len = t + 2 * padlen;
    const T two_first = T(2) * xs[0];
    const T two_last = T(2) * xs[t - 1];
    T z0[S], z1[S];

    // forward pass: the left extension, the series, the right extension
    T v = padlen > 0 ? two_first - xs[padlen] : xs[0];
    start<T, S>(zi, v, z0, z1);
    int i = 0;
    for (int j = padlen; j > 0; --j, ++i) {
        v = cascade<T, S>(two_first - xs[j], sos, z0, z1);
        fwd[static_cast<size_t>(i) * n + s] = v;
    }
#pragma unroll 4
    for (int j = 0; j < t; ++j, ++i) {
        v = cascade<T, S>(xs[j], sos, z0, z1);
        fwd[static_cast<size_t>(i) * n + s] = v;
    }
    for (int j = t - 2; j >= t - 1 - padlen; --j, ++i) {
        v = cascade<T, S>(two_last - xs[j], sos, z0, z1);
        fwd[static_cast<size_t>(i) * n + s] = v;
    }

    // reverse pass from the last forward output; the central T samples out
    start<T, S>(zi, v, z0, z1);
    for (i = len - 1; i >= padlen + t; --i) {
        cascade<T, S>(fwd[static_cast<size_t>(i) * n + s], sos, z0, z1);
    }
#pragma unroll 4
    for (int j = t - 1; j >= 0; --j) {
        ys[j] = cascade<T, S>(fwd[static_cast<size_t>(j + padlen) * n + s], sos, z0, z1);
    }
}

template <typename T, int S>
cudaError_t launch_s(const T* x, T* y, T* fwd, const T* sos, const T* zi, int n, int t,
                     int padlen, cudaStream_t stream) {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    sos_filtfilt_kernel<T, S><<<blocks, kThreads, 0, stream>>>(x, y, fwd, sos, zi, n, t, padlen);
    return cudaGetLastError();
}

template <typename T>
int launch(const T* x, T* y, T* fwd, const T* sos, const T* zi, int n, int t, int padlen,
           int sections, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    // the wrapper checks these too (kernels/iir.py::_check): the odd
    // extension reads x[padlen] and x[T - 1 - padlen]
    if (n <= 0 || t <= padlen || padlen < 0 || sections < 1 || sections > kMaxSections)
        return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (sections) {
        case 1: return launch_s<T, 1>(x, y, fwd, sos, zi, n, t, padlen, s);
        case 2: return launch_s<T, 2>(x, y, fwd, sos, zi, n, t, padlen, s);
        case 3: return launch_s<T, 3>(x, y, fwd, sos, zi, n, t, padlen, s);
        case 4: return launch_s<T, 4>(x, y, fwd, sos, zi, n, t, padlen, s);
        case 5: return launch_s<T, 5>(x, y, fwd, sos, zi, n, t, padlen, s);
        case 6: return launch_s<T, 6>(x, y, fwd, sos, zi, n, t, padlen, s);
        case 7: return launch_s<T, 7>(x, y, fwd, sos, zi, n, t, padlen, s);
        default: return launch_s<T, 8>(x, y, fwd, sos, zi, n, t, padlen, s);
    }
}

}  // namespace

extern "C" int msa_sos_filtfilt(const float* x, float* y, float* fwd, const float* sos,
                                const float* zi, int n, int t, int padlen, int sections,
                                int device, void* stream) {
    return launch(x, y, fwd, sos, zi, n, t, padlen, sections, device, stream);
}

extern "C" int msa_sos_filtfilt_f64(const double* x, double* y, double* fwd, const double* sos,
                                    const double* zi, int n, int t, int padlen, int sections,
                                    int device, void* stream) {
    return launch(x, y, fwd, sos, zi, n, t, padlen, sections, device, stream);
}
