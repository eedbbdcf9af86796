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
// GFLOP (~0.01 ms at 67 TFLOP/s). Each series is a serial chain of some
// 1,250 steps (L forward, L - padlen backward), each S dependent
// multiply-adds deep: ~25-30 issue cycles a step for a warp, so ~0.02 ms
// for the chain if no step waits on memory.
//
// Design: a thread per series, a warp of 32 series with its own ring, 4
// warps a block (one a scheduler), so that the stack's 15,360 series are 480
// warps in one wave. Memory stays off the chain: every global access is a
// whole coalesced row (128 bytes a warp in fp32), issued well before the
// step that needs it, through a ring of kSlots time steps in shared memory
// (slot i % kSlots, 32 + 1 elements each, the pad keeping the transposed
// accesses free of bank conflicts). Time runs in chunks of 32 steps, and a
// chunk's 32 inputs are read from the ring into registers before its steps,
// so that no step waits on shared memory.
// - Forward: chunk c + kAhead of ext is copied into the ring by cp.async
//   while chunk c runs, one copy a step: lane l copies step 32c + l of one
//   of the warp's 32 rows of x (row-major (N, T): one 128-byte run of a row
//   per instruction), and lane r then reads its own series down the slots.
//   The odd extension is the same copy from mirrored indices, its sign and
//   2 x[0] or 2 x[T-1] applied at the step.
// - The forward output: its last kSlots steps overwrite their own x in the
//   ring (a lane's own entries) and stay on chip; the earlier ones go to a
//   time-major (L - kSlots, N) scratch, one coalesced 128-byte row a step,
//   which the L2 cache holds where it fits (the stack's is ~14 MB in fp32,
//   ~55 MB in fp64): x, y and the scratch's reads back are marked evict
//   first in the L2 cache, the scratch's writes evict last.
// - Reverse: the ring's steps are read back first; the scratch's are
//   copied by cp.async into the slots the reverse pass has freed, kAhead
//   chunks ahead, one a step (each lane its own series, so no barrier is
//   needed for them). Each output step overwrites its input in the ring;
//   while chunk c runs, lane l stores step l of one of the 32 rows of chunk
//   c + 1's y a step (row-major: one 128-byte run of a row per
//   instruction).
// kSlots is the most that fits the block's 227 KB (~228 KB an SM): 416 steps
// in fp32, 192 in fp64 (kernels/iir.py::HOLD_STEPS; the launcher refuses
// another count).

#include <cstdint>

#include "common.cuh"
#include "tf32_mma.cuh"  // the commit / wait of the cp.async groups

namespace {

constexpr int kMaxSections = 8;  // an order-8 band-pass
constexpr int kLanes = 32;          // series a warp
constexpr int kWarps = 4;           // warps a block, one a scheduler
constexpr int kChunk = 32;          // time steps a chunk
constexpr int kPitch = kLanes + 1;  // elements a ring slot
constexpr int kAhead = 2;           // chunks copied ahead of the one that runs

// a warp's ring's slots: as many time steps as fit a block's shared memory
template <typename T>
constexpr int kSlots = sizeof(T) == 4 ? 416 : 192;
// a chunk's copies land in slots whose last chunk is consumed, and whose
// outputs are stored (the reverse pass stores chunk c + 1 while it copies
// back chunk c - kAhead)
static_assert(kChunk % kLanes == 0, "a chunk is whole parts of 32 steps");
static_assert(kSlots<double> % kChunk == 0 && kSlots<float> % kChunk == 0, "whole chunks");
static_assert(kSlots<double> / kChunk >= kAhead + 2, "the ring holds the chunks in flight");

// L2 eviction policies: x, y and the scratch's last reads stream through
// the L2 cache (evict first), so that the scratch, written once and read
// back once later, stays there (evict last)
__device__ __forceinline__ uint64_t evict_first() {
    uint64_t p;
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
    return p;
}
__device__ __forceinline__ uint64_t evict_last() {
    uint64_t p;
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
    return p;
}

// one element from global into shared memory, asynchronously (through L1),
// under an L2 policy. No memory clobber: the ring's other slots' loads and
// stores may move across the issue (the copy lands in a slot no step
// touches until the cp.async.wait_group and __syncwarp that order it, both
// compiler barriers)
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src, uint64_t policy) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(sizeof(T)), "l"(policy));
}

// one element to global memory under an L2 policy (no memory clobber: no
// load of the kernel reads y, and the scratch is read back only by cp.async
// after a fence)
__device__ __forceinline__ void store(float* dst, float v, uint64_t policy) {
    asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;\n" ::"l"(dst), "f"(v), "l"(policy));
}
__device__ __forceinline__ void store(double* dst, double v, uint64_t policy) {
    asm volatile("st.global.L2::cache_hint.f64 [%0], %1, %2;\n" ::"l"(dst), "d"(v), "l"(policy));
}

// The S sections' coefficients (scipy rows b0 b1 b2 1 a1 a2) and state, in
// registers; the initial conditions zi (S, 2) are read where a pass starts
template <typename T, int S>
struct Cascade {
    T b0[S], b1[S], b2[S], a1[S], a2[S], z0[S], z1[S];

    __device__ __forceinline__ explicit Cascade(const T* sos) {
#pragma unroll
        for (int k = 0; k < S; ++k) {
            b0[k] = sos[6 * k];
            b1[k] = sos[6 * k + 1];
            b2[k] = sos[6 * k + 2];
            a1[k] = sos[6 * k + 4];
            a2[k] = sos[6 * k + 5];
        }
    }
    // each section's state at zi * v
    __device__ __forceinline__ void start(const T* zi, T v) {
#pragma unroll
        for (int k = 0; k < S; ++k) {
            z0[k] = zi[2 * k] * v;
            z1[k] = zi[2 * k + 1] * v;
        }
    }
    // one time step through the cascade: the last section's output
    __device__ __forceinline__ T step(T v) {
#pragma unroll
        for (int k = 0; k < S; ++k) {
            const T out = b0[k] * v + z0[k];
            z0[k] = b1[k] * v - a1[k] * out + z1[k];
            z1[k] = b2[k] * v - a2[k] * out;
            v = out;
        }
        return v;
    }
};

template <typename T, int S>
__global__ void __launch_bounds__(kLanes * kWarps)
sos_filtfilt_kernel(const T* __restrict__ x,    // (N, T)
                    T* __restrict__ y,          // (N, T)
                    T* __restrict__ fwd,        // (L - slots, N) scratch, where L > slots
                    const T* __restrict__ sos,  // (S, 6)
                    const T* __restrict__ zi,   // (S, 2)
                    int n, int t, int padlen) {
    constexpr int kRing = kSlots<T>;
    extern __shared__ __align__(16) unsigned char iir_smem[];
    const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
    T* ring = reinterpret_cast<T*>(iir_smem) + warp * kRing * kPitch;  // kRing slots of kPitch
    const int s0 = (blockIdx.x * kWarps + warp) * kLanes, s = s0 + lane;
    if (s0 >= n) return;  // no warp of the block waits for another
    const bool valid = s < n;
    const int rows = min(kLanes, n - s0);
    const int len = t + 2 * padlen;
    const int hold = len - kRing;  // steps from here on stay in the ring
    Cascade<T, S> f(sos);
    const T* xs = x + static_cast<size_t>(min(s, n - 1)) * t;
    const T two_first = T(2) * xs[0];
    const T two_last = T(2) * xs[t - 1];
    const uint64_t first = evict_first(), last = evict_last();
    auto slot = [&](int i) { return ring + (i % kRing) * kPitch; };
    // row r of the warp (r < rows: the rows past n are neither copied nor
    // stored, and their lanes' chains run on whatever the ring holds)
    auto row = [&](int r) { return static_cast<size_t>(s0 + r) * t; };

    // the sample of ext step i: mirrored about x[0] and x[T-1] in the extensions
    auto sample = [&](int i) {
        const int j = i - padlen;
        return j < 0 ? -j : j < t ? j : 2 * (t - 1) - j;
    };
    // chunk c of ext at once: lane l copies steps c kChunk + 32 p + l of each row
    auto load_x = [&](int c) {
        for (int p = 0; p < kChunk; p += kLanes) {
            const int i = c * kChunk + p + lane;
            if (i >= len) break;
            const int src = sample(i);
#pragma unroll 8
            for (int r = 0; r < kLanes; ++r)
                if (r < rows) cp_async_elem(slot(i) + r, x + row(r) + src, first);
        }
    };
    // step i of the scratch back into its slot: this lane's series, below hold
    auto fetch = [&](int i) {
        if (valid && i >= padlen && i < hold)
            cp_async_elem(slot(i) + lane, fwd + static_cast<size_t>(i) * n + s, first);
    };
    // chunk c of y at once: lane l stores steps c kChunk + 32 p + l of each row
    auto store_chunk = [&](int c) {
        for (int p = 0; p < kChunk; p += kLanes) {
            const int i = c * kChunk + p + lane;
            if (i < padlen || i >= padlen + t) continue;
            T* yi = y + static_cast<size_t>(s0) * t + (i - padlen);
#pragma unroll 8
            for (int r = 0; r < kLanes; ++r)
                if (r < rows) store(yi + static_cast<size_t>(r) * t, slot(i)[r], first);
        }
    };

    // ---- forward ----
    // Chunk c runs while chunk c + kAhead is copied in, one copy a step:
    // step k copies row k % 32 of its part k / 32. The outputs go to the
    // scratch below hold and over their own x from hold on.
    const int chunks = (len + kChunk - 1) / kChunk;
#pragma unroll
    for (int c = 0; c < kAhead; ++c) {
        if (c < chunks) load_x(c);
        cp_async_commit();  // an empty group past the end keeps the count
    }
    T v = T(0);
    for (int c = 0; c < chunks; ++c) {
        cp_async_wait<kAhead - 1>();  // chunk c has landed (this lane's copies)
        __syncwarp();                 // (everyone's), and chunk c - 1 is consumed
        const int i0 = c * kChunk;
        T* base = slot(i0) + lane;
        if (c == 0) f.start(zi, padlen > 0 ? two_first - base[0] : base[0]);  // zi * ext[0]
        // this lane's copies of chunk c + kAhead, part p: its slot and sample
        constexpr int kParts = kChunk / kLanes;
        T* dst[kParts];
        int src[kParts];
        bool copy[kParts];
#pragma unroll
        for (int p = 0; p < kParts; ++p) {
            const int i = (c + kAhead) * kChunk + p * kLanes + lane;
            copy[p] = c + kAhead < chunks && i < len;
            dst[p] = slot(i);
            src[p] = copy[p] ? sample(i) : 0;
        }
        auto copy_x = [&](int k) {  // step k's copy: row k % 32 of part k / 32
            if (copy[k / kLanes] && k % kLanes < rows)
                cp_async_elem(dst[k / kLanes] + k % kLanes, x + row(k % kLanes) + src[k / kLanes],
                              first);
        };
        const bool series = i0 >= padlen && i0 + kChunk <= padlen + t;
        // the series' chunks: the steps' inputs read at once, so that no
        // step waits on shared memory
        T in[kChunk];
        if (series) {
#pragma unroll
            for (int k = 0; k < kChunk; ++k) in[k] = base[k * kPitch];
        }
        if (series && i0 + kChunk <= hold) {  // the series, to the scratch
            T* out = fwd + static_cast<size_t>(i0) * n + s;
#pragma unroll
            for (int k = 0; k < kChunk; ++k) {
                v = f.step(in[k]);
                if (valid) store(out + static_cast<size_t>(k) * n, v, last);
                copy_x(k);
            }
        } else if (series && i0 >= hold) {  // the series, kept in the ring
#pragma unroll
            for (int k = 0; k < kChunk; ++k) {
                base[k * kPitch] = v = f.step(in[k]);
                copy_x(k);
            }
        } else {  // the extensions, a chunk's end or the edge of the hold
            if (c + kAhead < chunks) load_x(c + kAhead);
            for (int k = 0; k < kChunk && i0 + k < len; ++k) {
                const int i = i0 + k;
                const T raw = base[k * kPitch];
                v = f.step(i < padlen ? two_first - raw : i < padlen + t ? raw : two_last - raw);
                if (i >= hold)
                    base[k * kPitch] = v;
                else if (valid)
                    store(fwd + static_cast<size_t>(i) * n + s, v, last);
            }
        }
        cp_async_commit();
    }
    cp_async_wait<0>();
    __syncwarp();            // every lane is done with the ring's x
    __threadfence_block();   // this lane's scratch stores before its copies back

    // ---- reverse, from the last forward output; the central T samples out ----
    // Chunk c runs while chunk c - kAhead's scratch steps are copied back and
    // chunk c + 1's outputs are stored, one of each a step: step k copies
    // back step k of its chunk and stores row k % 32 of part k / 32.
    f.start(zi, v);
    const int top = (len - 1) / kChunk, bottom = padlen / kChunk;
#pragma unroll
    for (int c = top; c > top - kAhead; --c) {
        if (c >= bottom)
            for (int k = 0; k < kChunk; ++k) fetch(c * kChunk + k);
        cp_async_commit();
    }
    for (int c = top; c >= bottom; --c) {
        cp_async_wait<kAhead - 1>();  // chunk c's scratch steps have landed (this lane's)
        __syncwarp();                 // every lane's chunk c + 1 outputs are in the ring
        const int i0 = c * kChunk, ib = (c - kAhead) * kChunk;
        T* base = slot(i0) + lane;
        const bool back = c - kAhead >= bottom;
        // this lane's stores of chunk c + 1, part p: its slot and y's column
        constexpr int kParts = kChunk / kLanes;
        const T* col[kParts];
        T* yp[kParts];
        bool put[kParts];
#pragma unroll
        for (int p = 0; p < kParts; ++p) {
            const int i = (c + 1) * kChunk + p * kLanes + lane;
            put[p] = c < top && i >= padlen && i < padlen + t;
            col[p] = slot(i);
            yp[p] = y + static_cast<size_t>(s0) * t + (put[p] ? i - padlen : 0);
        }
        if (i0 >= padlen && i0 + kChunk <= padlen + t) {  // every step an output
            T* from = slot(ib) + lane;
            T in[kChunk];  // the steps' inputs read at once
#pragma unroll
            for (int k = 0; k < kChunk; ++k) in[k] = base[k * kPitch];
#pragma unroll
            for (int k = kChunk - 1; k >= 0; --k) {
                base[k * kPitch] = f.step(in[k]);
                // step k copies back step k of chunk c - kAhead ...
                if (back && valid && ib + k >= padlen && ib + k < hold)
                    cp_async_elem(from + k * kPitch, fwd + static_cast<size_t>(ib + k) * n + s,
                                  first);
                // ... and stores row k % 32 of part k / 32 of chunk c + 1
                if (put[k / kLanes] && k % kLanes < rows)
                    store(yp[k / kLanes] + static_cast<size_t>(k % kLanes) * t,
                          col[k / kLanes][k % kLanes], first);
            }
        } else {
            if (c < top) store_chunk(c + 1);
            if (back)
                for (int k = 0; k < kChunk; ++k) fetch(ib + k);
            for (int k = kChunk - 1; k >= 0; --k) {
                const int i = i0 + k;
                if (i >= len) continue;
                if (i < padlen) break;  // the padlen steps below change no output
                const T out = f.step(base[k * kPitch]);
                if (i < padlen + t) base[k * kPitch] = out;
            }
        }
        cp_async_commit();
    }
    __syncwarp();  // every lane's last outputs are in the ring
    store_chunk(bottom);
}

template <typename T, int S>
cudaError_t launch_s(const T* x, T* y, T* fwd, const T* sos, const T* zi, int n, int t,
                     int padlen, cudaStream_t stream) {
    constexpr size_t smem = sizeof(T) * kWarps * kSlots<T> * kPitch;
    cudaError_t err = allow_dynamic_smem(sos_filtfilt_kernel<T, S>, smem);
    if (err == cudaSuccess)  // the ring wants the SM's shared memory, not L1
        err = cudaFuncSetAttribute(sos_filtfilt_kernel<T, S>,
                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    const unsigned blocks = static_cast<unsigned>((n + kLanes * kWarps - 1) / (kLanes * kWarps));
    sos_filtfilt_kernel<T, S><<<blocks, kLanes * kWarps, smem, stream>>>(x, y, fwd, sos, zi, n, t,
                                                                         padlen);
    return cudaGetLastError();
}

template <typename T>
int launch(const T* x, T* y, T* fwd, const T* sos, const T* zi, int n, int t, int padlen,
           int sections, int scratch_steps, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    // the wrapper checks these too (kernels/iir.py::_check_filter, _launch):
    // the odd extension reads x[padlen] and x[T - 1 - padlen], and the
    // scratch holds the forward steps below the ring's
    const long long len = static_cast<long long>(t) + 2LL * padlen;
    const long long below = len > kSlots<T> ? len - kSlots<T> : 0;
    if (n <= 0 || t <= padlen || padlen < 0 || sections < 1 || sections > kMaxSections ||
        len > 0x7fffffff || scratch_steps != below)
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

// scratch_steps is the wrapper's count of the scratch's rows (L - slots, or
// 0 where the ring holds every step; kernels/iir.py::scratch_steps), which
// must equal the kernel's
extern "C" int msa_sos_filtfilt(const float* x, float* y, float* fwd, const float* sos,
                                const float* zi, int n, int t, int padlen, int sections,
                                int scratch_steps, int device, void* stream) {
    return launch(x, y, fwd, sos, zi, n, t, padlen, sections, scratch_steps, device, stream);
}

extern "C" int msa_sos_filtfilt_f64(const double* x, double* y, double* fwd, const double* sos,
                                    const double* zi, int n, int t, int padlen, int sections,
                                    int scratch_steps, int device, void* stream) {
    return launch(x, y, fwd, sos, zi, n, t, padlen, sections, scratch_steps, device, stream);
}
