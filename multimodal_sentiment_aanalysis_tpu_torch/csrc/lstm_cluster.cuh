// Shared by the BiLSTM's two serial kernels on a thread-block cluster: the
// forward recurrence (lstm_fwd.cu, msa_bilstm_rec) and the reverse sweep
// (lstm_bwd.cu, msa_bilstm_sweep).
//
// Both run one cluster of C CTAs per (model, direction, batch tile of bt
// rows), C a power of two up to 8 that divides H, picked by the wrapper
// (kernels/lstm.py::cluster_plan). CTA k of a cluster owns the H / C = U
// hidden units [k U, (k + 1) U) and their four gate columns, and holds those
// 4U rows of this direction's W_hh in shared memory for the whole sweep, so c
// and the cell arithmetic stay local to it. A thread owns one unit u and kRt
// batch rows r = rc + groups * q (q < kRt, groups = ceil(bt / kRt) row chunks,
// rc < groups): rows interleaved so that the lanes of a warp that hold
// neighbouring chunks read neighbouring shared-memory rows. kRt (2, 4 or 8)
// is the kernels' template parameter: each step's serial work per thread is
// kRt x 4H multiply-adds, so a small batch spread over more threads and
// clusters finishes a step sooner. The block runs ceil32(groups * U) <=
// kClusterMaxThreads threads.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int kClusterMaxThreads = 512;   // 128 registers a thread

__device__ __forceinline__ size_t align16(size_t bytes) { return (bytes + 15) & ~size_t{15}; }

// The cluster barrier in two halves, so that work between them overlaps the
// other CTAs' arrival: arrive releases this thread's shared-memory writes,
// wait acquires every other thread's. Each thread alternates them.
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Calls launch(std::integral_constant<int, kRt>) for kRt = rows, 2, 4 or 8.
template <typename Launch>
inline cudaError_t by_rows(int rows, Launch launch) {
    switch (rows) {
        case 2: return launch(std::integral_constant<int, 2>{});
        case 4: return launch(std::integral_constant<int, 4>{});
        case 8: return launch(std::integral_constant<int, 8>{});
        default: return cudaErrorInvalidValue;
    }
}

// Launch `kernel` as nclusters clusters of `cluster` CTAs along x.
template <typename Kernel, typename... Args>
inline cudaError_t launch_cluster(Kernel kernel, int cluster, int nclusters, int threads,
                                  size_t smem, void* stream, Args... args) {
    cudaError_t err = allow_dynamic_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(cluster) * nclusters);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// Where this CTA sits: cluster index = (model, direction, batch tile), tile
// fastest; rank within the cluster
struct ClusterPos {
    int C, rank, tile, d;
    size_t model;
};

__device__ __forceinline__ ClusterPos cluster_pos(int ntiles) {
    cg::cluster_group cluster = cg::this_cluster();
    ClusterPos p;
    p.C = static_cast<int>(cluster.num_blocks());
    p.rank = static_cast<int>(cluster.block_rank());
    const int cid = blockIdx.x / p.C;
    p.tile = cid % ntiles;
    p.d = (cid / ntiles) % 2;
    p.model = cid / (ntiles * 2);
    return p;
}
