"""The reduction of a profiler trace: busy time as the union of device
intervals, kernels by listed names, and each idle gap put down to the host
operator that launched the work after it."""

from benchmark import harness


def _events():
    return [
        {"cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 50, "tid": 1},
        {"cat": "cpu_op", "name": "aten::cat", "ts": 60, "dur": 40, "tid": 1},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10, "dur": 2, "tid": 1,
         "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 70, "dur": 2, "tid": 1,
         "args": {"correlation": 2}},
        {"cat": "kernel", "name": "bilstm_gemm_kernel<1>", "ts": 20, "dur": 30,
         "args": {"correlation": 1}},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 40, "dur": 20, "args": {}},
        {"cat": "kernel", "name": "cudnn::genericTranspose_kernel", "ts": 80, "dur": 10,
         "args": {"correlation": 2}},
    ]


def test_trace_reduction():
    t = harness.Trace(_events(), window_s=100e-6)
    assert t.busy == [(20.0, 60.0), (80.0, 90.0)]
    assert abs(t.busy_s - 50e-6) < 1e-12
    assert t.kernel_seconds(["bilstm"], []) == (30e-6, 1)
    assert t.kernel_seconds(["cudnn", "bilstm"], ["bilstm"]) == (10e-6, 1)
    assert t.idle_gaps() == [["aten::cat", 20e-6]]
    assert t.top_ops()[0] == ["bilstm_gemm_kernel<1>", 30e-6]
