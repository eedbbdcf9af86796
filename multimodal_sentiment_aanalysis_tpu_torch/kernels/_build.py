"""Build the CUDA sources under ``csrc/`` and launch them through ``ctypes``.

Every ``csrc/*.cu`` compiles on first use, with ``nvcc`` for ``sm_90a``,
into its own shared library with a plain C interface under
``build/kernels/`` at the root of the checkout. The library's file name
carries a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads at once. A missing ``nvcc`` or a failed build
raises: there is no fallback to the plain PyTorch versions.

Each C entry point takes device pointers, sizes, the device index and the
stream, launches on that stream without synchronising, and returns
``cudaGetLastError()``; :meth:`CudaKernel.launch` raises if that is not 0.

The training kernels take a leading model axis S (grid axis z), so under
``torch.func.vmap`` each ``autograd.Function``'s ``vmap`` rule makes one
launch for all S models; :func:`models_first` lays out that rule's inputs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"  # used when nvcc is not on PATH
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), DEFAULT_NVCC):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build from source on first use "
        "and need the CUDA toolkit"
    )


def _digest(source: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its current build exists; return
    the library's path."""
    source = CSRC / f"{name}.cu"
    lib = BUILD_DIR / f"{name}-{_digest(source)}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {source.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib


def ptxas_report(name: str) -> str:
    """ptxas's report (``nvcc -Xptxas -v``) on ``csrc/<name>.cu`` built with
    the libraries' flags into a throwaway cubin: each kernel's registers,
    spills and shared memory. Raises where nvcc fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cubin = BUILD_DIR / f"{name}.{os.getpid()}.cubin"
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cmd = [_nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-I", str(CSRC), "-o", str(cubin),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    cubin.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed on {name}.cu (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build_all() -> list[Path]:
    """Build every kernel library under ``csrc/``, one nvcc per source, all
    started together."""
    sources = [src.stem for src in sorted(CSRC.glob("*.cu"))]
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return list(pool.map(build, sources))


def kernel_forms(source: str, symbol: str, argtypes: list) -> dict[torch.dtype, "CudaKernel"]:
    """The fp32 and bf16 forms of one kernel: the C entry points ``symbol``
    and ``symbol + "_bf16"`` of one library, each with its own launch
    count."""
    return {torch.float32: CudaKernel(source, symbol, argtypes),
            torch.bfloat16: CudaKernel(source, symbol + "_bf16", argtypes)}


class CallCount:
    """Calls of a wrapper that launches several kernels, each with its own
    :class:`CudaKernel` count: ``launches`` grows by one per call whose
    launches CUDA all accepted, and nowhere else."""

    def __init__(self):
        self.launches = 0


def call_counts() -> dict[torch.dtype, CallCount]:
    """A :class:`CallCount` for the fp32 and the bf16 form of a wrapper."""
    return {torch.float32: CallCount(), torch.bfloat16: CallCount()}


class CudaKernel:
    """One C entry point of one kernel library, and its launch count.

    ``argtypes`` lists the kernel's own arguments; the device index and the
    stream are appended by :meth:`launch`. ``launches`` grows by one for
    every launch that CUDA accepted, and nowhere else.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._lib = None

    def _load(self):
        self._lib = ctypes.CDLL(str(build(self.source)))
        fn = getattr(self._lib, self.symbol)
        fn.argtypes = [*self.argtypes, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self._lib.msa_error_string.argtypes = [ctypes.c_int]
        self._lib.msa_error_string.restype = ctypes.c_char_p
        self._fn = fn
        return fn

    def launch(self, device: torch.device, *args) -> None:
        fn = self._fn or self._load()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, device.index, stream)
        if err != 0:
            msg = self._lib.msa_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: {msg}")
        self.launches += 1


def upcast(t: torch.Tensor) -> torch.Tensor:
    """``t`` in at least fp32: the plain versions read a bf16 operand as its
    kernel's bf16 form does and compute in fp32."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """A tensor's device pointer; null for an operand the kernel does not read."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


F32 = (torch.float32,)
F32_BF16 = (torch.float32, torch.bfloat16)


def check_cuda(name: str, t: torch.Tensor, device: torch.device,
               shape: tuple[int, ...] | None = None,
               dtypes: tuple[torch.dtype, ...] = F32) -> None:
    """Raise unless ``t`` is a contiguous tensor of one of ``dtypes`` on
    ``device`` (and of ``shape``, where given): a ``TypeError`` for a dtype
    the kernel has no form for."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"{name} is {t.dtype}; this kernel takes {names}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


# the largest grid z extent: the model axis of the S-axis kernels (the
# BiLSTM's cluster kernels put the model in grid x, whose limit is far above)
MAX_MODELS = 65535


def with_models(*ts: torch.Tensor) -> tuple[tuple[torch.Tensor, ...], bool]:
    """``(tensors with a leading model axis, whether it was added)``: one
    model's tensors (the first one 3-D) get S = 1."""
    one = ts[0].dim() == 3
    return (tuple(t[None] for t in ts) if one else ts), one


def models_first(info, in_dims, *args) -> list:
    """A ``vmap`` rule's arguments with the model axis first: each batched
    tensor moved to dim 0, each unbatched one expanded to
    ``info.batch_size`` models, all contiguous (one S-wide launch reads
    them); non-tensor arguments pass as they are."""
    out = []
    for a, d in zip(args, in_dims):
        if not isinstance(a, torch.Tensor):
            out.append(a)
        elif d is None:
            out.append(a.expand(info.batch_size, *a.shape).contiguous())
        else:
            out.append(a.movedim(d, 0).contiguous())
    return out
