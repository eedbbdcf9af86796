"""Tracing and profiling (JAX ``utils/profiling.py``).

- :func:`timed`, :class:`StepTimer`: wall-clock timing around synchronised
  calls (a CUDA launch returns before the card is done);
- :func:`trace`: a ``torch.profiler`` window over the CPU and, with a card,
  CUDA activities, written as a Chrome trace file;
- :func:`enable_nan_debugging`: ``torch.autograd.set_detect_anomaly``, the
  global analog of the reference's per-batch NaN guards: a backward that
  produces NaN raises, naming the forward op.

- :func:`dump_graph`: the ``torch.export`` program of a function or module
  at example arguments, the counterpart of the JAX module's ``dump_jaxpr``
  / ``dump_hlo``. ``dump_hlo(optimized=True)`` has none: no compiler stands
  between the traced program and the kernels that run it.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable

import torch

from .timing import host_sync


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 1, **kwargs) -> tuple[float, Any]:
    """Mean wall-clock seconds per call of ``fn`` over ``iters`` calls after
    ``warmup``, the device synchronised around the window; returns
    ``(mean seconds, last result)``."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
    host_sync(result)
    t0 = time.perf_counter()
    for _ in range(iters):
        result = fn(*args, **kwargs)
    host_sync(result)
    return (time.perf_counter() - t0) / iters, result


class StepTimer:
    """Accumulates per-step wall times (``with timer: ...`` around a step
    that ends synchronised); reports it/s like the reference's tqdm."""

    def __init__(self) -> None:
        self.times: list[float] = []
        self._t0: float | None = None

    def __enter__(self) -> "StepTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.times.append(time.perf_counter() - self._t0)

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def rate(self, items_per_step: int = 1) -> float:
        """Items per second (e.g. samples/s at a given batch size)."""
        return items_per_step / self.mean if self.times else 0.0


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (CPU activities, and CUDA ones when
    a card is present); on exit writes ``log_dir/trace.json`` (Chrome trace
    format). Yields the profiler, whose ``key_averages()`` tables the
    block's ops."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class _Call(torch.nn.Module):
    """A function as a module, for ``torch.export``."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def dump_graph(fn_or_module: Callable, *example_args, path: str | None = None,
               dynamic_batch: bool = False) -> str:
    """The text of the ``torch.export`` program of ``fn_or_module`` at the
    example arguments: every aten op and custom op (``msa_torch::*``, the
    kernels) with its shapes. ``dynamic_batch`` makes the leading dimension
    of every tensor argument one symbolic batch. Written to ``path`` where
    given."""
    module = fn_or_module if isinstance(fn_or_module, torch.nn.Module) else _Call(fn_or_module)
    dynamic = None
    if dynamic_batch:
        batch = torch.export.Dim("b")
        dynamic = tuple({0: batch} if isinstance(a, torch.Tensor) else None
                        for a in example_args)
        if isinstance(module, _Call):  # its forward takes *args: one spec for the tuple
            dynamic = (dynamic,)
    with torch.no_grad():
        program = torch.export.export(module, tuple(example_args), dynamic_shapes=dynamic,
                                      strict=False)
    text = str(program)
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


def enable_nan_debugging(enable: bool = True) -> None:
    """Global NaN tripwire: autograd's anomaly mode, under which a backward
    op that returns NaN raises and names the forward op that made it."""
    torch.autograd.set_detect_anomaly(enable)
