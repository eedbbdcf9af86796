"""Timing primitives (JAX ``utils/timing.py``).

CUDA launches return before the card finishes, so every timing boundary
waits for the device: :func:`host_sync` synchronises the device of the
first CUDA tensor in an output (a no-op for CPU outputs). :func:`timed`,
:func:`timed_out` and :func:`timed_fresh` are best-of-``reps`` host-clock
seconds around synchronised calls; :func:`cuda_ms` is the device's own
milliseconds per call from CUDA events.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch


def _tensors(out: Any):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)


def host_sync(out: Any) -> None:
    """Wait until the work behind ``out`` (a tensor, or a dict, list or
    tuple holding tensors) is done: ``torch.cuda.synchronize`` on the device
    of its first CUDA tensor."""
    for t in _tensors(out):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def timed(fn: Callable, *args, reps: int = 3) -> float:
    """Best-of-``reps`` host-clock seconds of ``fn(*args)``, synchronised,
    after one warm-up call."""
    return timed_out(fn, *args, reps=reps)[0]


def timed_out(fn: Callable, *args, reps: int = 3) -> tuple[float, Any]:
    """Like :func:`timed`, and also the last output."""
    out = fn(*args)
    host_sync(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        host_sync(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def timed_fresh(fn: Callable, argf: Callable[[int], tuple], reps: int = 3) -> float:
    """Best-of-``reps`` host-clock seconds with fresh arguments per call:
    ``argf(i)`` gives the arguments of call ``i`` (0 is the warm-up)."""
    host_sync(fn(*argf(0)))
    best = float("inf")
    for i in range(1, reps + 1):
        args = argf(i)
        t0 = time.perf_counter()
        host_sync(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def cuda_ms(fn: Callable, *args, calls: int = 20, warmup: int = 1) -> float:
    """Device milliseconds per call of ``fn(*args)`` on the current CUDA
    device: CUDA events around ``calls`` back-to-back calls after
    ``warmup`` ones. Needs a card."""
    for _ in range(warmup):
        fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls
