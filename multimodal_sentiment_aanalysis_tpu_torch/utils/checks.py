"""Runtime NaN/Inf audits (JAX ``utils/checks.py``).

The reference's only numeric guard is a per-batch host-side NaN check
(``Trainer.py:63-76``). :func:`checkified` is the stronger analog of the
JAX package's ``checkify`` wrapper: it runs a function under a
``TorchDispatchMode`` that looks at every floating-point output of every
aten op, forward and backward, and raises on the first NaN or Inf, naming
the op. It changes no value, so an audited run computes what an unaudited
one does, one host sync per op slower.

Coverage: a hand-written CUDA kernel launches through ``ctypes`` and writes
into a tensor that ``torch.empty`` allocated, which is no op to the mode; a
NaN that a kernel writes is caught at the first aten op that reads it, and
named by that op. On CPU tensors the kernels' plain versions are aten ops
and are checked one by one. The allocations (``empty``, ``new_empty`` and
their kin) are not checked: their contents are whatever the memory held,
a NaN bit pattern now and then, and no value of the program; the op that
writes into one is.
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class NonFiniteError(FloatingPointError):
    """An op produced a NaN or an Inf under :func:`checkified`."""


_aten = torch.ops.aten
# ops whose output is uninitialised memory
_ALLOCATIONS = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
                _aten.new_empty_strided}


class _NonFiniteCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in _ALLOCATIONS:
            return out
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel()
                    and not bool(torch.isfinite(t).all())):
                kind = "a NaN" if bool(torch.isnan(t).any()) else "an Inf"
                raise NonFiniteError(f"{func} produced {kind} (output of shape "
                                     f"{tuple(t.shape)}, {t.dtype})")
        return out


def checkified(fn):
    """Wrap ``fn`` to raise :class:`NonFiniteError` on the first NaN or Inf
    that any op inside it produces, naming the op. Example: audit one train
    epoch, ``checkified(trainer.train_epoch)(1)``."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _NonFiniteCheck():
            return fn(*args, **kwargs)

    return wrapper
