"""Hand-written Hopper kernels of the port, each beside its plain version.

=====================  ===============================  ==========================
module                 kernel source                    replaces (JAX package)
=====================  ===============================  ==========================
``lstm``               ``csrc/lstm_fwd.cu``             ``kernels/lstm.py::_fwd_xproj_kernel``
``conv_stem_train``    ``csrc/stem_tail.cu``            ``kernels/conv_stem_train.py::_fwd_kernel``
``conv_stem``          ``csrc/conv_stem.cu``            ``kernels/conv_stem.py::_stage_kernel``
=====================  ===============================  ==========================

Each wrapper counts its launches, so a run can show which kernels its path
went through (:func:`launch_counts`).
"""

from . import conv_stem, conv_stem_train, lstm
from ._build import build_all

KERNELS = {
    "bilstm_fwd": lstm.KERNEL,
    "stem_tail": conv_stem_train.KERNEL,
    "conv_stem": conv_stem.KERNEL,
}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


__all__ = ["KERNELS", "build_all", "launch_counts", "reset_launch_counts"]
