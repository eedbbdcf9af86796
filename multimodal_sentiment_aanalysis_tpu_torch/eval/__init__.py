"""Evaluation and serving: the :class:`Tester` and its reports, the serving
forward (:mod:`.serving`), its ``torch.export`` artifacts (:mod:`.export`)
and the int8 serving forward (:mod:`.quantization`). The names below import
their submodule on first use (PEP 562), so that :func:`.export.load_serving`
imports no model code.
"""

import importlib

_LAZY = {
    "INPUT_SCHEMA": "export",
    "Myreport": "reporting",
    "ServingModule": "serving",
    "Tester": "tester",
    "build_quantized_serving_forward": "quantization",
    "build_serving_forward": "serving",
    "export_serving": "export",
    "history2df": "reporting",
    "load_serving": "export",
    "plot_confusion_matrix": "reporting",
    "plot_progress": "reporting",
    "plot_subject_accuracies": "reporting",
    "save_history": "reporting",
}


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)


__all__ = sorted(_LAZY)
