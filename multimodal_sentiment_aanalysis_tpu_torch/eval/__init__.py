from .reporting import (
    Myreport,
    history2df,
    plot_confusion_matrix,
    plot_progress,
    plot_subject_accuracies,
    save_history,
)
from .serving import build_serving_forward
from .tester import Tester

__all__ = [
    "Myreport",
    "Tester",
    "build_serving_forward",
    "history2df",
    "plot_confusion_matrix",
    "plot_progress",
    "plot_subject_accuracies",
    "save_history",
]
