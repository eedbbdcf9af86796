from .checkpoint import load_checkpoint, save_checkpoint, strip_module_prefix
from .checks import checkified
from .profiling import StepTimer, dump_graph, enable_nan_debugging, timed, trace
from .schedule import (
    EarlyStopping,
    ReduceLROnPlateau,
    vector_schedule_init,
    vector_schedule_step,
)
from .seeding import seed_all

__all__ = [
    "EarlyStopping",
    "ReduceLROnPlateau",
    "StepTimer",
    "checkified",
    "dump_graph",
    "enable_nan_debugging",
    "load_checkpoint",
    "save_checkpoint",
    "seed_all",
    "strip_module_prefix",
    "timed",
    "trace",
    "vector_schedule_init",
    "vector_schedule_step",
]
