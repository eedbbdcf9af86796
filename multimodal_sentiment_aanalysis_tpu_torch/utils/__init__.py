from .schedule import (
    EarlyStopping,
    ReduceLROnPlateau,
    vector_schedule_init,
    vector_schedule_step,
)

__all__ = ["EarlyStopping", "ReduceLROnPlateau", "vector_schedule_init", "vector_schedule_step"]
