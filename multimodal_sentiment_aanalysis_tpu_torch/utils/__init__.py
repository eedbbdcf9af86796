from .schedule import EarlyStopping, ReduceLROnPlateau

__all__ = ["EarlyStopping", "ReduceLROnPlateau"]
