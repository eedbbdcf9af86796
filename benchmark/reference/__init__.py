"""Plain float32 references of the benchmark's configurations.

Plain PyTorch and NumPy only: nothing here imports the measured program, so
a later change to the program cannot move the yardstick. Each module is a
frozen copy of a documented rule or a straightforward implementation of the
published model (``MultimodalModel.py`` of the reference repository)."""
