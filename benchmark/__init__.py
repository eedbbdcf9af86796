"""The benchmark of the PyTorch and CUDA port: ``python benchmark/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
