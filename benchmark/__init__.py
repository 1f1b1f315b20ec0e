"""The benchmark of trident_tpu_torch (the PyTorch and CUDA port): see
run.py for the command and PERF.md for what it measures."""
