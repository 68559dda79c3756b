"""The benchmark harness of the PyTorch and CUDA port (see perfbench/run.py)."""
