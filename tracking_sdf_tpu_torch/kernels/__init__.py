"""Build and load the package's CUDA kernels (sources in ``csrc/``)."""
