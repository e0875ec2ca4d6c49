"""CUDA kernels of the port (``csrc/``), each with its wrapper, launch
counter and plain PyTorch version. Kernels are built on first launch."""
