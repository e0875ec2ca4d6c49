"""repro_torch: the Sextans SpMM system in PyTorch, with hand-written CUDA
kernels for Hopper (sm_90a). The JAX package ``repro`` is its reference."""
__version__ = "1.0.0"
