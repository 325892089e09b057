"""Layer ops: plain PyTorch versions here, CUDA kernels in ``hopper/``."""
