"""Hand-written CUDA kernels (built from ``csrc/`` at first use)."""
