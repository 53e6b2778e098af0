"""SMC kernels, state and driver (PyTorch)."""
