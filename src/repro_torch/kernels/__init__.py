"""Hand-written CUDA kernels of the port (``csrc/``), their build, and
their PyTorch wrappers with plain versions."""
