"""PyTorch ops of the port: plain versions (CPU tensors) and wrappers of
the hand-written CUDA kernels (CUDA tensors)."""
