"""Device (PyTorch, hand-written CUDA) kernels for the hot pipeline stages."""
