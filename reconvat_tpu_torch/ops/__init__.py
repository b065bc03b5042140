"""Signal-chain operators and their CUDA kernel wrappers."""
