"""nvcc build and ctypes binding of the hand-written CUDA kernels."""
