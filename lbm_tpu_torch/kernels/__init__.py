"""Hand-written CUDA kernels, their nvcc build helper and their wrappers."""
