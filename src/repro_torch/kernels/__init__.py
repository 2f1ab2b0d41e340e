"""Hand-written CUDA kernels of the port and their launch plumbing."""
