"""Device ops of the port: plain PyTorch and the CUDA kernels."""
