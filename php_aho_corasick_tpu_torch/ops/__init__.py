"""Device ops of the port: plain PyTorch and the CUDA kernels."""

# the hand kernels' modules: importing them registers every kernel in
# ``_build.KERNELS``
from . import filter_cuda, scan_cuda  # noqa: F401
