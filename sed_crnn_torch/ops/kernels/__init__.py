"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Importing this package builds nothing; see `_build`."""
