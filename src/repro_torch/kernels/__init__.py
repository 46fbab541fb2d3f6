"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version; :mod:`.runtime` resolves which of the two a call runs."""
