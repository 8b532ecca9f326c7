"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``ref``), built from ``csrc/`` by ``build`` on first use."""
