"""PyTorch / CUDA port of the reproduction of "Optimal Complexity in
Non-Convex Decentralized Learning over Time-Varying Networks".

The JAX package ``repro`` is the reference; this package keeps its module
layout and names, runs on an NVIDIA H100 (``device="cuda"`` by default), and
replaces each Pallas TPU kernel with a hand-written Hopper kernel
(``repro_torch.kernels``).  It imports neither jax nor ``repro``.
"""
