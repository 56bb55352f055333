"""Hand-written Hopper kernels of the port and their plain PyTorch
versions (``ops`` is the public surface, ``build`` compiles ``csrc/``)."""
