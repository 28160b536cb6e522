"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Importing these modules builds nothing: the kernel library is compiled and
loaded at the first launch (``_build.library``).
"""
