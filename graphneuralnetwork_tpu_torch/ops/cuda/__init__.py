"""Hand-written CUDA kernels (``csrc/``) and their PyTorch wrappers.

Every wrapper launches its kernel for CUDA tensors (or raises) and takes
its plain PyTorch version for CPU tensors. Importing this package builds
nothing: a kernel is compiled at its first launch, or by ``build.build()``.
"""
