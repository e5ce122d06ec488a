"""PyTorch/CUDA port of graphneuralnetwork_tpu for one NVIDIA Hopper card.

The JAX package beside it is the reference: this package builds the same
graph layouts from the same host arrays and runs the same layers, with the
TPU's Pallas kernels replaced by CUDA C++ kernels written for ``sm_90a``
(``csrc/``, built with ``nvcc`` at first use). It never imports JAX.

Entry points run on the card unless the caller passes ``device="cpu"``;
on CPU tensors every kernel wrapper takes its plain PyTorch version.
"""
