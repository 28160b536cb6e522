"""PyTorch and CUDA port of ``scalable_hw_agnostic_inference_tpu``.

The JAX package beside this one is the reference: every module here names
its counterpart there, and the tests hold the two against each other. This
package imports ``torch``, ``numpy`` and the standard library only — never
JAX, and nothing of the JAX package. Its hot kernels are CUDA C++ for
Hopper (``csrc/``), built with ``nvcc`` at first use (``ops/cuda``).
"""
