"""NEURON-Fabric on PyTorch and CUDA: low-bit gradient aggregation with
hand-written Hopper kernels.

The counterpart of the JAX package ``repro``, module for module.  It
imports ``torch`` and ``numpy`` only; entry points run on a CUDA device
unless the caller asks for the CPU.
"""
