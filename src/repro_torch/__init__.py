"""PyTorch/CUDA port of the ``repro`` serving system for NVIDIA Hopper.

Same module layout as the JAX package (``configs``, ``kernels``,
``models``, ``serving``); the TPU Pallas kernels are replaced by
hand-written CUDA kernels under ``kernels/csrc``. Entry points run on
the card (``device="cuda"``) unless the caller asks for the CPU, where
every kernel op takes its plain PyTorch version instead.
"""
