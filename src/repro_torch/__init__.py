"""CLAX click models in PyTorch for NVIDIA Hopper: the port of ``repro``.

Same layout and names as the JAX package. This package imports torch and
numpy and nothing of JAX or ``repro``; numpy-only code it needs from
``repro`` is copied in. The loss kernels are hand-written for Hopper
(``kernels/``): a CUDA tensor launches them, a CPU tensor takes their plain
versions.
"""
