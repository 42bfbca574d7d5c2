"""DrawingSpinUp in PyTorch for an NVIDIA Hopper GPU.

A port of ``drawingspinup_tpu`` (the JAX package, which stays the
reference). Module names and layout follow the JAX package, so each module
here has its counterpart at the same path there. Every Pallas kernel of the
JAX package becomes a hand-written CUDA kernel under ``kernels/``, with a
plain PyTorch twin that the CPU tests hold against JAX.

This package imports ``torch`` and never ``jax``, ``flax``, ``optax`` or
``orbax``, nor any module of ``drawingspinup_tpu``: the machine with the GPU
has no JAX. The numpy helpers and host code it shares with the JAX package
(RIC tables, frame loading, IO, the GIF writer, cameras, the config loader,
mesh post-processing) are copies, each pinned to its original by a CPU
test; the repository's C++ mesh code (``native/``) is compiled, not
copied (``native.py``).
"""

__version__ = "0.1.0"
