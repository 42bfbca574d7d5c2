"""Hand-written CUDA kernels for Hopper (sm_90a) for the Pallas kernels of
the JAX package and the hash-grid encode, each beside its plain PyTorch
twin. Sources are under ``csrc/``; ``_build.py`` compiles them at first
use."""
