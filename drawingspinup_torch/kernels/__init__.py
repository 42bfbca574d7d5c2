"""Hand-written CUDA kernels for Hopper (sm_90a) for the Pallas kernels of
the JAX package, the hash-grid encode and stage 2a's attention core, each
beside its plain PyTorch twin. Sources are under ``csrc/``; ``_build.py``
compiles them at first use."""
