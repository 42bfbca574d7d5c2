"""Hand-written CUDA kernels for Hopper (sm_90a), one per Pallas kernel of
the JAX package, each beside its plain PyTorch twin. Sources are under
``csrc/``; ``_build.py`` compiles them at first use."""
