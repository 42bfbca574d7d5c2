"""Data parallelism over ``torch.distributed`` (counterpart of
``drawingspinup_tpu/parallel/``): one process per GPU, as torchrun starts
them, in place of JAX's one SPMD process over a device mesh."""
