"""Ops of the port. Kernels live in ``csrc/`` and are built at first use
(``_build``); every kernel wrapper computes its plain PyTorch version
on CPU tensors."""
