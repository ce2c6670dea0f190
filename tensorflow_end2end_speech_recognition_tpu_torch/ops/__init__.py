"""Kernel wrappers (``lstm``, ``ctc``, ``attention``), losses, and the builder of
the CUDA sources in ``csrc/``."""
