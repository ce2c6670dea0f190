"""The plain reference: plain PyTorch, no import of the port or of JAX."""

import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    """float32 products and convolutions without TF32 inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
