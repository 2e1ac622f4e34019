"""Matrix-product precision control."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Run f32 matrix products and triangular solves in full f32 whatever
    the global TF32 switches say (JAX's `Precision.HIGHEST`)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
