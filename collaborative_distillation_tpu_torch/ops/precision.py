"""Full float32 on the card, whatever the caller has set."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["full_float32"]


@contextlib.contextmanager
def full_float32():
    """cuDNN convolutions and matmuls in full float32 inside the block,
    restored after it. The package turns TF32 off when imported, but a
    caller may turn it on again afterwards (PyTorch allows it in cuDNN by
    default); TF32 would move a result about 1e-3 relative from the float32
    reference (``lax.Precision.HIGHEST``), so the training step, MobileNet's
    convolutions and the Gram product hold float32 whatever the caller set."""
    cudnn = torch.backends.cudnn
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        torch.set_float32_matmul_precision(prec)
