"""Full float32 on the card, whatever the caller has set; bf16 products
that reduce in float32."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["full_float32", "bf16_full_reduction"]


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


@contextlib.contextmanager
def bf16_full_reduction():
    """bf16 matmuls reduce in float32 inside the block, restored after it.
    cuBLAS may otherwise reduce a bf16 product in bf16
    (``allow_bf16_reduced_precision_reduction`` is True by default); the
    reference's bf16 ``conv0`` accumulates in float32 and rounds once."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = prev
