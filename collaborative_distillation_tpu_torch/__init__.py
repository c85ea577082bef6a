"""Collaborative-Distillation on PyTorch and CUDA (NVIDIA Hopper).

The WCT stylization cascade of ``collaborative_distillation_tpu`` rebuilt on
PyTorch, with its kernels written by hand in CUDA C++ for ``sm_90a``. Public
functions keep the reference package's layouts (NHWC activations, HWIO
weights, float32) so the two can be compared like for like.

Public surface:
    models   — VGG autoencoder specs, apply functions and the weight zoo
    ops      — NHWC conv/pool/upsample primitives, WCT transform math, and
               the CUDA kernels behind them (``ops.cuda``)
    wct      — the 5-level stylization cascade engine
    utils    — carrying the reference package's parameters across

Entry points run on the GPU unless the caller passes ``device="cpu"``: a CPU
tensor takes each kernel's plain PyTorch version, a CUDA tensor launches the
kernel or raises.
"""

import torch

# The reference takes its statistics and WCT products in full float32
# (lax.Precision.HIGHEST). TF32 keeps about three decimal digits, which the
# eigendecomposition of a covariance over millions of pixels cannot afford,
# so both matmul and cuDNN (the plain conv yardstick) are held to float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
