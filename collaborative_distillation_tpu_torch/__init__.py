"""Collaborative-Distillation on PyTorch and CUDA (NVIDIA Hopper).

The WCT stylization cascade of ``collaborative_distillation_tpu`` rebuilt on
PyTorch, with its kernels written by hand in CUDA C++ for ``sm_90a``. Public
functions keep the reference package's layouts (NHWC activations, HWIO
weights, float32) so the two can be compared like for like.

Public surface:
    models   — VGG autoencoder specs, apply functions and the weight zoo;
               MobileNetV1 encoders
    ops      — NHWC conv/pool/upsample primitives, WCT transform math, Gram
               and AdaIN statistics, and the CUDA kernels behind them
               (``ops.cuda``)
    wct      — the 5-level stylization cascade engine (photo-WCT included),
               the whole cascade as one function, and its UHD row-slab path
    train    — the collaborative-distillation loss graphs, the trainer and
               the L1-pruning initializer
    utils    — carrying the reference package's parameters (and Adam
               states) across; checkpoints; host<->device copies; image
               files, logging; the profiler's spans, the launch and pinned
               buffer counters and a trace exporter; FLOP counts and the
               card's peak
    data     — JPEG by device (nvJPEG on the card, the native libjpeg
               binding on the host), PNG, the training and inference
               datasets and the threaded loader
    cli      — stylize, serve, eval, export, train, make_teacher and
               normalize_vgg entry points

Entry points run on the GPU unless the caller passes ``device="cpu"``: a CPU
tensor takes each kernel's plain PyTorch version, a CUDA tensor launches the
kernel or raises. Where autograd records, the kernels run under
``torch.autograd.Function``s whose backward is plain PyTorch.
"""

import torch

# The reference takes its statistics and WCT products in full float32
# (lax.Precision.HIGHEST). TF32 keeps about three decimal digits, which the
# eigendecomposition of a covariance over millions of pixels cannot afford,
# so both matmul and cuDNN (the plain conv yardstick) are held to float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
