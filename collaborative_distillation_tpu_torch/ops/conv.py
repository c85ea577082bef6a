"""Core image-network ops, NHWC activations and HWIO weights, float32 or
bfloat16 (the bf16 engine: f32 sums, one rounding a conv).

Each op that the reference ran through a Pallas kernel dispatches on the
device of its input: a CPU tensor takes the kernel's plain PyTorch version, a
CUDA tensor launches the hand-written kernel (``ops/cuda``), which raises on
what it does not take. Nothing falls back from the card to the plain path.

Where autograd is recording and an input requires grad, the op goes through
its ``torch.autograd.Function`` (``ops/cuda/autograd.py``), whose forward is
the same kernel or plain version and whose backward has JAX's subgradients;
otherwise it takes the launch as it is, so inference counts and computes
exactly what it did.

:func:`conv3x3_pool` and :func:`conv3x3_upsampled` are a conv with the 2x2
max pool after it or the nearest 2x upsample before it, in one launch on the
card (``ops/cuda/fused.py``) and as the two plain versions on the CPU, bit
for bit what the two ops give. Inference only. :func:`fuses` is the route
rule the model functions apply before taking them: the map on a device of
``FUSE_DEVICES``, autograd not recording, and a fused instantiation in the
conv's launch plan; nothing falls back from a fused launch to the two ops.

The three 3x3 entries open a span each (:func:`..utils.profiling.span`):
``cd.conv3x3`` (halo rows or not), ``cd.conv3x3_pool`` and ``cd.conv3x3_up``,
on every device and under autograd (the forward only: the backward runs on
autograd's own thread, in its own ranges).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.profiling import span
from .cuda import autograd as _grad
from .cuda import conv as _kconv
from .cuda import fused as _kfused
from .cuda import pool as _kpool
from .pad import reflect_pad
from .precision import bf16_full_reduction

__all__ = ["reflect_pad", "conv2d", "conv3x3", "conv1x1", "max_pool_2x2",
           "max_pool_2x2_with_argmax", "max_unpool_2x2", "upsample_nearest_2x", "on_card",
           "conv3x3_pool", "conv3x3_upsampled", "fuses", "FUSE_DEVICES"]

# The device types whose maps take the fused conv + pool and upsample + conv
# launches (:func:`fuses`). Empty: the separate kernels everywhere, the
# baseline a measurement of the fused route runs beside it.
FUSE_DEVICES = frozenset({"cuda"})


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """VALID conv, NHWC x HWIO -> NHWC, float32."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b)
    return y.permute(0, 2, 3, 1).contiguous()


def on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU one (plain version);
    any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {x.device}")


def _records_grad(*tensors) -> bool:
    """True where autograd records and one of ``tensors`` requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
            relu: bool = True, top: torch.Tensor | None = None,
            bot: torch.Tensor | None = None) -> torch.Tensor:
    """Reflect-pad(1) + 3x3 VALID conv (+ optional ReLU): the reference's
    universal conv block (model_original.py:494 ``relu(conv(pad(x)))``).

    ``top``, ``bot``: the (N, 1, W, Cin) rows above and below a row shard
    (the per-conv sharded path's halos; ``None`` for the shard's own
    reflection row). Inference only: refused while autograd records."""
    halo = top is not None or bot is not None
    with span("cd.conv3x3"):
        if _records_grad(x, w, b, top, bot):
            if halo:
                raise ValueError("conv3x3: halo rows are inference only (the per-conv sharded "
                                 "path); autograd is recording and an input requires grad")
            fwd = _kconv.conv3x3_reflect if on_card(x) else _kconv.conv3x3_plain
            return _grad.Conv3x3.apply(x, w, b, relu, fwd)
        conv = _kconv.conv3x3_reflect if on_card(x) else _kconv.conv3x3_plain
        return conv(x, w, b, relu, top=top, bot=bot) if halo else conv(x, w, b, relu)


def conv1x1(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
            relu: bool = False) -> torch.Tensor:
    """1x1 conv as one product over the pixels (``conv0`` and the aux
    adapters; the reference leaves these to XLA outside any Pallas kernel).
    In bfloat16 as the reference's XLA conv: the product summed in float32
    and rounded to bf16 (cuBLAS held to a float32 reduction), then + b in
    bf16."""
    w = w.reshape(w.shape[-2], w.shape[-1])
    if x.dtype == torch.bfloat16:
        with bf16_full_reduction():
            y = x @ w
    else:
        y = x @ w
    if b is not None:
        y = y + b
    if not relu:
        return y
    return _grad.JaxRelu.apply(y) if _records_grad(y) else torch.relu(y)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool, floor semantics (nn.MaxPool2d(2, 2))."""
    if _records_grad(x):
        fwd = _kpool.max_pool_2x2 if on_card(x) else _kpool.max_pool_2x2_plain
        return _grad.MaxPool2x2.apply(x, fwd)
    if on_card(x):
        return _kpool.max_pool_2x2(x)
    return _kpool.max_pool_2x2_plain(x)


def max_pool_2x2_with_argmax(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """2x2/stride-2 max pool that also returns each window's argmax, int32
    ``dy * 2 + dx`` (ties to the first maximum, as ``jnp.argmax``); an odd
    last row or column is dropped. The photo-WCT encoder's pool
    (model_cd.py:443-449). The reference leaves it to XLA, not a Pallas
    kernel: plain torch on both devices, its maxima the ``max_pool_2x2``
    kernel's bit for bit (a maximum is exact)."""
    n, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    win = (x[:, :2 * h2, :2 * w2].reshape(n, h2, 2, w2, 2, c)
           .permute(0, 1, 3, 2, 4, 5).reshape(n, h2, w2, 4, c))
    return win.amax(dim=3), win.argmax(dim=3).to(torch.int32)


def max_unpool_2x2(x: torch.Tensor, idx: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Inverse of :func:`max_pool_2x2_with_argmax`: each pooled value back
    at its argmax position, zeros elsewhere (torch ``MaxUnpool2d(2, 2)``),
    zero-padded to ``out_hw``. A one-hot product, as the reference's."""
    n, h2, w2, c = x.shape
    onehot = idx.unsqueeze(3) == torch.arange(4, device=idx.device).view(4, 1)
    y = (onehot.to(x.dtype) * x.unsqueeze(3)).reshape(n, h2, w2, 2, 2, c)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h2, 2 * w2, c)
    oh, ow = out_hw
    if (oh, ow) != (2 * h2, 2 * w2):
        y = F.pad(y, (0, 0, 0, ow - 2 * w2, 0, oh - 2 * h2))
    return y


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (nn.UpsamplingNearest2d(scale_factor=2))."""
    if _records_grad(x):
        fwd = _kpool.upsample_nearest_2x if on_card(x) else _kpool.upsample_nearest_2x_plain
        return _grad.UpsampleNearest2x.apply(x, fwd)
    if on_card(x):
        return _kpool.upsample_nearest_2x(x)
    return _kpool.upsample_nearest_2x_plain(x)


def fuses(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> bool:
    """Whether a conv of ``x`` by ``w`` (HWIO) may take its pool or upsample
    into its own launch (:func:`conv3x3_pool`, :func:`conv3x3_upsampled`;
    ``x`` the map the conv reads or its half-resolution source): ``x`` lies
    on a device of ``FUSE_DEVICES``, autograd is not recording (training's
    backward needs the full-resolution map), and the conv's launch plan has
    a fused instantiation for (Cin, Cout) in ``x``'s dtype. A rule of shape,
    device and flags, fixed before any launch."""
    return (x.device.type in FUSE_DEVICES and not _records_grad(x, w, b)
            and _kconv.has_fused(w.shape[2], w.shape[3], x.dtype))


def _inference_only(name: str, *tensors) -> None:
    if _records_grad(*tensors):
        raise ValueError(f"{name}: inference only; autograd is recording and an input "
                         f"requires grad (take the separate ops)")


def conv3x3_pool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
                 relu: bool = True) -> torch.Tensor:
    """:func:`conv3x3` then :func:`max_pool_2x2` (floor), one launch on the
    card: only the pooled map is written. Inference only."""
    _inference_only("conv3x3_pool", x, w, b)
    with span("cd.conv3x3_pool"):
        return (_kfused.conv3x3_pool if on_card(x) else _kfused.conv3x3_pool_plain)(x, w, b, relu)


def conv3x3_upsampled(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
                      relu: bool = True) -> torch.Tensor:
    """:func:`conv3x3` of :func:`upsample_nearest_2x` of ``x``, one launch on
    the card: the conv stages its tile from ``x`` itself, and the upsampled
    map is never written. Inference only."""
    _inference_only("conv3x3_upsampled", x, w, b)
    with span("cd.conv3x3_up"):
        return (_kfused.conv3x3_up if on_card(x) else _kfused.conv3x3_up_plain)(x, w, b, relu)
