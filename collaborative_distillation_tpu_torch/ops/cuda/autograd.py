"""Gradients through the hand-written kernels.

One ``torch.autograd.Function`` each for ``conv3x3_reflect``, ``max_pool_2x2``
and ``upsample_nearest_2x``, and one for the ReLU the training graph applies
outside a conv (the aux adapters). The caller passes the forward to run: the
kernel for a CUDA tensor, the plain version for a CPU one, so both devices
take the same backward. The backward is plain PyTorch: the reference trains
through XLA's transposes of the same ops, because a Pallas kernel has no
autodiff rule, so it has no backward kernel to port.

The subgradients are JAX's, on both devices:

* ReLU at exactly 0 passes half the gradient, as ``jax.grad`` of
  ``jnp.maximum(y, 0)`` does (``torch.relu`` passes none). A conv with a
  ReLU runs its kernel without it, then saves what tells a pre-activation of
  0 from one below it: a boolean map, a quarter of the pre-activation's bytes.
* A 2x2 max pool gives each window's gradient to its first maximum in
  row-major order, as the transpose of ``lax.reduce_window`` and the indices
  of ``F.max_pool2d`` do (the plain ``amax`` would split it between ties).
"""

from __future__ import annotations

import torch
from torch.nn.grad import conv2d_input, conv2d_weight

from ..pad import reflect_index, reflect_pad

__all__ = ["Conv3x3", "MaxPool2x2", "UpsampleNearest2x", "JaxRelu"]


def _relu_grad(g: torch.Tensor, y: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """``g`` through ``jnp.maximum(pre, 0)``: 1 above 0, 0.5 at 0, 0 below."""
    return g * torch.where(y > 0, 1.0, torch.where(zero, 0.5, 0.0))


class JaxRelu(torch.autograd.Function):
    """``max(x, 0)`` with JAX's gradient (0.5 at exactly 0)."""

    @staticmethod
    def forward(ctx, x):
        zero = x == 0
        y = x.clamp_min(0)
        ctx.save_for_backward(y, zero)
        return y

    @staticmethod
    def backward(ctx, g):
        y, zero = ctx.saved_tensors
        return _relu_grad(g, y, zero)


def _fold_reflect(gp: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The gradient of an NHWC map from that of its reflect-pad(1): each
    padded row and column adds onto the row or column it copies."""
    n, _, _, c = gp.shape
    rows = gp.new_zeros(n, h, w + 2, c).index_add_(1, reflect_index(h, 1, 1, gp.device), gp)
    return gp.new_zeros(n, h, w, c).index_add_(2, reflect_index(w, 1, 1, gp.device), rows)


class Conv3x3(torch.autograd.Function):
    """Reflect-pad(1) + 3x3 VALID conv + bias (+ ReLU), NHWC x HWIO.

    ``conv(x, w, b, relu)`` is the forward (the kernel or its plain
    version); it runs with ``relu=False`` and the ReLU is applied here in
    place, so the backward sees JAX's tie. The backward is cuDNN's (or the
    CPU's) data and weight gradients of the VALID conv on the padded input,
    the pad's gradient folded back onto the border, and a sum for the bias.
    Only the gradients an input needs are computed: a frozen teacher's
    weights get none.
    """

    @staticmethod
    def forward(ctx, x, w, b, relu, conv):
        y = conv(x, w, b, False)
        if relu:
            zero = y == 0
            y = y.clamp_min_(0)   # in place: the kernel's output is ours alone
            ctx.save_for_backward(x, w, y, zero)
        else:
            ctx.save_for_backward(x, w)
        ctx.relu = relu
        return y

    @staticmethod
    def backward(ctx, g):
        if ctx.relu:
            x, w, y, zero = ctx.saved_tensors
            g = _relu_grad(g, y, zero)
        else:
            x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        n, h, wd, cin = x.shape
        cout = w.shape[3]
        gn = g.permute(0, 3, 1, 2)            # NHWC memory as an NCHW view
        gx = gw = gb = None
        if need_x:
            gp = conv2d_input((n, cin, h + 2, wd + 2), w.permute(3, 2, 0, 1), gn)
            gx = _fold_reflect(gp.permute(0, 2, 3, 1), h, wd)
        if need_w:
            xp = reflect_pad(x, 1).permute(0, 3, 1, 2)
            gw = conv2d_weight(xp, (cout, cin, 3, 3), gn).permute(2, 3, 1, 0).contiguous()
        if need_b:
            gb = g.sum(dim=(0, 1, 2))
        return gx, gw, gb, None, None


class MaxPool2x2(torch.autograd.Function):
    """2x2/stride-2 max pool, floor semantics; ``pool(x)`` is the forward.
    The backward gives each window's gradient to its first maximum in
    row-major order; the dropped odd row and column get none."""

    @staticmethod
    def forward(ctx, x, pool):
        y = pool(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        n, h, w, c = x.shape
        h2, w2 = h // 2, w // 2
        xw = x[:, :2 * h2, :2 * w2].reshape(n, h2, 2, w2, 2, c)
        gw = torch.zeros_like(xw)
        taken = torch.zeros_like(y, dtype=torch.bool)
        for dy in (0, 1):
            for dx in (0, 1):
                hit = (xw[:, :, dy, :, dx] == y) & ~taken
                gw[:, :, dy, :, dx] = torch.where(hit, g, 0.0)
                taken |= hit
        gw = gw.reshape(n, 2 * h2, 2 * w2, c)
        if (2 * h2, 2 * w2) == (h, w):
            return gw, None
        gx = x.new_zeros(x.shape)
        gx[:, :2 * h2, :2 * w2] = gw
        return gx, None


class UpsampleNearest2x(torch.autograd.Function):
    """Nearest 2x upsample; ``up(x)`` is the forward. The backward sums each
    2x2 block of the gradient."""

    @staticmethod
    def forward(ctx, x, up):
        return up(x)

    @staticmethod
    def backward(ctx, g):
        n, h2, w2, c = g.shape
        return g.reshape(n, h2 // 2, 2, w2 // 2, 2, c).sum(dim=(2, 4)), None
