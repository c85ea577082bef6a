"""2x2 max pool and nearest 2x upsample: the kernels and their plain versions.

``csrc/pool.cu`` replaces the reference's Pallas ``packed_pool_lane`` (its
unpacked ``f == 1`` branch) and ``packed_upsample_lane``.
"""

from __future__ import annotations

import torch

from . import _build
from .conv import _check_cuda

__all__ = ["max_pool_2x2_plain", "upsample_nearest_2x_plain", "max_pool_2x2",
           "upsample_nearest_2x"]


def max_pool_2x2_plain(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool of an NHWC map, floor semantics (odd trailing
    rows and columns dropped, as nn.MaxPool2d(2, 2))."""
    n, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def upsample_nearest_2x_plain(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NHWC map."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _launch(wrapper, fn: str, x: torch.Tensor, out_shape) -> torch.Tensor:
    name = wrapper.__name__
    if x.dim() != 4:
        raise ValueError(f"{name}: needs NHWC, got {tuple(x.shape)}")
    _check_cuda(name, x)
    y = torch.empty(out_shape, device=x.device, dtype=torch.float32)
    if y.numel() == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = getattr(lib, fn)(x.data_ptr(), y.data_ptr(), *x.shape,
                               torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    wrapper.launches += 1
    return y


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """Launch the pool kernel on a contiguous float32 NHWC CUDA map."""
    n, h, w, c = x.shape
    return _launch(max_pool_2x2, "cd_max_pool_2x2", x, (n, h // 2, w // 2, c))


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Launch the upsample kernel on a contiguous float32 NHWC CUDA map."""
    n, h, w, c = x.shape
    return _launch(upsample_nearest_2x, "cd_upsample_nearest_2x", x,
                   (n, 2 * h, 2 * w, c))


max_pool_2x2.launches = 0
max_pool_2x2.plain = max_pool_2x2_plain
upsample_nearest_2x.launches = 0
upsample_nearest_2x.plain = upsample_nearest_2x_plain
