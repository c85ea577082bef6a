"""Hand-written CUDA kernels (``csrc/*.cu``, sm_90a) and their wrappers.

Each wrapper module keeps the kernel's plain PyTorch version beside it and
counts its launches in a plain integer attribute (``<wrapper>.launches``).
Nothing here builds or loads the kernels at import: the library is built at
the first launch (see :mod:`._build`). :mod:`.autograd` holds the
``torch.autograd.Function``s that carry gradients through the conv, pool and
upsample kernels.
"""

from .conv import conv3x3_reflect
from .conv1x1 import conv1x1_bias
from .halo import halo_exchange_rows
from .pool import max_pool_2x2, upsample_nearest_2x
from .stats import sum_gram

KERNELS = (conv3x3_reflect, conv1x1_bias, sum_gram, max_pool_2x2,
           upsample_nearest_2x, halo_exchange_rows)

__all__ = ["KERNELS", "conv3x3_reflect", "conv1x1_bias", "sum_gram",
           "max_pool_2x2", "upsample_nearest_2x", "halo_exchange_rows"]
