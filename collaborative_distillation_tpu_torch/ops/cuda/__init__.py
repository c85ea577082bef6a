"""Hand-written CUDA kernels (``csrc/*.cu``, sm_90a) and their wrappers.

Each wrapper module keeps the kernel's plain PyTorch version beside it and
counts its launches in a plain integer attribute (``<wrapper>.launches``).
Nothing here builds or loads the kernels at import: the library is built at
the first launch (see :mod:`._build`). :mod:`.autograd` holds the
``torch.autograd.Function``s that carry gradients through the conv, pool and
upsample kernels.

``KERNELS`` are the float32 kernels; ``BF16_KERNELS`` the bfloat16
instantiations of the conv, 1x1, pool and upsample, each with its own launch
count (the float32 wrappers hand a bf16 map to them and count nothing).
:mod:`.fused` holds the conv with its pool or upsample folded in
(``conv3x3_pool``, ``conv3x3_up`` and their bf16 entries): each counts its
own launches, none of them in ``conv3x3_reflect``'s, the pool's or the
upsample's.
:mod:`.eigh` holds ``sym_eigh``, the WCT's batched eigensolver, which
replaces no TPU kernel (the reference calls a library solver): it is in
``KERNELS`` all the same, with its own count.
``DATA_KERNELS`` are the training loader's uint8 resize of a decoded JPEG
(:mod:`.resize`), which replace no TPU kernel: their counts move while a
step runs, from the loader's threads, so they stand apart from the step's.
"""

from .conv import conv3x3_reflect, conv3x3_reflect_bf16
from .conv1x1 import conv1x1_bias, conv1x1_bias_bf16
from .eigh import sym_eigh
from .fused import conv3x3_pool, conv3x3_pool_bf16, conv3x3_up, conv3x3_up_bf16
from .halo import halo_exchange_rows, halo_exchange_rows_many, halo_fill_rows
from .pool import max_pool_2x2, max_pool_2x2_bf16, upsample_nearest_2x, upsample_nearest_2x_bf16
from .resize import box_resize_u8, scale_reduce_u8
from .stats import sum_gram

KERNELS = (conv3x3_reflect, conv1x1_bias, sum_gram, max_pool_2x2,
           upsample_nearest_2x, halo_exchange_rows, halo_fill_rows, conv3x3_pool, conv3x3_up,
           sym_eigh)
BF16_KERNELS = (conv3x3_reflect_bf16, conv1x1_bias_bf16, max_pool_2x2_bf16,
                upsample_nearest_2x_bf16, conv3x3_pool_bf16, conv3x3_up_bf16)
DATA_KERNELS = (scale_reduce_u8, box_resize_u8)

__all__ = ["KERNELS", "BF16_KERNELS", "DATA_KERNELS", "conv3x3_reflect", "conv1x1_bias",
           "sum_gram", "max_pool_2x2", "upsample_nearest_2x", "halo_exchange_rows",
           "halo_exchange_rows_many", "halo_fill_rows",
           "conv3x3_reflect_bf16", "conv1x1_bias_bf16", "max_pool_2x2_bf16",
           "upsample_nearest_2x_bf16", "scale_reduce_u8", "box_resize_u8", "conv3x3_pool",
           "conv3x3_up", "conv3x3_pool_bf16", "conv3x3_up_bf16", "sym_eigh"]
