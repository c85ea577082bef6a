"""Small device helpers shared by the drivers (the CPU path is for tests)."""

from __future__ import annotations

import gc


def is_cuda(device) -> bool:
    return device.type == "cuda"


def sync(torch, device) -> None:
    if is_cuda(device):
        torch.cuda.synchronize(device)


def reset_peak(torch, device) -> None:
    if is_cuda(device):
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(torch, device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if is_cuda(device) else 0


def free(torch, device) -> None:
    gc.collect()
    if is_cuda(device):
        torch.cuda.empty_cache()
