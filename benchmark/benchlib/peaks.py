"""Published peaks of the card, and its power limit as read beside them.

NVIDIA's H100 SXM5 data sheet, dense rates without sparsity, at the full
700 W: 67 TFLOP/s float32 on the CUDA cores (FFMA), 495 TF32, 989 bf16, HBM3
at 3.35 TB/s. Copied from the program's ``utils/flops.py``; keyed by the name
``torch.cuda.get_device_name`` gives."""

from __future__ import annotations

import subprocess

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
                              "bytes": 3.35e12},
}


def peaks(kind: str) -> dict | None:
    return PEAKS.get(kind)


def power_limit_w() -> float | None:
    """``nvidia-smi``'s power.limit of card 0, or None where it cannot say."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None
