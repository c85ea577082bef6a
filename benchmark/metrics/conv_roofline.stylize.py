"""The cascade's 3x3 convs' share of their roofline, %: the least time the
card could take for the convs the result needs (benchlib/counts.py:
conv3x3_least_s, max(ops / peak FLOP/s, bytes / peak bytes/s) per conv,
fused pools and upsamples as bytes) over the device time of the kernels
named below. A kernel renamed in the program drops out of the
denominator: the names are this file's, and a rename is a matter for a
benchmark change."""

# the profiler's names of the program's 3x3 conv kernels: ops/cuda/csrc/
# conv3x3.cu (ring_conv3x3_kernel, first_conv3x3_kernel) and the bf16 ring
# kernel's 3x3 instantiations (bf16_igemm.cuh: bf16_ring_kernel<Ring<9, ...>>)
NAMES = ("conv3x3_kernel",)
BF16_NAMES = (("bf16_ring_kernel", "Ring<9,"),)


def _is_conv3x3(name: str) -> bool:
    flat = name.replace(" ", "")
    return any(n in name for n in NAMES) or any(a in flat and b in flat for a, b in BF16_NAMES)


def read(r: dict):
    tr, pk = r.get("trace"), r.get("peaks")
    if not tr or not pk or tr["items"] <= 0:
        return None
    conv_s = sum(s for name, s in tr["kernels_s"].items() if _is_conv3x3(name))
    if conv_s <= 0:
        return None
    least = r["work"]["conv3x3"](pk[r["work"]["dtype"]], pk["bytes"])
    return 100.0 * least * tr["items"] / conv_s
