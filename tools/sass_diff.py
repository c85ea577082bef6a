#!/usr/bin/env python3
"""Compare the SASS of one CUDA source of the port between two checkouts.

Compiles ``ops/cuda/csrc/<source>`` of each checkout to a cubin with the
flags of ``ops/cuda/_build.py``, dumps it with ``cuobjdump -sass``, and
compares the kernels function by function: a kernel whose instructions are
the same in both prints ``same``, one that differs ``DIFFERENT``, and kernels
of one checkout only are listed as new or gone. Kernel names are demangled,
and a flag at its default ``false`` is read as absent, so that a template
instantiated before the flag existed matches its successor: a float32
``Ring<...>`` argument list that ends in the Cout walk's (``WALK``), a
``bf16_ring_kernel<Ring<...>, false>`` (no halo rows, ``HALO``), and the
fused pool and upsample flags after ``HALO`` in both ring kernels
(``..., HALO, false, false>``, ``POOL`` and ``UP``). The instantiations
with a flag set (``..., true>``) are listed as new.

    python3 tools/sass_diff.py OTHER_CHECKOUT [--source conv3x3.cu]

Exits 1 if a kernel of both checkouts differs. Needs nvcc and cuobjdump (the
CUDA toolkit); c++filt or cu++filt demangles.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join("collaborative_distillation_tpu_torch", "ops", "cuda", "csrc")


def _tool(name: str) -> str:
    found = shutil.which(name) or os.path.join("/usr/local/cuda/bin", name)
    if not os.path.exists(found):
        raise SystemExit(f"sass_diff: {name} not found")
    return found


def sass(root: str, source: str, tmp: str) -> dict:
    """{normalized kernel name: [instructions]} of ``source`` in ``root``."""
    sys.path.insert(0, root)
    try:
        from collaborative_distillation_tpu_torch.ops.cuda import _build
        arch, flags = list(_build._ARCH), list(_build._FLAGS)
    finally:
        sys.path.pop(0)
        for m in [m for m in sys.modules if m.startswith("collaborative_distillation_tpu_torch")]:
            del sys.modules[m]
    cubin = os.path.join(tmp, os.path.basename(root.rstrip("/")) + ".cubin")
    flags = [f for i, f in enumerate(flags) if "-v" not in flags[i:i + 2]]   # no ptxas -v
    subprocess.run([_tool("nvcc"), *arch, *flags, "-cubin",
                    os.path.join(root, CSRC, source), "-o", cubin], check=True,
                   stdout=subprocess.DEVNULL)
    text = subprocess.run([_tool("cuobjdump"), "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name and "/*" in line and ";" in line:
            # the instruction without its offset comment and encoding
            funcs[name].append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line.split(";")[0]).strip())
    filt = shutil.which("c++filt") or shutil.which("cu++filt")
    names = list(funcs)
    if filt:
        out = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True,
                             check=True).stdout.splitlines()
    else:
        out = names
    return {normalize(d): funcs[n] for n, d in zip(names, out)}


def normalize(name: str) -> str:
    """A demangled kernel name with the flags that stand at their default
    ``false`` taken out (``WALK`` of the float32 ``Ring``, ``POOL`` and
    ``UP`` of both ring kernels, ``HALO`` of ``bf16_ring_kernel``), and
    ``> >`` written ``>>``."""
    name = re.sub(r"(Ring<[^<>]*?), false>", lambda m: (
        m.group(1) + ">" if m.group(1).count(",") == 6 else m.group(0)), name)
    name = re.sub(r"(_kernel<.*?Ring<[^<>]*>, (?:true|false)), false, false>", r"\1>", name)
    name = re.sub(r"(bf16_ring_kernel<.*?Ring<[^<>]*>), false>", r"\1>", name)
    return name.replace("> >", ">>")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="another checkout of the repository (e.g. the parent)")
    ap.add_argument("--source", default="conv3x3.cu")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "a"))
        os.makedirs(os.path.join(tmp, "b"))
        old = sass(os.path.abspath(args.other), args.source, os.path.join(tmp, "a"))
        new = sass(HERE, args.source, os.path.join(tmp, "b"))
    differ = 0
    for name in sorted(set(old) | set(new)):
        if name not in new:
            print(f"gone       {name}")
        elif name not in old:
            print(f"new        {name} ({len(new[name])} instructions)")
        elif old[name] == new[name]:
            print(f"same       {name} ({len(new[name])} instructions)")
        else:
            differ += 1
            print(f"DIFFERENT  {name} ({len(old[name])} -> {len(new[name])} instructions)")
            pairs = [(i, a, b) for i, (a, b) in enumerate(zip(old[name], new[name])) if a != b]
            for i, a, b in pairs[:3]:
                print(f"    {i}: {a}\n    {i}: {b}")
    print(f"sass_diff {args.source}: {differ} kernel(s) of both checkouts differ")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
