"""The bf16 ring kernel's launch plan (``ops/cuda/conv.py:launch_plan_bf16``).

Every conv3x3 and 1x1 shape of the bf16 2048^2 plain and UHD slab paths
(``chip_smoke.py``'s plans), phase 10a's edge shapes and the teachers'
widths get a template of ``BF16_TEMPLATES``, within the card's 232,448 bytes
of shared memory a block and a grid of at most the SMs given, in whole Cout
tiles; the path's shapes keep their weights resident. The table is the one
the CUDA sources instantiate, id by id. Plain Python: no card, no JAX.
"""

import os
import re

import pytest

import chip_smoke
from collaborative_distillation_tpu_torch.models.zoo import stage_specs
from collaborative_distillation_tpu_torch.ops.cuda import conv as kconv
from collaborative_distillation_tpu_torch.wct.slab import FEATURE_CACHE_BYTES, SlabCascade

N_SM = 132   # an H100 SXM's SMs
STAGES = (5, 4, 3, 2, 1)


def _bf16_path_shapes(kernel):
    """{(N, H, W, Cin, Cout)} of ``kernel`` ("conv3x3_reflect" or
    "conv1x1_bias") on the bf16 2048^2 plain and UHD slab paths: the float32
    plans' shapes, which the bf16 engine runs on its bf16 kernels (a conv
    with its pool or upsample fused in at its conv's shape)."""
    pyr = {k: dict(zip(("enc_spec", "dec_spec"), stage_specs("16x", k))) for k in STAGES}
    margins = SlabCascade(pyr, stages=STAGES, slab_rows=chip_smoke.UHD_SLAB).margins
    plans = [chip_smoke.path_calls(pyr, STAGES, 2048, 2048)[0],
             chip_smoke.slab_path_calls(pyr, STAGES, margins, chip_smoke.UHD_SLAB,
                                        chip_smoke.UHD_H, chip_smoke.UHD_W, 2048, 2048,
                                        FEATURE_CACHE_BYTES)[0]]
    kinds = chip_smoke.CONV_KERNELS if kernel == "conv3x3_reflect" else (kernel,)
    return sorted({s[:5] for calls in plans for k, s in calls if k in kinds})


PATH_3X3 = _bf16_path_shapes("conv3x3_reflect")
PATH_1X1 = _bf16_path_shapes("conv1x1_bias")
# phase 10a's edge shapes, the GPU tests' ring cases, the teachers' widths
EDGE_3X3 = [(1, 1, 1, 128, 128), (1, 17, 33, 3, 24), (2, 9, 2, 24, 3), (1, 16, 16, 512, 512),
            (1, 13, 45, 16, 16), (1, 33, 65, 64, 128), (3, 257, 255, 16, 16),
            (1, 60, 90, 64, 96), (3, 8, 16, 129, 24), (1, 16, 16, 5, 7), (2, 9, 17, 256, 512),
            (1, 17, 33, 512, 3), (1, 5, 5, 256, 129), (1, 64, 64, 256, 256),
            (16, 32, 32, 512, 256)]
EDGE_1X1 = [(1, 1, 1, 8, 8), (1, 3, 100001, 24, 24), (1, 5, 31, 128, 128), (1, 7, 13, 96, 96),
            (1, 1, 300, 3, 24), (1, 1, 300, 24, 3), (1, 1, 5000, 128, 8)]


def test_the_paths_have_both_kernels_shapes():
    assert len(PATH_3X3) == 54 and len(PATH_1X1) == 5


@pytest.mark.parametrize("shape", PATH_3X3 + EDGE_3X3, ids=str)
def test_conv3x3_plan_fits_the_card(shape):
    n, h, w, ci, co = shape
    p = kconv.launch_plan_bf16(n, h, w, ci, co, N_SM)
    name, taps, ck, nt, th, tw, *_ = kconv.BF16_TEMPLATES[p.template]
    assert (p.kernel, taps, p.tile, p.cout_tile) == (name, 9, (th, tw), nt)
    assert p.smem == kconv.bf16_smem(p.template, ci, p.resident) <= kconv.MAX_SMEM
    cout_tiles = -(-co // nt)
    assert p.grid[0] <= N_SM and p.grid[0] % cout_tiles == 0 and p.grid[1:] == (1, 1)
    assert p.tiles == n * -(-h // th) * -(-w // tw) and p.chunks == -(-ci // ck)
    assert p.grid[0] // cout_tiles <= p.tiles   # no block without a tile
    assert p.resident == (ci <= 128)
    if shape in PATH_3X3:   # the smallest staged width and Cout tile that hold the conv
        assert ck == min(32, -(-ci // 8) * 8) and nt == min(64, max(8, 1 << (co - 1).bit_length()))


@pytest.mark.parametrize("shape", PATH_1X1 + EDGE_1X1, ids=str)
def test_conv1x1_plan_fits_the_card(shape):
    n, h, w, ci, co = shape
    p = kconv.launch_plan_bf16(n, h, w, ci, co, N_SM, taps=1)
    _, taps, ck, nt, th, tw, *_ = kconv.BF16_TEMPLATES[p.template]
    assert taps == 1 and ci <= ck and co <= nt and p.resident and p.chunks == 1
    assert p.smem == kconv.bf16_smem(p.template, ci, True) <= kconv.MAX_SMEM
    assert p.tiles == -(-(n * h * w) // (th * tw)) and p.grid == (min(p.tiles, N_SM), 1, 1)


def test_small_cards_and_batches_still_get_whole_cout_tiles():
    for n_sm in (1, 2, 3, 7):
        p = kconv.launch_plan_bf16(1, 40, 40, 256, 512, n_sm)
        assert p.grid[0] == 8 and not p.resident   # eight Cout tiles, one block each
        p = kconv.launch_plan_bf16(1, 40, 40, 16, 16, n_sm)
        assert p.grid[0] == min(n_sm, p.tiles)


def test_bf16_templates_match_the_cuda_sources():
    """The plan's table is the one csrc/conv3x3_bf16.cu and csrc/conv1x1.cu
    instantiate, by id: TAPS, CK, NT, TH, TW, S, WARPS, WG."""
    csrc = os.path.join(os.path.dirname(kconv.__file__), "csrc")
    found = {}
    for src, launcher in (("conv3x3_bf16.cu", "run"), ("conv1x1.cu", "run_point")):
        text = open(os.path.join(csrc, src)).read()
        params = {name: tuple(int(v) for v in args.split(",")) for name, args in
                  re.findall(r"using (\w+) = (?:cd_bf16::)?Ring<([^>]*)>;", text)}
        for tid, name in re.findall(rf"case (\d+): return {launcher}<(\w+)>", text):
            found[int(tid)] = params[name]
    assert found == {t: v[1:] for t, v in kconv.BF16_TEMPLATES.items()}
