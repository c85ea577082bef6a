"""The frozen work counts against hand counts, and against the program's
own count where the two count the same thing."""

import json
import os

import pytest

from conftest import BENCH_DIR

from benchlib import arch, counts


def _cfg(name):
    return json.load(open(os.path.join(BENCH_DIR, "configs", name + ".json")))


def test_one_conv_by_hand():
    l = arch.Layer("conv21", 16, 32)
    # 8 x 12 outputs, each 32 channels of 9 x 16 MACs (2 FLOPs) plus bias and ReLU
    assert counts.conv_flops(8, 12, l) == 8 * 12 * 32 * (2 * 9 * 16 + 2)


def test_one_wct_by_hand():
    # covariance: c x c sums of products over p pixels; eigh and rebuild 25 c^3
    assert counts.stats_flops(4, 10) == 2 * 4 * 4 * 10 + 25 * 4 ** 3


def test_conv3x3_least_time_by_hand():
    cfg = {"stages": [1], "widths": {"conv11": 8}, "stage_widths": {}}
    # stage 1: encoder conv11 (3 -> 8) on content and style, decoder conv11 (8 -> 3)
    t = counts.conv3x3_least_s(cfg, (16, 16), (16, 16), 1e9, 1e9)
    enc = max(256 * 2 * 9 * 3 * 8, 4 * (256 * 3 + 256 * 8 + 9 * 3 * 8 + 8))
    dec = max(256 * 2 * 9 * 8 * 3, 4 * (256 * 8 + 256 * 3 + 9 * 8 * 3 + 3))
    assert t == pytest.approx((2 * enc + dec) / 1e9)


def test_fused_pool_and_upsample_count_as_bytes():
    cfg = {"stages": [2], "widths": {"conv11": 4, "conv12": 4, "conv21": 8},
           "stage_widths": {}}
    slow = 1.0  # bytes/s so slow that every conv is bound by its bytes
    t = counts.conv3x3_least_s(cfg, (16, 16), (16, 16), 1e30, slow)
    px, half = 256, 64
    enc = (4 * (px * 3 + px * 4 + 9 * 3 * 4 + 4) + 4 * (px * 4 + half * 4 + 9 * 4 * 4 + 4)
           + 4 * (half * 4 + half * 8 + 9 * 4 * 8 + 8))
    dec = (4 * (half * 8 + half * 4 + 9 * 8 * 4 + 4) + 4 * (half * 4 + px * 4 + 9 * 4 * 4 + 4)
           + 4 * (px * 4 + px * 3 + 9 * 4 * 3 + 3))
    assert t == pytest.approx(2 * enc + dec)


@pytest.mark.parametrize("name", ["cd16x", "vgg19"])
def test_content_leg_matches_the_programs_count(name):
    from collaborative_distillation_tpu_torch.utils import flops
    cfg = _cfg(name)
    # the program's count leaves the style leg out; a 16 x 16 style is ~nothing of it
    ours = counts.cascade_flops(cfg, (512, 768), (16, 16))
    style = sum(counts.net_flops(arch.encoder(cfg, k), 16, 16, conv0=True)
                + counts.stats_flops(arch.encoder(cfg, k)[-1].cout, (16 >> (k - 1)) ** 2)
                for k in cfg["stages"])
    theirs = flops.cascade_flops(cfg["family"], 512, 768)
    assert ours - style == pytest.approx(theirs, rel=1e-12)


def test_layer_tables_match_the_programs_specs():
    from collaborative_distillation_tpu_torch.models.specs import decoder_spec, encoder_spec
    for name in ("cd16x", "vgg19"):
        cfg = _cfg(name)
        for k in range(1, 6):
            spec = encoder_spec(cfg["family"], k, aux=name == "cd16x")
            assert [(l.name, l.cin, l.cout, l.pool) for l in arch.encoder(cfg, k)] == \
                [(l.name, l.in_ch, l.out_ch, l.pool_after) for l in spec.layers]
            dspec = decoder_spec(cfg["family"], k)
            assert [(l.name, l.cin, l.cout, l.up) for l in arch.decoder(cfg, k)] == \
                [(l.name, l.in_ch, l.out_ch, l.unpool_after) for l in dspec.layers]
            if name == "cd16x":
                assert [(a.name, a.cin, a.cout) for a in arch.aux(cfg, k)] == \
                    [(a.name, a.in_ch, a.out_ch) for a in spec.aux]


def test_training_step_count():
    s, t = _cfg("cd16x"), _cfg("vgg19")
    se = counts.net_flops(arch.encoder(s, 5), 256, 256, conv0=True, aux=arch.aux(s, 5))
    be = counts.net_flops(arch.encoder(t, 5), 256, 256, conv0=True)
    bd = counts.net_flops(arch.decoder(t, 5), 16, 16)
    assert counts.wct_se_flops(s, t, 5, 16, 256) == 16 * (3 * se + 3 * be + 2 * bd)
