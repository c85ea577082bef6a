"""The frozen work counts: FLOPs and bytes that a cascade or a training step
needs, from a configuration's layer tables and the cell's shapes.

Copied from the program's ``utils/flops.py`` (1 MAC = 2 FLOPs; bias add and
ReLU counted once per output; pools, upsamples and pads are bytes) and
extended: the style leg (its encodes and statistics, which a call without a
style key pays), the bytes of each 3x3 conv, and the ``wct_se`` training
step. Only the work the result needs is counted: the slab path's margin
rows, which it computes twice, count once, so less recompute shows as a gain."""

from __future__ import annotations

from . import arch

F32 = 4  # bytes an element


def pad16(hw) -> tuple[int, int]:
    return -(-hw[0] // 16) * 16, -(-hw[1] // 16) * 16


def conv_flops(h: int, w: int, l: arch.Layer) -> float:
    return float(h) * w * (2 * l.kernel * l.kernel * l.cin + 2) * l.cout


def net_flops(layers, h: int, w: int, *, conv0: bool = False, aux=()) -> float:
    """One encoder or decoder (and the adapters ``aux`` on its taps) on an
    (h, w) map: an encoder halves after each pool, a decoder doubles after
    each upsample."""
    total = float(h) * w * (2 * 3 + 2) * 3 if conv0 else 0.0
    for l in layers:
        total += conv_flops(h, w, l)
        for a in aux:
            if a.name == l.name + "_aux":
                total += conv_flops(h, w, a)
        if l.pool:
            h, w = h // 2, w // 2
        if l.up:
            h, w = h * 2, w * 2
    return total


def stats_flops(c: int, p: int) -> float:
    """A map's covariance (c x c over p pixels) and its eigendecomposition
    with the two c x c rebuild products (~25 c^3)."""
    return 2.0 * c * c * p + 25.0 * c ** 3


def cascade_flops(cfg: dict, content_hw, style_hw) -> float:
    """The whole cascade on one pair, stages in the configuration's order:
    each stage encodes the full-resolution image again, whitens and colours
    it (statistics, eigendecomposition, one c x c apply) and decodes; the
    style leg encodes the style at every stage and takes its statistics."""
    h, w = pad16(content_hw)
    sh, sw = pad16(style_hw)
    total = 0.0
    for k in cfg["stages"]:
        enc, dec = arch.encoder(cfg, k), arch.decoder(cfg, k)
        c = enc[-1].cout
        p = (h >> (k - 1)) * (w >> (k - 1))
        total += net_flops(enc, h, w, conv0=True) + net_flops(dec, h >> (k - 1), w >> (k - 1))
        total += stats_flops(c, p) + 2.0 * c * c * p
        total += net_flops(enc, sh, sw, conv0=True)
        total += stats_flops(c, (sh >> (k - 1)) * (sw >> (k - 1)))
    return total


def conv3x3_least_s(cfg: dict, content_hw, style_hw, peak_flops: float,
                    peak_bytes: float) -> float:
    """The least time of the cascade's 3x3 convs (content and style legs):
    per conv max(ops / peak FLOP/s, bytes / peak bytes/s), its input, output
    and weights each counted once. A pool after a conv counts as that conv
    writing the pooled map, an upsample before one as it reading the
    half-resolution map (the fused launches)."""
    h, w = pad16(content_hw)
    sh, sw = pad16(style_hw)

    def net(layers, h, w):
        t, up_in = 0.0, False
        for l in layers:
            ops = float(h) * w * 2 * 9 * l.cin * l.cout
            src = (h // 2) * (w // 2) if up_in else h * w
            dst = (h // 2) * (w // 2) if l.pool else h * w
            nbytes = F32 * (src * l.cin + dst * l.cout + 9 * l.cin * l.cout + l.cout)
            t += max(ops / peak_flops, nbytes / peak_bytes)
            if l.pool:
                h, w = h // 2, w // 2
            up_in = l.up
            if l.up:
                h, w = h * 2, w * 2
        return t

    total = 0.0
    for k in cfg["stages"]:
        enc, dec = arch.encoder(cfg, k), arch.decoder(cfg, k)
        total += net(enc, h, w) + net(dec, h >> (k - 1), w >> (k - 1)) + net(enc, sh, sw)
    return total


def wct_se_flops(student_cfg: dict, teacher_cfg: dict, stage: int, n: int, crop: int) -> float:
    """One ``wct_se`` step (train/losses.py: se_distill_losses) on n crops:
    forward, the student encoder with its adapters (SE), the teacher decoder
    on its last adapter (BD), the teacher encoder on the batch and on the
    reconstruction (BE twice); backward, twice SE's forward (data and weight
    gradients) and once each frozen network a gradient passes through (BE on
    the reconstruction, BD)."""
    se = net_flops(arch.encoder(student_cfg, stage), crop, crop, conv0=True,
                   aux=arch.aux(student_cfg, stage))
    be = net_flops(arch.encoder(teacher_cfg, stage), crop, crop, conv0=True)
    side = crop >> (stage - 1)
    bd = net_flops(arch.decoder(teacher_cfg, stage), side, side)
    return n * (se + bd + 2 * be + 2 * se + be + bd)
