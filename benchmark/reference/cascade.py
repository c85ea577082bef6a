"""The WCT cascade, plain (util_wct.py, WCT.py of the reference).

For each stage k in the configuration's order: encode the style and take
the mean and covariance of its relu{k}_1 map, encode the image, whiten it
by its own covariance and colour it by the style's (eigendecomposition of
cov + eps I; eigenvalues at or below truncate x the largest are dropped),
add the style's mean, blend by alpha, decode. The image is reflect-padded
at the bottom and right to a multiple of 16 first, cropped and clipped to
[0, 1] last. A 3x3 conv is reflect-pad(1), conv, bias, ReLU; pools are 2x2
max, upsamples nearest 2x. ``precision`` other than the default rounds
every conv's and product's operands to it (``precision.py``): the control.

The statistics are float32, as the configuration states, but their sums
are accumulated in float64 and rounded once: a covariance summed by one
float32 GEMM over a map of up to 42 million pixels moved the UHD output by
7e-5 to 5e-4 rms on the card, while the program's own output (its
``sum_gram`` sums row blocks with a shift, then a tree) lies ~1e-5 from
the float64 one. The eigendecomposition, roots and coloring matrix are
float32: where a covariance has eigenvalues near float32's resolution
(the seeded VGG-19's deep stages), float64 keeps and inverts some that
float32 cannot resolve, and moved the output by up to 9e-3 rms."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchlib import arch

from . import precision as lower


def _mm(a, b, precision):
    return lower.operand(a, precision) @ lower.operand(b, precision)


def conv(x, p, layer: arch.Layer | None, precision: str, *, relu: bool | None = None):
    """``x`` NCHW; ``p`` {"w": HWIO, "b"}; a 1x1 when ``layer`` is None or
    has kernel 1."""
    w = p["w"].permute(3, 2, 0, 1)
    if layer is not None and layer.kernel == 3:
        x = F.pad(x, (1, 1, 1, 1), mode="reflect")
    y = lower.grad(F.conv2d(lower.operand(x, precision), lower.operand(w, precision), p["b"]),
                   precision)
    on = layer.relu if relu is None else relu
    if on and layer is not None:
        return y.relu_() if not torch.is_grad_enabled() else F.relu(y)
    return y


def encode(params, x, cfg, stage, precision, *, aux_layers=(), with_taps=True):
    """(out, taps): the relu{stage}_1 map and every relu{j}_1 tap (and each
    adapter ``aux{j}1`` of ``aux_layers`` on its tap); ``with_taps=False``
    keeps none."""
    x = conv(x, params["conv0"], None, precision, relu=False)
    taps: dict = {}
    for l in arch.encoder(cfg, stage):
        x = conv(x, params[l.name], l, precision)
        if l.tap and with_taps:
            taps[f"relu{l.name[4]}1"] = x
        if l.pool:
            x = F.max_pool2d(x, 2)
    for a in aux_layers:
        taps[f"aux{a.name[4]}1"] = conv(taps[f"relu{a.name[4]}1"], params[a.name], a, precision)
    return x, taps


def decode(params, x, cfg, stage, precision):
    for l in arch.decoder(cfg, stage):
        x = conv(x, params[l.name], l, precision)
        if l.up:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
    return x


def stats(f, precision):
    """Mean (C,) and covariance (C, C), /(P-1), of an NCHW map of one image:
    summed in float64, returned float32 (in the control: the covariance's
    products on operands in its precision, summed in float32)."""
    c = f.shape[1]
    x = f[0].reshape(c, -1).double()
    mean = x.mean(1)
    xc = x - mean[:, None]
    cov = _mm(xc, xc.T, precision).double() / (x.shape[1] - 1)
    return mean.float(), cov.float()


def _roots(cov, eps, truncate):
    c = cov.shape[0]
    lam, v = torch.linalg.eigh(cov + eps * torch.eye(c, dtype=cov.dtype, device=cov.device))
    keep = lam > truncate * torch.clamp(lam[-1], min=eps)
    lam = torch.clamp(lam, min=1e-30)
    inv = torch.where(keep, lam.rsqrt(), torch.zeros_like(lam))
    sq = torch.where(keep, lam.sqrt(), torch.zeros_like(lam))
    return (v * inv) @ v.T, (v * sq) @ v.T


def wct(f, s_mean, s_cov, alpha, cfg, precision):
    c = f.shape[1]
    wcfg = cfg["wct"]
    c_mean, c_cov = stats(f, precision)
    c_isqrt, _ = _roots(c_cov, wcfg["eps"], wcfg["truncate"])
    _, s_sqrt = _roots(s_cov, wcfg["eps"], wcfg["truncate"])
    t = _mm(s_sqrt, c_isqrt, precision)
    x = f[0].reshape(c, -1)
    out = _mm(t, x - c_mean[:, None], precision) + s_mean[:, None]
    out = alpha * out + (1.0 - alpha) * x
    return out.reshape(f.shape)


def pad16(x):
    """NCHW reflect-padded at the bottom and right to multiples of 16."""
    h, w = x.shape[2:]
    ph, pw = (-h) % 16, (-w) % 16
    return F.pad(x, (0, pw, 0, ph), mode="reflect") if ph or pw else x


@torch.no_grad()
def stylize(pyramid, content, style, cfg, *, alpha=1.0, precision="float32"):
    """``content``, ``style``: (H, W, 3) float in [0, 1]; returns (H, W, 3)."""
    h, w = content.shape[:2]
    img = pad16(content.permute(2, 0, 1)[None].float())
    sty = pad16(style.permute(2, 0, 1)[None].float())
    for k in cfg["stages"]:
        p = pyramid[k]
        s_feat, _ = encode(p["enc"], sty, cfg, k, precision, with_taps=False)
        s_mean, s_cov = stats(s_feat, precision)
        del s_feat
        feat, _ = encode(p["enc"], img, cfg, k, precision, with_taps=False)
        del img
        feat = wct(feat, s_mean, s_cov, alpha, cfg, precision)
        img = decode(p["dec"], feat, cfg, k, precision)
        del feat
    return img[0, :, :h, :w].permute(1, 2, 0).clamp_(0.0, 1.0)
