"""Plot training loss curves from experiment logs, as an SVG file.

The reference package's ``cli/plot_loss.py`` (itself the working
replacement of the reference's bit-rotted tools/plot_loss.py), without
matplotlib: it parses the ``E{epoch}S{step} name (*w): value | ...`` lines
that ``cli/train.py`` logs (the reference's LogHub format, main.py:115-119)
and draws the figure itself: one ``<polyline class="curve">`` a loss, its
moving average over ``--window`` logged steps, on axes labelled as the
reference's figure ("logged step", "loss (moving avg)"), with a legend.
Text and numbers on the host only: no tensor goes to any device.

    python -m collaborative_distillation_tpu_torch.cli.plot_loss \
        Experiments/*/weights/log_*.txt --out loss.svg
"""

from __future__ import annotations

import argparse
import math
import re
import sys
from xml.sax.saxutils import escape, quoteattr

LOSS_RE = re.compile(r"([\w]+) \(\*[\d.e+-]+\): ([\d.e+-]+)")

# the figure: 8 x 5 inches at 120 dpi, as the reference saves it, and
# matplotlib's default colour cycle
WIDTH, HEIGHT = 960, 600
LEFT, RIGHT, TOP, BOTTOM = 90, 20, 20, 70
COLORS = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b", "#e377c2",
          "#7f7f7f", "#bcbd22", "#17becf")


def parse_log(path: str):
    """-> {loss_name: [(global_step_index, value), ...]}"""
    curves: dict[str, list[tuple[int, float]]] = {}
    idx = 0
    with open(path, errors="replace") as fh:
        for line in fh:
            if "S" not in line or "|" not in line and "(*" not in line:
                continue
            if not re.search(r"E(\d+)S(\d+)", line):
                continue
            found = LOSS_RE.findall(line)
            if not found:
                continue
            for name, val in found:
                curves.setdefault(name, []).append((idx, float(val)))
            idx += 1
    return curves


def smooth(vals, window: int = 10):
    out, acc = [], []
    for v in vals:
        acc.append(v)
        if len(acc) > window:
            acc.pop(0)
        out.append(sum(acc) / len(acc))
    return out


def _ticks(lo: float, hi: float, n: int = 6) -> list[float]:
    """Round tick values spanning [lo, hi]: steps of 1, 2 or 5 x 10^k."""
    if hi <= lo:
        return [lo]
    raw = (hi - lo) / (n - 1)
    mag = 10.0 ** math.floor(math.log10(raw))
    step = next(m * mag for m in (1, 2, 5, 10) if m * mag >= raw)
    first = math.ceil(lo / step - 1e-9) * step
    return [first + i * step for i in range(int((hi - first) / step + 1e-9) + 1)]


def _label(v: float) -> str:
    return f"{v:.6g}"


def render_svg(series: list[tuple[str, list[int], list[float]]], logy: bool = False) -> str:
    """An SVG figure of ``(label, steps, values)`` curves. With ``logy`` the
    y axis is log10 and values <= 0 are left out of their curves."""
    if logy:
        series = [(lab, [s for s, v in zip(xs, ys) if v > 0], [math.log10(v) for v in ys if v > 0])
                  for lab, xs, ys in series]
    xs_all = [x for _, xs, _ in series for x in xs] or [0]
    ys_all = [y for _, _, ys in series for y in ys] or [0.0]
    x0, x1 = min(xs_all), max(xs_all)
    y0, y1 = min(ys_all), max(ys_all)
    if x1 == x0:
        x0, x1 = x0 - 1, x1 + 1
    if y1 == y0:
        pad = abs(y0) * 0.05 or 1.0
        y0, y1 = y0 - pad, y1 + pad
    pad = (y1 - y0) * 0.05
    y0, y1 = y0 - pad, y1 + pad
    pw, ph = WIDTH - LEFT - RIGHT, HEIGHT - TOP - BOTTOM

    def px(x):
        return LEFT + (x - x0) / (x1 - x0) * pw

    def py(y):
        return TOP + (y1 - y) / (y1 - y0) * ph

    out = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{WIDTH}" height="{HEIGHT}" '
           f'viewBox="0 0 {WIDTH} {HEIGHT}" font-family="sans-serif" font-size="12">',
           f'<rect width="{WIDTH}" height="{HEIGHT}" fill="white"/>',
           f'<rect class="axes" x="{LEFT}" y="{TOP}" width="{pw}" height="{ph}" fill="none" '
           f'stroke="black"/>']
    for t in _ticks(x0, x1):
        x = px(t)
        out.append(f'<line x1="{x:.2f}" y1="{TOP + ph}" x2="{x:.2f}" y2="{TOP + ph + 5}" '
                   f'stroke="black"/>')
        out.append(f'<text x="{x:.2f}" y="{TOP + ph + 20}" text-anchor="middle">'
                   f'{_label(t)}</text>')
    yt = (range(math.ceil(y0), math.floor(y1) + 1) if logy and y1 - y0 >= 1
          else _ticks(y0, y1))
    for t in yt:
        y = py(t)
        text = f"1e{int(t)}" if logy and float(t).is_integer() else _label(
            10 ** t if logy else t)
        out.append(f'<line x1="{LEFT - 5}" y1="{y:.2f}" x2="{LEFT}" y2="{y:.2f}" stroke="black"/>')
        out.append(f'<text x="{LEFT - 8}" y="{y + 4:.2f}" text-anchor="end">{text}</text>')
    out.append(f'<text class="xlabel" x="{LEFT + pw / 2:.1f}" y="{HEIGHT - 20}" '
               f'text-anchor="middle" font-size="14">logged step</text>')
    out.append(f'<text class="ylabel" x="20" y="{TOP + ph / 2:.1f}" text-anchor="middle" '
               f'font-size="14" transform="rotate(-90 20 {TOP + ph / 2:.1f})">'
               f'loss (moving avg){" (log)" if logy else ""}</text>')
    for i, (label, xs, ys) in enumerate(series):
        color = COLORS[i % len(COLORS)]
        pts = " ".join(f"{px(x):.2f},{py(y):.2f}" for x, y in zip(xs, ys))
        out.append(f'<polyline class="curve" data-label={quoteattr(label)} '
                   f'fill="none" stroke="{color}" stroke-width="1.5" points="{pts}"/>')
    lx, ly = LEFT + pw - 10, TOP + 10
    for i, (label, _, _) in enumerate(series):
        y = ly + 16 * i
        color = COLORS[i % len(COLORS)]
        out.append(f'<line x1="{lx - 150}" y1="{y + 6}" x2="{lx - 130}" y2="{y + 6}" '
                   f'stroke="{color}" stroke-width="2"/>')
        out.append(f'<text class="legend" x="{lx - 125}" y="{y + 10}" font-size="10">'
                   f'{escape(label)}</text>')
    out.append("</svg>")
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("logs", nargs="+", help="log files (cli/train.py format)")
    ap.add_argument("--out", default="loss.svg", help="the figure, an .svg file")
    ap.add_argument("--window", type=int, default=10, help="moving-average window")
    ap.add_argument("--logy", action="store_true")
    args = ap.parse_args(argv)
    if not args.out.lower().endswith(".svg"):
        ap.error(f"--out {args.out}: the port draws SVG only; name an .svg file")

    series = []
    for path in args.logs:
        for name, pts in parse_log(path).items():
            label = name if len(args.logs) == 1 else f"{path.split('/')[-1]}:{name}"
            series.append((label, [p[0] for p in pts], smooth([p[1] for p in pts], args.window)))
    if not series:
        print("no loss lines found in the given logs", file=sys.stderr)
        return 1
    with open(args.out, "w") as fh:
        fh.write(render_svg(series, args.logy))
    print(f"wrote {args.out} ({len(series)} curves)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
