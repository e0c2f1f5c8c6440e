"""Weight-range and calibration-histogram visualization — counterpart of
``aimet_tpu/utils/visualization.py`` (self-contained HTML/SVG — replaces
the reference's bokeh stack: visualize_model.py, bokeh_plots.py,
plotting_utils.py). Tensors are read on the host as f32 numpy arrays."""
from __future__ import annotations

import html
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t)


def _svg_range_plot(names, mins, maxs, width=720, row_h=18):
    lo = min(mins)
    hi = max(maxs)
    span = max(hi - lo, 1e-9)
    x0, plot_w = 220, width - 240
    rows = []
    for i, (n, mn, mx) in enumerate(zip(names, mins, maxs)):
        y = 20 + i * row_h
        bx = x0 + (mn - lo) / span * plot_w
        bw = max((mx - mn) / span * plot_w, 1)
        rows.append(
            f'<text x="4" y="{y + 12}" font-size="11">{html.escape(n[:34])}</text>'
            f'<rect x="{bx:.1f}" y="{y + 3}" width="{bw:.1f}" height="10" '
            f'fill="#4a90d9" opacity="0.8"/>')
    h = 30 + len(names) * row_h
    zero_x = x0 + (0 - lo) / span * plot_w
    axis = (f'<line x1="{zero_x:.1f}" y1="12" x2="{zero_x:.1f}" y2="{h - 6}" '
            f'stroke="#c33" stroke-dasharray="3,3"/>' if lo <= 0 <= hi else "")
    return (f'<svg width="{width}" height="{h}" '
            f'xmlns="http://www.w3.org/2000/svg">{axis}{"".join(rows)}</svg>')


def visualize_weight_ranges(params, path: str, channel_axis: int = -1):
    """Per-layer weight min/max bars (visualize_model.py equivalent);
    ``params`` a dict of tensors by name."""
    names, mins, maxs = [], [], []
    for name, leaf in params.items():
        if "kernel" not in name and "embedding" not in name:
            continue
        arr = _np(leaf)
        names.append(name)
        mins.append(float(arr.min()))
        maxs.append(float(arr.max()))
    svg = _svg_range_plot(names, mins, maxs)
    with open(path, "w") as f:
        f.write(f"<!doctype html><html><body><h1>Weight ranges</h1>{svg}"
                f"</body></html>")


def visualize_encoding_ranges(sim, path: str):
    """Encoding min/max per quantizer."""
    names, mins, maxs = [], [], []
    for name, enc in sim.encodings.items():
        names.append(name)
        mins.append(float(_np(enc.min).min()))
        maxs.append(float(_np(enc.max).max()))
    svg = _svg_range_plot(names, mins, maxs)
    with open(path, "w") as f:
        f.write(f"<!doctype html><html><body><h1>Encoding ranges</h1>{svg}"
                f"</body></html>")


def visualize_calibration_histograms(sim, path: str, max_plots: int = 32):
    """Calibration PDFs per activation quantizer (requires retained observer
    state from compute_encodings)."""
    obs = getattr(sim, "_obs_states", None)
    if obs is None:
        raise RuntimeError("run compute_encodings first")
    blocks = []
    for name, st in list(obs.items())[:max_plots]:
        if not hasattr(st, "pdf"):
            continue
        pdf = _np(st.pdf)
        xleft = _np(st.xleft)
        peak = pdf.max() or 1.0
        pts = " ".join(
            f"{10 + i * 1.2:.1f},{60 - 55 * p / peak:.1f}"
            for i, p in enumerate(pdf))
        blocks.append(
            f"<div><b>{html.escape(name)}</b> "
            f"[{xleft[0]:.3g}, {xleft[-1]:.3g}]<br>"
            f'<svg width="640" height="64"><polyline points="{pts}" '
            f'fill="none" stroke="#4a90d9"/></svg></div>')
    with open(path, "w") as f:
        f.write("<!doctype html><html><body><h1>Calibration histograms</h1>"
                + "".join(blocks) + "</body></html>")


def _svg_xy_curve(points, width=560, height=300, xlabel="", ylabel=""):
    """Scatter+line SVG of (x, y) points (bokeh line/scatter stand-in)."""
    if not points:
        return "<svg/>"
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    sx = (width - 80) / max(x1 - x0, 1e-12)
    sy = (height - 60) / max(y1 - y0, 1e-12)

    def px(x):
        return 60 + (x - x0) * sx

    def py(y):
        return height - 40 - (y - y0) * sy

    path = " ".join(f"{'M' if i == 0 else 'L'}{px(x):.1f},{py(y):.1f}"
                    for i, (x, y) in enumerate(points))
    dots = "".join(f'<circle cx="{px(x):.1f}" cy="{py(y):.1f}" r="3" '
                   f'fill="#4a90d9"/>' for x, y in points)
    return (f'<svg width="{width}" height="{height}" '
            f'xmlns="http://www.w3.org/2000/svg">'
            f'<path d="{path}" stroke="#4a90d9" fill="none"/>{dots}'
            f'<text x="{width // 2}" y="{height - 8}" font-size="12" '
            f'text-anchor="middle">{html.escape(xlabel)}</text>'
            f'<text x="14" y="{height // 2}" font-size="12" '
            f'transform="rotate(-90 14 {height // 2})" '
            f'text-anchor="middle">{html.escape(ylabel)}</text>'
            f'<text x="58" y="{height - 24}" font-size="10">{x0:.3g}</text>'
            f'<text x="{width - 36}" y="{height - 24}" font-size="10">'
            f'{x1:.3g}</text>'
            f'<text x="30" y="{height - 42}" font-size="10">{y0:.4g}</text>'
            f'<text x="30" y="24" font-size="10">{y1:.4g}</text></svg>')


def visualize_amp_pareto(amp_result, path: str) -> str:
    """AMP pareto front (relative bit cost vs accuracy) + per-group
    phase-1 eval-score table — the reference's bokeh pareto/eval plots
    (mixed_precision_algo.py pareto front, plotting via bokeh_plots)."""
    curve = _svg_xy_curve(sorted(amp_result.pareto_front),
                          xlabel="relative bit cost", ylabel="accuracy")
    rows = "".join(
        f"<tr><td>{html.escape(g)}</td>"
        f"<td>({c.act_bw}, {c.param_bw})</td><td>{score:.5f}</td></tr>"
        for (g, c), score in sorted(amp_result.phase1_scores.items(),
                                    key=lambda kv: kv[1]))
    doc = f"""<!doctype html><html><head><title>AMP</title>
<style>body{{font-family:sans-serif}}table{{border-collapse:collapse}}
td,th{{border:1px solid #999;padding:4px 8px}}</style></head><body>
<h1>AMP mixed-precision selection</h1>
<p>baseline accuracy {amp_result.baseline_accuracy:.5f} &rarr; final
{amp_result.final_accuracy:.5f}</p>
<h2>Pareto front</h2>{curve}
<h2>Phase-1 per-group candidate scores (low = sensitive)</h2>
<table><tr><th>quantizer group</th><th>(act, param) bw</th><th>eval</th></tr>
{rows}</table></body></html>"""
    with open(path, "w") as f:
        f.write(doc)
    return path


def visualize_compression_curves(eval_scores: Dict[str, Dict[float, float]],
                                 path: str) -> str:
    """Per-layer compression-ratio vs eval-score curves — the reference's
    eval-score-table bokeh dashboard for greedy selection
    (aimet_common/curve_fit.py + bokeh eval tables)."""
    sections = []
    for layer, scores in eval_scores.items():
        pts = sorted(scores.items())
        sections.append(f"<h3>{html.escape(layer)}</h3>"
                        + _svg_xy_curve(pts, width=460, height=220,
                                        xlabel="comp ratio",
                                        ylabel="eval score"))
    doc = ("<!doctype html><html><head><title>Compression curves</title>"
           "<style>body{font-family:sans-serif}</style></head><body>"
           "<h1>Greedy selection eval scores</h1>"
           + "".join(sections) + "</body></html>")
    with open(path, "w") as f:
        f.write(doc)
    return path
