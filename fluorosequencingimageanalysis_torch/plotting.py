"""Reporting plots: intensity histograms and drop heatmaps.

A copy of fluorosequencingimageanalysis_tpu/plotting.py (numpy only;
tests/test_torch_import.py holds it equal to that module). API parity with
the reference's plotting module (plotting.py:16-349), which renders via
plotly offline. Plotly is not a dependency here: the same aggregation logic
emits self-contained HTML (inline-styled table heatmaps, SVG histogram). If
plotly is importable it is used for pixel-identical output; otherwise the
fallback renderer writes the same data to the same filepath.
"""

from __future__ import annotations

import html as _html

import numpy as np

colors = {405: "GnBu", 488: "YIOrRd", 561: "YIOrRd", 647: "YIGnBu"}

_CHANNEL_RGB = {405: (8, 104, 172), 488: (227, 74, 51),
                561: (227, 74, 51), 647: (44, 127, 184)}


def _have_plotly():
    try:
        import plotly.offline  # noqa: F401
        return True
    except Exception:
        return False


def _write_html(filepath, title, body):
    doc = ("<!DOCTYPE html><html><head><meta charset='utf-8'><title>" +
           _html.escape(title) + "</title></head><body><h2>" +
           _html.escape(title) + "</h2>" + body + "</body></html>")
    with open(filepath, "w") as f:
        f.write(doc)


def _heatmap_html(z, x_labels, y_labels, wavelength):
    z = np.asarray(z, dtype=float)
    zmax = z.max() if z.size else 1.0
    zmax = zmax if zmax > 0 else 1.0
    r0, g0, b0 = _CHANNEL_RGB.get(wavelength, (44, 127, 184))
    rows = ["<table style='border-collapse:collapse;font:12px sans-serif'>"]
    rows.append("<tr><td></td>" +
                "".join(f"<td style='padding:4px;text-align:center'>"
                        f"<b>{_html.escape(str(c))}</b></td>"
                        for c in x_labels) + "</tr>")
    for yi, ylab in enumerate(y_labels):
        cells = [f"<td style='padding:4px'><b>{_html.escape(str(ylab))}</b>"
                 "</td>"]
        for xi in range(len(x_labels)):
            v = z[yi, xi] if yi < z.shape[0] and xi < z.shape[1] else 0
            frac = v / zmax
            r = int(255 - (255 - r0) * frac)
            g = int(255 - (255 - g0) * frac)
            b = int(255 - (255 - b0) * frac)
            fg = "white" if frac > 0.75 else "black"
            cells.append(
                f"<td style='padding:6px;text-align:center;"
                f"background:rgb({r},{g},{b});color:{fg};"
                f"border:1px solid #ccc'>{int(v)}</td>")
        rows.append("<tr>" + "".join(cells) + "</tr>")
    rows.append("</table>")
    return "".join(rows)


def plot_histogram(plot_target, title, yaxis_title, xaxis_title, log_yaxis,
                   filepath):
    """Histogram plot (plotting.py:16-26)."""
    plot_target = np.asarray(plot_target, dtype=float)
    counts, edges = np.histogram(plot_target, bins=100)
    if log_yaxis:
        heights = np.log10(np.maximum(counts, 1))
    else:
        heights = counts.astype(float)
    hmax = heights.max() if heights.size and heights.max() > 0 else 1.0
    width, height = 800, 300
    bar_w = width / len(counts)
    bars = []
    for i, h in enumerate(heights):
        bh = h / hmax * (height - 20)
        bars.append(f"<rect x='{i * bar_w:.1f}' y='{height - bh:.1f}' "
                    f"width='{bar_w:.1f}' height='{bh:.1f}' "
                    f"fill='#4682b4'/>")
    svg = (f"<svg width='{width}' height='{height + 40}' "
           "xmlns='http://www.w3.org/2000/svg'>" + "".join(bars) +
           f"<text x='5' y='{height + 20}' font-size='12'>"
           f"{_html.escape(xaxis_title)}: "
           f"[{edges[0]:.1f}, {edges[-1]:.1f}] | "
           f"{_html.escape(yaxis_title)}" +
           (" (log)" if log_yaxis else "") + "</text></svg>")
    _write_html(filepath, title, svg)
    return filepath


def _single_drops_array(signals, total_cycles, plot_remainders,
                        v2_starting_intensity_cap=None):
    """Shared single-drop aggregation (plotting.py:34-54 and 193-215)."""
    size = total_cycles + 1 if plot_remainders else total_cycles
    arr = np.zeros((1, size), dtype=int)
    for key, count in signals.items():
        if v2_starting_intensity_cap is not None:
            signal, is_zero, starting_intensity = key
            if starting_intensity > v2_starting_intensity_cap:
                continue
        else:
            signal, is_zero = key
        if len(signal) != 1:
            continue
        if signal == (("A", 0),):
            if not plot_remainders or is_zero:
                continue
            x, y = 0, size - 1
        else:
            if not is_zero:
                continue
            x, y = 0, signal[0][1] - 1
        if 0 <= y < size:
            arr[x, y] += count
    return arr


def _double_drops_array(signals, total_cycles, plot_remainders,
                        plot_multidrops, v2_starting_intensity_cap=None):
    """Shared double-drop aggregation (plotting.py:110-134 and 269-297)."""
    sy = total_cycles + 1 if plot_remainders else total_cycles
    sx = total_cycles
    arr = np.zeros((sx, sy), dtype=int)
    for key, count in signals.items():
        if v2_starting_intensity_cap is not None:
            signal, is_zero, starting_intensity = key
            if starting_intensity > v2_starting_intensity_cap:
                continue
        else:
            signal, is_zero = key
        if len(signal) == 1:
            if signal == (("A", 0),):
                continue
            elif plot_remainders and not is_zero:
                x, y = signal[0][1] - 1, sy - 1
            else:
                continue
        elif len(signal) == 2:
            if not plot_multidrops and len(signal) > len(set(signal)):
                continue
            elif is_zero:
                x, y = signal[0][1] - 1, signal[1][1] - 1
            else:
                continue
        else:
            continue
        if 0 <= x < sx and 0 <= y < sy:
            arr[x, y] += count
    return arr


def _cycles_header(num_mocks, num_edmans, num_mocks_omitted,
                   with_remainder):
    header = (["M" + str(i + 1 + num_mocks_omitted)
               for i in range(num_mocks)] +
              ["E" + str(i + 1) for i in range(num_edmans)])
    if with_remainder:
        header += ["R"]
    return header


def single_drops_heatmap(signals, num_mocks, num_edmans, num_mocks_omitted,
                         peptide_string, wavelength, zmin, zmax, filepath,
                         plot_multidrops=False, plot_remainders=False):
    """1 x cycles annotated heatmap (plotting.py:29-102); signals keyed
    (signal, is_zero)."""
    num_mocks -= num_mocks_omitted
    total_cycles = num_mocks + num_edmans
    if wavelength not in colors:
        raise Exception("Invalid wavelength.")
    arr = _single_drops_array(signals, total_cycles, plot_remainders)
    header = _cycles_header(num_mocks, num_edmans, num_mocks_omitted, True)
    title = ("Single Drops (" + str(wavelength) + " Channel) Total: " +
             str(int(arr.sum())) + " - " + str(peptide_string))
    _write_html(filepath, title,
                _heatmap_html(arr, header[:arr.shape[1]], ["C"], wavelength))
    return filepath


def double_drops_heatmap(signals, num_mocks, num_edmans, num_mocks_omitted,
                         peptide_string, wavelength, zmin, zmax, filepath,
                         plot_multidrops=False, plot_remainders=False):
    """cycles x cycles triangle heatmap (plotting.py:105-185)."""
    num_mocks -= num_mocks_omitted
    total_cycles = num_mocks + num_edmans
    if wavelength not in colors:
        raise Exception("Invalid wavelength.")
    arr = _double_drops_array(signals, total_cycles, plot_remainders,
                              plot_multidrops)
    y_header = _cycles_header(num_mocks, num_edmans, num_mocks_omitted,
                              False)
    x_header = _cycles_header(num_mocks, num_edmans, num_mocks_omitted,
                              plot_remainders)
    title = ("Double Drops (" + str(wavelength) + " Channel) Total: " +
             str(int(arr.sum())) + " - " + str(peptide_string))
    _write_html(filepath, title,
                _heatmap_html(arr, x_header[:arr.shape[1]],
                              y_header[:arr.shape[0]], wavelength))
    return filepath


def single_drops_heatmap_v2(signals, num_mocks, num_edmans, num_mocks_omitted,
                            peptide_string, wavelength, zmin, zmax, filepath,
                            plot_remainders=False):
    """v2: signals keyed (signal, is_zero, starting_intensity); only
    starting_intensity <= 1 plotted (plotting.py:188-263)."""
    num_mocks -= num_mocks_omitted
    total_cycles = num_mocks + num_edmans
    if wavelength not in colors:
        raise Exception("Invalid wavelength.")
    arr = _single_drops_array(signals, total_cycles, plot_remainders,
                              v2_starting_intensity_cap=1)
    header = _cycles_header(num_mocks, num_edmans, num_mocks_omitted, True)
    title = ("Single Drops (" + str(wavelength) + " Channel) Total: " +
             str(int(arr.sum())) + " - " + str(peptide_string))
    _write_html(filepath, title,
                _heatmap_html(arr, header[:arr.shape[1]], ["C"], wavelength))
    return filepath


def double_drops_heatmap_v2(signals, num_mocks, num_edmans, num_mocks_omitted,
                            peptide_string, wavelength, zmin, zmax, filepath,
                            plot_multidrops=False, plot_remainders=False):
    """v2: keys carry starting_intensity; only <= 2 plotted
    (plotting.py:266-348)."""
    num_mocks -= num_mocks_omitted
    total_cycles = num_mocks + num_edmans
    if wavelength not in colors:
        raise Exception("Invalid wavelength.")
    arr = _double_drops_array(signals, total_cycles, plot_remainders,
                              plot_multidrops, v2_starting_intensity_cap=2)
    y_header = _cycles_header(num_mocks, num_edmans, num_mocks_omitted,
                              False)
    x_header = _cycles_header(num_mocks, num_edmans, num_mocks_omitted,
                              plot_remainders)
    title = ("Double Drops (" + str(wavelength) + " Channel) Total: " +
             str(int(arr.sum())) + " - " + str(peptide_string))
    _write_html(filepath, title,
                _heatmap_html(arr, x_header[:arr.shape[1]],
                              y_header[:arr.shape[0]], wavelength))
    return filepath
