"""The reference's ``plotting`` module (plotting.py), on the port's
copy."""

from ..plotting import (  # noqa
    colors, plot_histogram, single_drops_heatmap, double_drops_heatmap,
    single_drops_heatmap_v2, double_drops_heatmap_v2)
