"""Aggregate figures (counterpart of ``mlamg_tpu/viz``)."""

from mlamg_torch.viz.aggplot import (  # noqa: F401
    AsyncPlotter,
    plot_agg,
    plot_agg_3d,
    plot_grid,
    plot_spider_agg,
)
