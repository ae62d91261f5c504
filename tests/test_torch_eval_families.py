"""The learned two-level evaluation against the JAX package per grid in
float64 on the other families (helpers and the 2d_iso cases:
``tests/test_torch_eval.py``): two 2d_aniso grids with ``runs_aniso_r5_c``,
and the smallest 3d_iso grid with ``runs_3d_iso_r5``, the checkpoint
without the relative-strength feature and with Bellman-Ford width 15."""

import pytest

from test_torch_eval import check_slice_against_jax


@pytest.mark.parametrize("family,rank", [("2d_aniso", 0), ("2d_aniso", 1), ("3d_iso", 0)])
def test_slice_matches_jax_per_grid_in_float64(family, rank):
    check_slice_against_jax(family, rank)
