"""Graph algorithms (counterpart of ``mlamg_tpu/graph``)."""

from mlamg_torch.graph.topk import topk_mask, topk_indices  # noqa: F401
from mlamg_torch.graph.bellman_ford import (  # noqa: F401
    bellman_ford,
    bellman_ford_pull,
    nearest_center_to_agg,
)
from mlamg_torch.graph.lloyd import lloyd_aggregation, lloyd_distance, LLOYD_DISTANCES  # noqa: F401
from mlamg_torch.graph.components import (  # noqa: F401
    connected_components,
    num_connected_components,
    check_aggregates_connected,
)
from mlamg_torch.graph.coarsening import greedy_coarsening, diag_dominance  # noqa: F401
from mlamg_torch.graph.strength import strength_measure, STRENGTH_MEASURES  # noqa: F401
