"""Graph networks and their losses (counterpart of ``mlamg_tpu/models``)."""

from mlamg_torch.models.graphdata import (  # noqa: F401
    GraphData,
    graph_from_matrix,
    graph_from_matrix_basic,
    graph_from_matrix_node_vals,
)
from mlamg_torch.models.gnn import MLP, InstanceNorm, TAGConv, NNConv, EdgeModel, EdgeConv  # noqa: F401
from mlamg_torch.models.agg_interp import (  # noqa: F401
    MPNN,
    AggBinarizationLayer,
    AggNet,
    FullAggNet,
    AggOnlyNet,
    make_forward,
)
from mlamg_torch.models.loss import amg_loss, make_test_vectors, E_loss, R_jacobi  # noqa: F401
from mlamg_torch.models.interpolation import (  # noqa: F401
    InterpolationNetwork,
    CoarseFineNetwork,
    ContinuousInterpolationFullNetwork,
    EC_loss,
    E_loss_discrete,
)
from mlamg_torch.models.cf_interp import CFInterpolationNetwork, cf_graph, cf_rank  # noqa: F401
from mlamg_torch.models.convergence import ConvergencePredictor  # noqa: F401
