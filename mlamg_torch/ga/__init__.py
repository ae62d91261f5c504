"""The genetic algorithm and its weight-vector codec (counterpart of
``mlamg_tpu/ga``)."""

from mlamg_torch.ga.codec import assign_flat, flat_grad, flatten_params, fold_ids, init_population
from mlamg_torch.ga.ga import GAConfig, ParallelGA

__all__ = ["GAConfig", "ParallelGA", "assign_flat", "flat_grad", "flatten_params", "fold_ids",
           "init_population"]
