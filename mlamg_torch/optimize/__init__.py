"""Gradient-free optimizers (counterpart of ``mlamg_tpu/optimize``)."""

from mlamg_torch.optimize.optimizers import SPSA, CuckooSearch, PseudoGradientOptimizer

__all__ = ["CuckooSearch", "PseudoGradientOptimizer", "SPSA"]
