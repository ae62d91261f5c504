"""Weight-vector codec of the GA and the gradient trainer (counterpart of
``mlamg_tpu/ga``; the GA itself is not ported yet)."""

from mlamg_torch.ga.codec import assign_flat, flat_grad, flatten_params

__all__ = ["assign_flat", "flat_grad", "flatten_params"]
