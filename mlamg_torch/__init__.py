"""mlamg_torch: the PyTorch/CUDA port of ``mlamg_tpu`` for one NVIDIA H100.

Module paths follow ``mlamg_tpu`` so each piece's JAX counterpart (its
reference) is found under the same name.  The port imports torch, numpy
and scipy only; it never imports jax or ``mlamg_tpu``.

Hand-written CUDA kernels live in ``ops/csrc/`` and are built with
``nvcc`` at first use into ``mlamg_torch/_build/`` (see ``ops/_build.py``).
"""

__version__ = "0.1.0"

from mlamg_torch.device import resolve_device  # noqa: F401
from mlamg_torch.ops.sparse import COO, CSR, ELL  # noqa: F401
