"""Sparse containers and products (counterpart of ``mlamg_tpu/ops``).

``well_spmv`` is the JAX package's ``well_spmv_pallas``: its Pallas kernel
is the CUDA kernel ``ops/csrc/well_spmv.cu``, built at its first launch.
"""

from mlamg_torch.ops.sparse import COO, CSR, ELL  # noqa: F401
from mlamg_torch.ops.dia import DIA, auto_format  # noqa: F401
from mlamg_torch.ops.unstructured import WindowedELL, well_spmv, rcm_spmv_setup  # noqa: F401
from mlamg_torch.ops.bsr import BSR, bsr_spmv, bsr_spmv_t  # noqa: F401
from mlamg_torch.ops import matmul  # noqa: F401
from mlamg_torch.ops.matmul import (  # noqa: F401
    spmv,
    spmv_t,
    spmm,
    spmm_t,
    spgemm,
    spgemm_masked,
    rap_dense,
    rap_fused,
    transpose,
)
