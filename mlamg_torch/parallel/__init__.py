"""Row-partitioned and population-parallel paths (counterpart of
``mlamg_tpu/parallel``)."""

from mlamg_torch.parallel.mesh import make_mesh, population_sharding  # noqa: F401
from mlamg_torch.parallel.pop_parallel import shard_population_eval  # noqa: F401
from mlamg_torch.parallel.pspmv import PartitionedELL, pspmv, pspmv_halo  # noqa: F401
from mlamg_torch.parallel.pbf import pbf, pbf_partition  # noqa: F401
from mlamg_torch.parallel.pcycle import ptwolevel_solve, pvcycle_solve  # noqa: F401
from mlamg_torch.parallel.plloyd import plloyd  # noqa: F401
from mlamg_torch.parallel.distributed import (  # noqa: F401
    initialize,
    make_global,
    gather_global,
    broadcast_from_coordinator,
    multihost_population_eval,
    process_count,
    process_index,
    is_coordinator,
)
