from mlamg_torch.utils.profiler import Profiler  # noqa: F401
from mlamg_torch.utils.checkpoint import save_checkpoint, load_checkpoint  # noqa: F401
from mlamg_torch.utils.metrics import MetricsWriter  # noqa: F401
