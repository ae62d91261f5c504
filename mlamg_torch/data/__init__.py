from mlamg_torch.data.grid import Grid, rotation_matrix_3d  # noqa: F401
from mlamg_torch.data import fem  # noqa: F401
