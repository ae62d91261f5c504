from mlamg_torch.data.grid import Grid

__all__ = ["Grid"]
