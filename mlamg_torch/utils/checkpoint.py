"""Checkpoints (counterpart of ``mlamg_tpu/utils/checkpoint.py``).

A checkpoint is a pickle of plain dicts of numpy arrays: ``generation``,
``best_params`` (the JAX package's parameter tree, see
:func:`mlamg_torch.convert.params_from_fullaggnet`), ``extra`` (with
``net_config``), and the GA's whole state: ``population``, ``fitness``,
``key`` and, where given, ``sigma``, so that ``--resume`` continues the
same run; gradient training leaves them None.  Either package reads the
other's.  Unpickling runs code, so load only checkpoints this project
wrote.
"""

from __future__ import annotations

import os
import pickle

import numpy as np


def _to_host(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if hasattr(tree, "detach"):
        tree = tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_checkpoint(path: str, *, generation: int, best_params=None, population=None,
                    fitness=None, key=None, sigma=None, extra=None) -> None:
    """Write a checkpoint: a temporary file renamed into place, so a reader
    never sees half of one."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "generation": int(generation),
        "best_params": _to_host(best_params),
        "population": _to_host(population),
        "fitness": _to_host(fitness),
        "key": _to_host(key),
        "extra": extra or {},
    }
    if sigma is not None:
        payload["sigma"] = float(sigma)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)
