"""Checkpoint reader (counterpart of ``mlamg_tpu/utils/checkpoint.py``
:func:`load_checkpoint`).

A checkpoint is a pickle of plain dicts of numpy arrays: ``best_params``,
``population``, ``fitness``, ``key``, ``generation`` and ``extra`` (with
``net_config``).  Unpickling runs code, so load only checkpoints this
project wrote.
"""

from __future__ import annotations

import pickle


def load_checkpoint(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)
