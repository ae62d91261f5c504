"""Training metrics writer (counterpart of ``mlamg_tpu/utils/metrics.py``):
JSONL records, mirrored to TensorBoard where its writer imports."""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    def __init__(self, logdir: str = "runs"):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        try:  # optional TensorBoard mirror
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(logdir)
        except Exception:
            pass

    def add_scalars(self, tag: str, values: dict, step: int) -> None:
        rec = {"tag": tag, "step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalars(tag, values, step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
