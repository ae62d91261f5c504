"""Prefix-scoped options database (counterpart of
``mlamg_tpu/deploy/options.py``; the role of the PETSc options strings the
reference preconditioners read, e.g. 'mlamg_amg_rtol')."""

from __future__ import annotations


class Options:
    def __init__(self, values: dict | None = None, prefix: str = ""):
        self._values = dict(values or {})
        self._prefix = prefix

    def scoped(self, prefix: str) -> "Options":
        return Options(self._values, self._prefix + prefix)

    def get(self, name: str, default=None):
        return self._values.get(self._prefix + name, default)

    def get_scalar(self, name: str, default: float) -> float:
        return float(self.get(name, default))

    def get_int(self, name: str, default: int) -> int:
        return int(self.get(name, default))

    def get_string(self, name: str, default: str = "") -> str:
        return str(self.get(name, default))

    def set(self, name: str, value) -> None:
        self._values[self._prefix + name] = value
