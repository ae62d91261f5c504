"""Drivers of the measured package, one per kind of configuration: what the
harness builds, solves and reads through ``mlamg_torch``."""
