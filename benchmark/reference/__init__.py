"""Plain references and data makers of the benchmark: numpy, scipy and
plain torch only, nothing of the measured package."""
