#!/usr/bin/env python3
"""The benchmark's one command, run from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card and prints one JSON line
last (see ``harness/core.py``).  Exits non-zero without a result where
the card the cell asks for is missing.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_cache")
# build and kernel caches at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [ROOT, HERE]

from harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
