"""Build the port's native code at first use, never at import.

Every library is compiled from sources in the checkout into
``mlamg_torch/_build/`` (listed in ``.gitignore``) and loaded with ctypes:

- the CUDA kernels in ``ops/csrc/*.cu``, by ``nvcc`` for ``sm_90a`` into
  shared libraries with a plain C interface (no PyTorch headers, so a build
  takes seconds);
- the host C++ runtime ``native/mlamg_native.cpp`` (see ``mlamg_torch.native``).

A library's file name carries a hash of its source, its compile command,
the compiler's version and the host name, so an edited source is rebuilt
and a library built by another toolchain or on another machine is not
loaded.  The compiler writes to a private temporary file that is renamed
into place, so concurrent processes may build the same library safely.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

# kernel name -> source file in csrc/
KERNEL_SOURCES = {"well_spmv": "well_spmv.cu", "dia_spmv": "dia_spmv.cu",
                  "ordered_sum": "ordered_sum.cu"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
BUILD_TIMEOUT_S = 600

_LIBS: dict[str, ctypes.CDLL] = {}
_COMPILER_VERSIONS: dict[str, str] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``.  Raises if there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the port's CUDA kernels are compiled at first use"
    )


def _compiler_version(compiler: str) -> str:
    if compiler not in _COMPILER_VERSIONS:
        out = subprocess.run([compiler, "--version"], capture_output=True,
                             text=True, timeout=60)
        _COMPILER_VERSIONS[compiler] = out.stdout
    return _COMPILER_VERSIONS[compiler]


def library_path(stem: str, source: Path, command: tuple) -> Path:
    """Where the library built from ``source`` by ``command`` lives."""
    h = hashlib.sha256()
    h.update(Path(source).read_bytes())
    h.update("\0".join(command).encode())
    h.update(_compiler_version(command[0]).encode())
    h.update(platform.node().encode())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def compile_library(command: tuple, source: Path, out: Path) -> None:
    """Compile ``source`` into ``out`` unless it exists; raises with the
    compiler's log if it fails.  ``command`` is the compiler and its flags;
    source and ``-o`` are appended here."""
    if out.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [*command, "-o", str(tmp), str(source)]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed:\n$ {' '.join(cmd)}\n{proc.stdout}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def _kernel_job(name: str):
    command = (find_nvcc(), *NVCC_FLAGS)
    source = CSRC / KERNEL_SOURCES[name]
    return command, source, library_path(name, source, command)


def build_kernels(names=None) -> dict[str, Path]:
    """Compile the named CUDA kernels (default: all), one ``nvcc`` per
    source, all started together.  Returns name -> library path."""
    names = list(KERNEL_SOURCES) if names is None else list(names)
    jobs = {name: _kernel_job(name) for name in names}
    with ThreadPoolExecutor(max_workers=max(len(jobs), 1)) as pool:
        for f in [pool.submit(compile_library, *job) for job in jobs.values()]:
            f.result()
    return {name: job[2] for name, job in jobs.items()}


def kernel_library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build_kernels([name])[name]))
    return lib
