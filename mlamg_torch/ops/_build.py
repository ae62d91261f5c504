"""Build the port's native code at first use, never at import, and launch
its CUDA kernels.

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

:func:`launch` is every kernel wrapper's way onto the card: it loads the
kernel's library at its first launch (:func:`kernel_library`, which also
sets the entry points' argument types), checks the operand's device,
passes the current stream, turns a failed launch into an error and counts
the launch in ``LAUNCHES``.  :func:`check_vector` is the spmv wrappers'
check of a vector operand.
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

import torch

from mlamg_torch.utils.profiler import LAUNCHES

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

_P, _INT, _PLAN = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)
# kernel name -> its library's entry points and their argument types, the
# stream last; each returns a CUDA error code (0: launched)
KERNEL_ENTRIES = {
    "well_spmv": {"well_spmv_f32": [_P] * 8 + [_INT, _INT, _INT, ctypes.c_float, _P]},
    "dia_spmv": {"dia_spmv_f32": [_P, _P, _INT, _P, _P, _P, ctypes.c_int64, ctypes.c_float,
                                  _P]},
    "ordered_sum": {"ordered_sum": [_INT, _P, _P, _PLAN, _P],
                    "slot_sum": [_INT, _P, _P, _P, _PLAN, _P]},
}

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
    """The loaded library of kernel ``name``, built first if needed, its
    entry points typed from ``KERNEL_ENTRIES``."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_kernels([name])[name]))
        for entry, argtypes in KERNEL_ENTRIES[name].items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _LIBS[name] = lib
    return lib


def launch(name: str, entry: str, t: torch.Tensor, *args) -> None:
    """Call ``entry`` of kernel ``name``'s library with ``args`` and the
    current stream of ``t``'s device, and count one launch in
    ``LAUNCHES[name]``.  Raises ``ValueError`` unless ``t`` is on the
    current device, ``RuntimeError`` if the launch fails."""
    index = t.get_device()
    if index != torch.cuda.current_device():
        raise ValueError(f"{name}: operands on cuda:{index} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    rc = getattr(_LIBS.get(name) or kernel_library(name), entry)(
        *args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1


def check_vector(kernel: str, name: str, v: torch.Tensor, n: int, device) -> None:
    """Raises unless ``v`` is a contiguous (n,) tensor on ``device``."""
    if v.shape != (n,) or not v.is_contiguous():
        raise ValueError(
            f"{kernel}: {name} must be a contiguous ({n},) tensor, got "
            f"{tuple(v.shape)} contiguous={v.is_contiguous()}"
        )
    if v.device != device:
        raise ValueError(f"{kernel}: {name} is on {v.device}, operator on {device}")
