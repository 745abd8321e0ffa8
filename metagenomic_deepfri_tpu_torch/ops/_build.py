"""Build ``csrc/*.cu`` with nvcc at first use and load it with ctypes.

The kernels have a plain C interface (no PyTorch headers), so one nvcc call
builds a shared library in seconds. The library goes into the package's
``build/`` directory, named by a hash of the sources and flags, and is reused
while that hash is unchanged. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """nvcc is missing or failed; the message carries its output."""


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    """nvcc under $CUDA_HOME, else the toolkit's default place, else PATH."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").is_file():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmdf_kernels_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the sources unless a library for their hash exists.

    nvcc's output (including ``-Xptxas -v`` register and shared-memory
    counts) is kept beside the library as ``<name>.log``.
    """
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed with exit code {proc.returncode}:\n{log}")
    lib.with_suffix(".log").write_text(log)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels, with every signature set.

    ``argtypes`` use ``c_void_p`` for each pointer and the stream; without
    them ctypes would pass Python ints as 32-bit C ints and cut pointers.
    """
    lib = ctypes.CDLL(str(build_library()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mdf_contact_degrees.argtypes = [p, p, p, p, i, i, f, i, p]
    lib.mdf_contact_degrees.restype = i
    lib.mdf_graphconv_aggregate.argtypes = [p, p, p, p, p, i, i, i, f, i, i,
                                            p]
    lib.mdf_graphconv_aggregate.restype = i
    lib.mdf_error_string.argtypes = [i]
    lib.mdf_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = lib.mdf_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
