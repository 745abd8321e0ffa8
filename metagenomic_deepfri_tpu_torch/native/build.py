"""Build the host C++ libraries (NW aligner, k-mer prefilter, TSV row
formatter) at first use.

``native/nw.cpp`` and ``native/kmersearch.cpp`` (:data:`TWINS`) are
byte-identical copies of the JAX package's (a test holds them equal), so
both packages run one NW and one prefilter and the port needs nothing of the
JAX package's tree. ``native/tsvfmt.cpp``, which writes the prediction
matrices' rows, is the port's own and has no JAX twin: its tests hold it to
the ``"%.9g"`` formatting it replaces. All are compiled with the JAX
package's compiler and flags (``g++ -O3 -fopenmp -march=native ...``, the
``g++`` found on ``PATH``, as the JAX package runs it; ``$CXX`` is not read,
since it may name a compiler without OpenMP) into this package's ``build/``
directory, never next to the sources.

A library's name carries a hash of its source, the compiler's resolved
path, the flags and the host CPU (model and feature flags). ``-march=native`` code built on one
CPU can die with SIGILL on another, and a checkout may carry a ``build/``
made elsewhere: a library built for another CPU is simply not found, and is
built anew.

A failed build raises :class:`NativeBuildError` with the compiler's output.
There is no fallback: a pure-Python NW would be about a thousand times
slower. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import sys
import threading
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = _PKG_DIR / "build"

CXX = "g++"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-fopenmp",
            "-march=native", "-funroll-loops")
# Copies of the JAX package's sources, and every library.
TWINS = ("nw", "kmersearch")
NAMES = TWINS + ("tsvfmt",)

_P32 = ctypes.POINTER(ctypes.c_int32)
_P64 = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_PTR = ctypes.c_void_p
# (restype, argtypes) of every exported function, set once at load.
SIGNATURES = {
    "nw": {
        "nw_align": (_I32, [_P32, _I32, _P32, _I32, _P32, _I32, _I32, _I32,
                            ctypes.c_char_p, _P32]),
        "nw_score_batch": (None, [_P32, _I32, _P32, _P64, _I32, _P32, _I32,
                                  _I32, _I32, _I32, _P32]),
    },
    "kmersearch": {
        "kmer_candidates": (None, [_P32, _P64, _I32, _P32, _P64, _I32, _I32,
                                   _I32, _I32, _I32, _I32, _P32, _P32]),
    },
    "tsvfmt": {
        f"tsv_format_rows_{t}": (_I64, [_PTR, _I64, _I64, ctypes.c_char_p,
                                        _PTR, _PTR, _I64])
        for t in ("f32", "f64")
    },
}

_LOCK = threading.Lock()
_LOADED: dict = {}


class NativeBuildError(RuntimeError):
    """The C++ compiler is missing or failed; the message carries its
    output."""


def _cpu_signature() -> str:
    """The host CPU's model name and feature flags (what ``-march=native``
    compiles for)."""
    fields = {}
    try:
        with open("/proc/cpuinfo", "r", encoding="utf-8") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                if key in ("model name", "flags", "Features", "CPU part") \
                        and key not in fields:
                    fields[key] = value.strip()
    except OSError:
        pass
    return repr((platform.machine(), platform.processor(),
                 sorted(fields.items())))


def source_path(name: str) -> Path:
    return SOURCE_DIR / f"{name}.cpp"


def library_path(name: str) -> Path:
    """Where the library for the current source, compiler, flags and CPU
    lives."""
    compiler = os.path.realpath(shutil.which(CXX) or CXX)
    h = hashlib.sha256(repr((compiler, CXXFLAGS)).encode())
    h.update(_cpu_signature().encode())
    h.update(source_path(name).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``<name>.cpp`` unless a library for its key exists."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXXFLAGS, str(source_path(name)), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as err:
        raise NativeBuildError(
            f"cannot run the C++ compiler {cmd[0]!r} ({err}); install g++ "
            f"(C++17, OpenMP)") from err
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"building {name} failed with exit code {proc.returncode}:\n"
            f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one library, once per process, with the
    ctypes signatures of :data:`SIGNATURES` declared."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (restype, argtypes) in SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _LOADED[name] = lib
        return lib


def compiler_version() -> str:
    """First line of ``g++ --version``."""
    proc = subprocess.run([CXX, "--version"], capture_output=True,
                          text=True, check=True)
    return proc.stdout.splitlines()[0] if proc.stdout else ""


def main() -> int:
    for name in NAMES:
        print(f"built {build(name)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
