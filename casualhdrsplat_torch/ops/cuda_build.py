"""Build and load the port's hand-written CUDA kernels.

Each kernel source in casualhdrsplat_torch/csrc/ has a plain C entry point.
At first use it is compiled with `nvcc` for sm_90a into a shared library
under casualhdrsplat_torch/_build/ (named by a hash of the source, the
csrc/ headers it includes and the flags, so an edited source or header
rebuilds) and loaded with ctypes.  Nothing is built or loaded at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# `#include "name"`: a header of csrc/, found beside the source by nvcc
_INCLUDE = re.compile(r'^\s*#include\s+"([^"]+)"', re.MULTILINE)
# Every kernel's launch counter (an object with an int `launches`), in the
# order the kernels were defined: utils/cuda_graphs.py adds a captured
# graph's launches to them on each replay.
COUNTERS: list = []


def register_counter(counter) -> None:
    COUNTERS.append(counter)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def _local_includes(src: Path) -> list[Path]:
    """The csrc/ headers that `src` includes with quotes, and theirs."""
    found: list[Path] = []
    todo = [src]
    while todo:
        for name in _INCLUDE.findall(todo.pop().read_text()):
            header = CSRC_DIR / name
            if header not in found:
                found.append(header)
                todo.append(header)
    return found


def build(source_name: str) -> Path:
    """Compile csrc/<source_name> (if not built yet) and return the path of
    its shared library, named by a hash of the source, the headers it
    includes and the flags.  The compiler's log, including ptxas's register
    and shared-memory report, is written beside it as <library>.log."""
    src = CSRC_DIR / source_name
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in [src, *_local_includes(src)])
                            + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:12]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # two entry points of one source may be built at once by two threads
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".so.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {src}:\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, lib)  # atomic: concurrent builders never see a partial file
    return lib


class CudaKernel:
    """One kernel's C entry point, built and loaded at first use.

    `launches` counts launches made through `__call__`; it is a plain
    integer that a caller may reset.  With counted=False (a call that is
    only a part of a kernel's launch, another entry point counting it) it
    stays 0 and is not registered.
    """

    def __init__(self, source_name: str, symbol: str, argtypes, counted: bool = True):
        self.source_name = source_name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.counted = counted
        if counted:
            register_counter(self)
        self.library_path: Path | None = None
        self._fn = None
        self._lock = threading.Lock()

    def load(self):
        with self._lock:
            if self._fn is None:
                self.library_path = build(self.source_name)
                fn = getattr(ctypes.CDLL(str(self.library_path)), self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
        return self._fn

    def build_log(self) -> str:
        self.load()
        return self.library_path.with_suffix(".so.log").read_text()

    def __call__(self, *args) -> None:
        err = self.load()(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA launch failed with error {err}")
        if self.counted:
            self.launches += 1
