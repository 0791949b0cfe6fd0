"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ctypes.

Every ``csrc/*.cu`` file is compiled in one ``nvcc`` call into a shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds).  The library's file name carries a hash of the sources and the
flags, so a changed source builds a new library and an unchanged one is
loaded as it is.  The build writes a temporary file and renames it into
place: there is no lock file to wait on, and two processes that build at
once both end with a whole library.

The build happens on first use, inside the call that launches a kernel;
importing this module runs nothing.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import List, Optional

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler",
              "-fPIC")
NVCC_TIMEOUT_S = 120
DEFAULT_CUDA_HOME = "/usr/local/cuda"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds the last build took in this process (0.0 when the library was
# already on disk), and what ptxas reported for each kernel (registers,
# shared memory, spills); chip_smoke.py prints both
last_build_seconds: Optional[float] = None
last_build_log: str = ""


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``.  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.path.isfile(cand) and os.access(cand, os.X_OK):
                return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and in "
        "/usr/local/cuda/bin): the port's CUDA kernels are built from "
        "cfun_tpu_torch/csrc at first use and need the CUDA toolkit")


def library_path(srcs: List[str]) -> str:
    h = hashlib.sha256()
    for flag in NVCC_FLAGS:
        h.update(flag.encode() + b"\0")
    for path in srcs:
        h.update(os.path.basename(path).encode() + b"\0")
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libcfun_kernels-{h.hexdigest()[:16]}.so")


def nvcc_command(nvcc: str, srcs: List[str], out: str) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", out, *srcs]


def build() -> str:
    """Compile the sources unless their library is already on disk;
    returns the library's path."""
    global last_build_seconds, last_build_log
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    out = library_path(srcs)
    if os.path.exists(out):
        last_build_seconds = 0.0
        return out
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(nvcc_command(nvcc, srcs, tmp),
                              capture_output=True, text=True,
                              timeout=NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}:\n"
                f"{proc.stderr.strip() or proc.stdout.strip()}")
        last_build_log = proc.stderr
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    last_build_seconds = time.perf_counter() - t0
    return out


def _declare(lib: ctypes.CDLL) -> None:
    ptr = ctypes.c_void_p
    lib.cfun_sorted_nms.argtypes = [ptr, ptr, ctypes.c_int, ctypes.c_float,
                                    ctypes.c_int, ptr, ptr, ptr, ptr]
    lib.cfun_sorted_nms.restype = ctypes.c_int
    lib.cfun_sorted_nms_max_n.argtypes = []
    lib.cfun_sorted_nms_max_n.restype = ctypes.c_int
    lib.cfun_sorted_nms_workspace_bytes.argtypes = [ctypes.c_int]
    lib.cfun_sorted_nms_workspace_bytes.restype = ctypes.c_longlong
    lib.cfun_fused_conv3d.argtypes = \
        [ptr, ptr, ctypes.c_int, ptr, ctypes.c_int, ptr, ptr, ptr] + \
        [ctypes.c_int] * 7 + [ctypes.c_float, ptr, ptr, ptr]
    lib.cfun_fused_conv3d.restype = ctypes.c_int
    lib.cfun_fused_conv3d_tiles.argtypes = [ctypes.c_int] * 3
    lib.cfun_fused_conv3d_tiles.restype = ctypes.c_int


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _declare(lib)
            _lib = lib
        return _lib
