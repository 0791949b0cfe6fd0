"""Builds the port's native code and loads the CUDA kernels with ctypes.

Two libraries, each with a plain C interface (no PyTorch headers, so each
build takes seconds), built into the git-ignored ``_build/``:

- the CUDA kernels: every ``csrc/*.cu`` file in one ``nvcc`` call
  (:func:`build`, loaded by :func:`library`);
- the host ops of the mold and unmold: ``csrc/host_ops.cc`` by ``g++``
  with OpenMP (:func:`build_host`, loaded by ``native.py``).  It needs no
  CUDA toolkit, so the CPU tests build it too.

A library's file name carries a hash of its sources and flags (for the
host library, also of the CPU: ``-march=native`` code is host-specific),
so a changed source or another CPU builds a new library and an unchanged
one is loaded as it is.  A build writes a temporary file and renames it
into place: there is no lock file to wait on, and two processes that
build at once both end with a whole library.  A missing compiler or a
failed compile raises.

Each build happens on first use, inside the call that needs it;
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
HOST_SOURCE = os.path.join(CSRC_DIR, "host_ops.cc")
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
GXX_TIMEOUT_S = 120

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds the last build took in this process (0.0 when the library was
# already on disk), and what ptxas reported for each kernel (registers,
# shared memory, spills); chip_smoke.py prints both
last_build_seconds: Optional[float] = None
last_build_log: str = ""
# the same for the host library (build_host)
last_host_build_seconds: Optional[float] = None


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


def _hashed_path(stem: str, flags, srcs: List[str], extra: str = "") -> str:
    h = hashlib.sha256(extra.encode() + b"\0")
    for flag in flags:
        h.update(flag.encode() + b"\0")
    for path in srcs:
        h.update(os.path.basename(path).encode() + b"\0")
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def library_path(srcs: List[str]) -> str:
    return _hashed_path("libcfun_kernels", NVCC_FLAGS, srcs)


def nvcc_command(nvcc: str, srcs: List[str], out: str) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", out, *srcs]


def _compile(command, out: str, timeout: int) -> str:
    """Run ``command(tmp)``, which writes a library to ``tmp``, and rename
    the library to ``out``; returns the compiler's stderr."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = command(tmp)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(cmd[0])} failed with exit code "
                f"{proc.returncode}:\n"
                f"{proc.stderr.strip() or proc.stdout.strip()}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return proc.stderr


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
    t0 = time.perf_counter()
    last_build_log = _compile(lambda tmp: nvcc_command(nvcc, srcs, tmp),
                              out, NVCC_TIMEOUT_S)
    last_build_seconds = time.perf_counter() - t0
    return out


def cpu_fingerprint() -> str:
    """Identifies the host's CPU model and instruction-set flags, which
    ``-march=native`` code depends on: a library built on another CPU
    either runs slower generic code or traps on an instruction this CPU
    lacks."""
    try:
        model, flags = "", ""
        with open("/proc/cpuinfo") as f:
            for line in f:
                # x86: 'model name'/'flags'; ARM: 'Processor'|'CPU part'
                # and 'Features'
                if not model and line.startswith(
                        ("model name", "Processor", "CPU part")):
                    model = line.split(":", 1)[1].strip()
                elif not flags and line.startswith(("flags", "Features")):
                    flags = line.split(":", 1)[1].strip()
                if model and flags:
                    break
        if not model and not flags:
            raise OSError("unrecognized /proc/cpuinfo field names")
        return hashlib.sha256(f"{model}|{flags}".encode()).hexdigest()[:16]
    except OSError:
        import platform
        return f"{platform.machine()}-{platform.processor()}"


def host_library_path() -> str:
    return _hashed_path("libcfun_host", GXX_FLAGS, [HOST_SOURCE],
                        extra=cpu_fingerprint())


def find_gxx() -> str:
    """Path of ``g++`` on PATH.  Raises when there is none."""
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError(
            "g++ not found on PATH: the port's host ops (mold and unmold) "
            "are built from cfun_tpu_torch/csrc/host_ops.cc at first use; "
            "Detector(..., native=False) molds with NumPy instead")
    return found


def build_host() -> str:
    """Compile ``csrc/host_ops.cc`` with ``g++`` unless its library for
    this CPU is already on disk; returns the library's path."""
    global last_host_build_seconds
    out = host_library_path()
    if os.path.exists(out):
        last_host_build_seconds = 0.0
        return out
    gxx = find_gxx()
    t0 = time.perf_counter()
    _compile(lambda tmp: [gxx, *GXX_FLAGS, "-o", tmp, HOST_SOURCE], out,
             GXX_TIMEOUT_S)
    last_host_build_seconds = time.perf_counter() - t0
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
