"""Builds and loads the package's native code at first use.

The CUDA kernels (``csrc/*.cu``) compile with ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, loaded through ``ctypes``.
Nothing is built at import time: the first launch builds, under a file
lock so that concurrent processes (test workers, a server's replicas)
build once. Outputs go to ``typeagent_tpu_torch/_build/``, named by a hash
of their sources and flags, so an edited source rebuilds.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

KERNEL_SOURCES = ("topk.cu", "bucket_maxima.cu", "rescore.cu")
KERNEL_HEADERS = ("tile.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_kernels: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, PyTorch's idea of it, or ``PATH``."""
    homes = [os.environ.get("CUDA_HOME")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME

        homes.append(CUDA_HOME)
    except ImportError:
        pass
    for home in homes:
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME to a CUDA toolkit (needed to build "
        "the typeagent_tpu_torch kernels for sm_90a)"
    )


def build_shared(
    name: str, sources: list[str], headers: list[str], command: list[str]
) -> str:
    """Build ``command + ['-o', out] + sources`` once per content hash.

    Returns the library path. The compile runs under an exclusive file lock
    and lands through an atomic rename, so a reader never sees a half-
    written library. Raises ``RuntimeError`` with the compiler's output on
    failure.
    """
    digest = hashlib.sha256()
    for path in list(sources) + list(headers):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(command).encode())
    out = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if os.path.exists(out):
                return out
            tmp = f"{out}.{os.getpid()}.tmp"
            proc = subprocess.run(
                list(command) + ["-o", tmp] + list(sources),
                capture_output=True,
                text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {name} failed ({proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)
    return out


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.tat_topk_scan.argtypes = [p, i32, p, i64, i32, i32, i64, i32, i64, i32, p, p, p]
    lib.tat_topk_merge.argtypes = [p, p, i32, i32, i32, p, p, p]
    lib.tat_bucket_maxima.argtypes = [p, i32, p, i64, i32, i32, i64, p, p]
    lib.tat_rescore.argtypes = [p, i32, p, p, i64, i32, i32, i32, p, p]
    for fn in (lib.tat_topk_scan, lib.tat_topk_merge, lib.tat_bucket_maxima, lib.tat_rescore):
        fn.restype = ctypes.c_int
    return lib


def kernels() -> ctypes.CDLL:
    """The CUDA kernel library, built on first call."""
    global _kernels
    if _kernels is not None:
        return _kernels
    with _lock:
        if _kernels is None:
            path = build_shared(
                "tat_kernels",
                [os.path.join(CSRC_DIR, s) for s in KERNEL_SOURCES],
                [os.path.join(CSRC_DIR, h) for h in KERNEL_HEADERS],
                [find_nvcc(), *NVCC_FLAGS, f"-I{CSRC_DIR}"],
            )
            _kernels = _declare(ctypes.CDLL(path))
    return _kernels


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError_t {rc})")
