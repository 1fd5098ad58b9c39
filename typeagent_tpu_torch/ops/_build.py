"""Builds and loads the package's native code at first use.

The CUDA kernels (``csrc/*.cu``) compile with ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, loaded through ``ctypes``.
Nothing is built at import time: the first launch builds, under a file
lock so that concurrent processes (test workers, a server's replicas)
build once; each compile unit (a source, or one part of ``topk.cu``, the
longest) compiles in its own ``nvcc`` process, all started together, and
the objects link into the library. A store made on a CUDA device starts
the build in the background (:func:`start_building`), so that it runs
while the store is filled and not in front of the first search. Outputs go
to ``typeagent_tpu_torch/_build/``, named by a hash of their sources and
flags, so an edited source rebuilds.
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

KERNEL_SOURCES = ("topk.cu", "bucket_maxima.cu", "rescore.cu", "tile_list.cu", "topk_narrow.cu")
# Compile units: (source, its own flags). topk.cu compiles in four parts
# (its TOPK_PART), each no longer than bucket_maxima.cu alone.
KERNEL_UNITS = tuple(
    [("topk.cu", (f"-DTOPK_PART={part}",)) for part in range(4)]
    + [(source, ()) for source in KERNEL_SOURCES[1:]]
)
KERNEL_HEADERS = ("tile.cuh", "mma_tile.cuh", "wgmma_tile.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_kernels: ctypes.CDLL | None = None
_builder: threading.Thread | None = None
_builder_lock = threading.Lock()  # not _lock, which the build holds throughout


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


def _run_all(commands: list[list[str]], what: str) -> None:
    """Run the commands at once and wait for all of them; raise
    ``RuntimeError`` with the output of the first that failed."""
    procs = [
        subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, errors="replace"
        )
        for cmd in commands
    ]
    failed = None
    for cmd, proc in zip(commands, procs):
        out, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = f"building {what} failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}"
    if failed is not None:
        raise RuntimeError(failed)


def build_shared(
    name: str, sources: list[str | tuple[str, tuple[str, ...]]], headers: list[str],
    command: list[str],
) -> str:
    """Build ``command + ['-o', out] + sources`` once per content hash.

    A source is a path, or ``(path, flags)`` for a compile unit with flags
    of its own (one path may appear in several units). Several units
    compile to objects in parallel (one compiler process each, ``command``
    without ``-shared``, plus the unit's flags and ``-c``), then link.
    Returns the library path. The build runs under an exclusive file lock
    and lands through an atomic rename, so a reader never sees a
    half-written library. Raises ``RuntimeError`` with the compiler's
    output on failure.
    """
    units = [(s, ()) if isinstance(s, str) else (s[0], tuple(s[1])) for s in sources]
    digest = hashlib.sha256()
    for path in [u[0] for u in units] + list(headers):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(command).encode())
    for _path, flags in units:
        digest.update(" ".join(flags).encode())
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
            objects = [f"{tmp}.{i}.o" for i in range(len(units))] if len(units) > 1 else []
            try:
                if objects:
                    compile_only = [c for c in command if c != "-shared"]
                    _run_all(
                        [compile_only + [*flags, "-c", "-o", obj, src]
                         for obj, (src, flags) in zip(objects, units)],
                        name,
                    )
                    _run_all([list(command) + ["-o", tmp] + objects], name)
                else:
                    src, flags = units[0]
                    _run_all([list(command) + [*flags, "-o", tmp, src]], name)
            finally:
                for obj in objects:
                    if os.path.exists(obj):
                        os.remove(obj)
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)
    return out


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # Every top-k scan takes (emb, dtype code or scales, q, n_rows, d_pad,
    # b, count, k, rows_per_split, splits, query_block, <filter operands>,
    # cand_vals, cand_idx, stream); the scoped scans' filter operands end
    # with the tile list and its device count (K4: the interval table and
    # its rows first; K5 and K7: the mask).
    geometry = [p, i64, i32, i32, i64, i32, i64, i32, i32]
    tail = [p, p, p]
    signatures = {
        "tat_topk_scan": [p, i32, *geometry, *tail],
        "tat_topk_scan_iv": [p, i32, *geometry, p, i32, p, p, *tail],
        "tat_topk_scan_mask": [p, i32, *geometry, p, p, p, *tail],
        "tat_topk_scan_q": [p, p, *geometry, *tail],
        "tat_topk_scan_mq": [p, p, *geometry, p, p, p, *tail],
        # K6 and K7 at b <= 16 (topk_narrow.cu): q is the permuted query block.
        "tat_topk_scan_q_narrow": [p, p, *geometry, *tail],
        "tat_topk_scan_mq_narrow": [p, p, *geometry, p, p, p, *tail],
        # (width, query_block, *warps, *stages) -> shared memory bytes or -1
        "tat_topk_narrow_plan": [i32, i32, p, p],
        "tat_topk_merge": [p, p, i32, i32, i32, p, p, p],
        # (..., count, buckets_per_cta, ctas_per_qb[, query_block], out, ...)
        "tat_bucket_maxima": [p, i32, p, i64, i32, i32, i64, i64, i32, i32, p, p, p],
        # (emb, kind, scales, q, n_rows, width, live, b, count, ...)
        "tat_bucket_maxima_q": [p, i32, p, p, i64, i32, i32, i32, i64, i64, i32, p, p],
        "tat_rescore": [p, i32, p, p, i64, i32, i32, i32, p, p],
        # The scoped scans' tile lists: (table, rows, count | mask, count,
        # scratch words), then tiles, n_tiles, stream.
        "tat_interval_tiles": [p, i32, i64, p, p, p],
        "tat_scope_tiles": [p, i64, p, p, p, p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
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
                [(os.path.join(CSRC_DIR, s), flags) for s, flags in KERNEL_UNITS],
                [os.path.join(CSRC_DIR, h) for h in KERNEL_HEADERS],
                [find_nvcc(), *NVCC_FLAGS, f"-I{CSRC_DIR}"],
            )
            _kernels = _declare(ctypes.CDLL(path))
    return _kernels


def start_building() -> None:
    """Start :func:`kernels` on a daemon thread, once per process, and
    return at once. The compilers run while the caller goes on (a store
    being filled); the first launch then waits in :func:`kernels` only for
    what is left. A failed build is left for that call to raise again."""
    global _builder
    with _builder_lock:
        if _kernels is not None or _builder is not None:
            return
        _builder = threading.Thread(target=_build_quietly, name="tat-kernels-build", daemon=True)
        _builder.start()


def _build_quietly() -> None:
    try:
        kernels()
    except Exception:  # noqa: BLE001 - the first launch builds again and raises
        pass


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError_t {rc})")
