"""Loaders for the package's native host code (not device kernels).

* ``native/results.cpp`` (shared with the JAX package) is a CPython
  extension that turns fetched ``[b, k]`` score and ordinal arrays into
  lists of ``ScoredInt`` records in one C pass; without a compiler or
  headers the store keeps its pure-Python materializer.
* ``native/interner.cpp`` is the string interner and CSR posting layout
  behind the device query engine (``ops/postings.py``), bound by ctypes as
  :class:`NativeInterner`; without a compiler :func:`create_interner`
  returns :class:`PyInterner`, which gives the same ids and CSR.

Both are built with the host C++ compiler at first use into the package's
build directory (``ops/_build.build_shared``), never at import.
"""

from __future__ import annotations

import ctypes
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
import types

import numpy as np

from .ops import _build

_RESULTS_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native",
    "results.cpp",
)
_INTERNER_SRC = os.path.join(os.path.dirname(_RESULTS_SRC), "interner.cpp")
_lock = threading.Lock()
_results_mod: types.ModuleType | None = None
_results_attempted = False
_interner_lib: ctypes.CDLL | None = None
_interner_attempted = False


def _cxx_command(python_headers: bool = True) -> list[str] | None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    includes = []
    if python_headers:
        paths = sysconfig.get_paths()
        includes = sorted({p for p in (paths.get("include"), paths.get("platinclude")) if p})
    return [cxx, "-O3", "-fPIC", "-std=c++17", "-shared", *(f"-I{p}" for p in includes)]


def load_results_module() -> types.ModuleType | None:
    """The tat_results extension, or None when it cannot be built."""
    global _results_mod, _results_attempted
    if _results_mod is not None or _results_attempted:
        return _results_mod
    with _lock:
        if _results_attempted:
            return _results_mod
        _results_attempted = True
        command = _cxx_command()
        if command is None or not os.path.exists(_RESULTS_SRC):
            return None
        try:
            path = _build.build_shared("tat_results", [_RESULTS_SRC], [], command)
        except (RuntimeError, OSError, subprocess.SubprocessError):
            return None
        loader = importlib.machinery.ExtensionFileLoader("tat_results", path)
        spec = importlib.util.spec_from_loader("tat_results", loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
        _results_mod = mod
        return _results_mod


def _declare_interner(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    signatures = {
        "tat_interner_new": ([], p),
        "tat_interner_free": ([p], None),
        "tat_intern": ([p, ctypes.c_char_p, i64], i32),
        "tat_lookup": ([p, ctypes.c_char_p, i64], i32),
        "tat_interner_size": ([p], i64),
        "tat_postings_add": ([p, i32, i32, ctypes.c_float], None),
        "tat_postings_size": ([p], i64),
        "tat_postings_build_csr": ([p, p, p, p], None),
        "tat_intern_batch": ([p, ctypes.c_char_p, p, i64, p], None),
        "tat_postings_add_batch": ([p, p, p, p, i64], None),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def load_interner_library() -> ctypes.CDLL | None:
    """The interner library built from ``native/interner.cpp``, or None
    when no host compiler can build it."""
    global _interner_lib, _interner_attempted
    if _interner_lib is not None or _interner_attempted:
        return _interner_lib
    with _lock:
        if _interner_attempted:
            return _interner_lib
        _interner_attempted = True
        command = _cxx_command(python_headers=False)
        if command is None or not os.path.exists(_INTERNER_SRC):
            return None
        try:
            path = _build.build_shared("tat_interner", [_INTERNER_SRC], [], command)
        except (RuntimeError, OSError, subprocess.SubprocessError):
            return None
        _interner_lib = _declare_interner(ctypes.CDLL(path))
        return _interner_lib


def native_available() -> bool:
    return load_interner_library() is not None


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


class NativeInterner:
    """C++ interner + posting accumulator (terms lowercased on intern)."""

    def __init__(self) -> None:
        lib = load_interner_library()
        if lib is None:
            raise RuntimeError("native interner unavailable: no host C++ compiler built it")
        self._lib = lib
        self._handle = lib.tat_interner_new()

    def __del__(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.tat_interner_free(self._handle)
            self._handle = None

    def intern(self, term: str) -> int:
        data = term.lower().encode("utf-8")
        return self._lib.tat_intern(self._handle, data, len(data))

    def lookup(self, term: str) -> int:
        data = term.lower().encode("utf-8")
        return self._lib.tat_lookup(self._handle, data, len(data))

    def __len__(self) -> int:
        return self._lib.tat_interner_size(self._handle)

    def add_posting(self, term_id: int, semref_id: int, score: float = 1.0) -> None:
        self._lib.tat_postings_add(self._handle, term_id, semref_id, score)

    def intern_batch(self, terms: list[str]) -> np.ndarray:
        """Intern many terms in one FFI call."""
        encoded = [t.lower().encode("utf-8") for t in terms]
        starts = np.zeros(len(encoded) + 1, dtype=np.int64)
        np.cumsum([len(e) for e in encoded], out=starts[1:])
        out = np.zeros(len(encoded), dtype=np.int32)
        self._lib.tat_intern_batch(self._handle, b"".join(encoded), _ptr(starts), len(encoded), _ptr(out))
        return out

    def add_postings_batch(self, term_ids: np.ndarray, semref_ids: np.ndarray, scores: np.ndarray) -> None:
        term_ids = np.ascontiguousarray(term_ids, dtype=np.int32)
        semref_ids = np.ascontiguousarray(semref_ids, dtype=np.int32)
        scores = np.ascontiguousarray(scores, dtype=np.float32)
        self._lib.tat_postings_add_batch(
            self._handle, _ptr(term_ids), _ptr(semref_ids), _ptr(scores), len(term_ids)
        )

    def posting_count(self) -> int:
        return self._lib.tat_postings_size(self._handle)

    def build_csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(offsets [terms + 1] i64, semrefs i32, scores f32): postings by
        term id, each term's in the order they were added."""
        offsets = np.zeros(len(self) + 1, dtype=np.int64)
        semrefs = np.zeros(self.posting_count(), dtype=np.int32)
        scores = np.zeros(self.posting_count(), dtype=np.float32)
        self._lib.tat_postings_build_csr(self._handle, _ptr(offsets), _ptr(semrefs), _ptr(scores))
        return offsets, semrefs, scores


class PyInterner:
    """Pure-Python interner with the same surface, ids and CSR."""

    def __init__(self) -> None:
        self._ids: dict[str, int] = {}
        self._postings: list[tuple[int, int, float]] = []

    def intern(self, term: str) -> int:
        key = term.lower()
        ident = self._ids.get(key)
        if ident is None:
            ident = len(self._ids)
            self._ids[key] = ident
        return ident

    def lookup(self, term: str) -> int:
        return self._ids.get(term.lower(), -1)

    def __len__(self) -> int:
        return len(self._ids)

    def add_posting(self, term_id: int, semref_id: int, score: float = 1.0) -> None:
        self._postings.append((term_id, semref_id, score))

    def intern_batch(self, terms: list[str]) -> np.ndarray:
        return np.array([self.intern(t) for t in terms], dtype=np.int32)

    def add_postings_batch(self, term_ids: np.ndarray, semref_ids: np.ndarray, scores: np.ndarray) -> None:
        for tid, sid, score in zip(term_ids, semref_ids, scores):
            self._postings.append((int(tid), int(sid), float(score)))

    def posting_count(self) -> int:
        return len(self._postings)

    def build_csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        n_terms = len(self._ids)
        if not self._postings:
            return np.zeros(n_terms + 1, np.int64), np.zeros(0, np.int32), np.zeros(0, np.float32)
        term_ids, semrefs, scores = (np.array(col) for col in zip(*self._postings))
        order = np.argsort(term_ids, kind="stable")  # by term, insertion order within
        offsets = np.zeros(n_terms + 1, dtype=np.int64)
        np.cumsum(np.bincount(term_ids, minlength=n_terms), out=offsets[1:])
        return offsets, semrefs[order].astype(np.int32), scores[order].astype(np.float32)


def create_interner() -> NativeInterner | PyInterner:
    """Native when buildable, Python otherwise."""
    if native_available():
        return NativeInterner()
    return PyInterner()
