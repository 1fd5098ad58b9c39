"""Loader for the native result materializer.

``native/results.cpp`` (shared with the JAX package) is a CPython extension
that turns fetched ``[b, k]`` score and ordinal arrays into lists of
``ScoredInt`` records in one C pass. It is host code, not a device kernel.
It is built with the host C++ compiler at first use into the package's
build directory; when no compiler or headers are available this returns
None and the store keeps its pure-Python materializer.
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
import types

from .ops import _build

_RESULTS_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native",
    "results.cpp",
)
_lock = threading.Lock()
_results_mod: types.ModuleType | None = None
_results_attempted = False


def _cxx_command() -> list[str] | None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
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
