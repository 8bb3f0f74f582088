"""Build the port's native loader library with ``g++`` at first use; load
it with ctypes.

``sav_tpu_torch/native/loader.cc``, ``records.cc`` and ``tfrecord.cc`` (with
``parallel_for.h``) compile together into
``build/sav_tpu_torch/libsav_loader-<hash>.so`` (``build/`` is
git-ignored). The hash covers the sources and the flags, so an edited
source rebuilds and an unchanged one is reused; a build writes a temporary
file and renames it, so processes that build at once do not collide.
Nothing is built while a module is imported: :func:`load` builds when the
loader is first used, and a failed build raises with the compiler's
stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

NATIVE = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sav_tpu_torch"
SOURCES = ("loader.cc", "records.cc", "tfrecord.cc")
HEADERS = ("parallel_for.h",)
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-pthread", "-std=c++17", "-Wall", "-ffp-contract=off")
ABI_VERSION = 1

_LOCK = threading.Lock()
_LIB = None


def find_cxx() -> str:
    for candidate in (os.environ.get("CXX"), "g++", "c++"):
        path = candidate and shutil.which(candidate)
        if path:
            return path
    raise RuntimeError("no C++ compiler (g++) on PATH; the native loader builds with it "
                       "at first use")


def library_path() -> Path:
    digest = hashlib.sha256()
    for name in (*SOURCES, *HEADERS):
        digest.update(name.encode() + b"\0" + (NATIVE / name).read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libsav_loader-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """The library's path, compiled first if it is missing."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [find_cxx(), *CXX_FLAGS, "-o", str(tmp), *(str(NATIVE / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the native loader failed to build (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, target)
    return target


def load() -> ctypes.CDLL:
    """The loaded library, built first if missing; its ABI version is
    checked."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.sav_loader_abi_version.restype = ctypes.c_int
            version = lib.sav_loader_abi_version()
            if version != ABI_VERSION:
                raise RuntimeError(f"native loader ABI version {version}, expected "
                                   f"{ABI_VERSION}")
            _LIB = lib
        return _LIB
