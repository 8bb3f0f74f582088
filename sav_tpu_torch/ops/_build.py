"""Build the port's CUDA sources with ``nvcc`` at first use; load with ctypes.

Each ``sav_tpu_torch/csrc/<name>.cu`` compiles on its own into
``build/sav_tpu_torch/lib<name>-<hash>.so`` (``build/`` is git-ignored), with
a plain C interface and no PyTorch headers, so one source builds in seconds.
The hash covers the source, the shared ``csrc/*.cuh`` headers and the nvcc
flags, so an edited kernel rebuilds and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per missing library, all at once, and
waits for every one; a failed build raises with nvcc's stderr. Nothing is
built while a module is imported: kernel wrappers call :func:`load` when they
first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sav_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into BUILD_LOGS
)

# nvcc's stderr of each build made in this process, by source name.
BUILD_LOGS: dict = {}

_LOCK = threading.Lock()
_LIBS: dict = {}


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for candidate in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if candidate and os.access(candidate, os.X_OK):
            return candidate
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin (default "
        "/usr/local/cuda); the port's CUDA kernels build with it at first use"
    )


def sources() -> list:
    """Kernel source names: the stems of ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256()
    for path in [source, *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """Build every missing library among ``names`` (default: all sources),
    one nvcc each, started together. Returns ``{name: seconds}`` for the
    libraries built by this call."""
    names = sources() if names is None else list(names)
    pending = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        pending[name] = (proc, tmp, target, time.perf_counter())
    built, failures = {}, []
    for name, (proc, tmp, target, t0) in pending.items():
        out, err = proc.communicate()
        BUILD_LOGS[name] = (out + err).strip()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{err}")
            continue
        os.replace(tmp, target)
        built[name] = time.perf_counter() - t0
    if failures:
        raise RuntimeError("\n".join(failures))
    return built


def loaded() -> list:
    """The names of the libraries this process has loaded."""
    with _LOCK:
        return sorted(_LIBS)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib
