"""Builds the CUDA kernels in ``csrc/`` at first use and loads them.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, which ``ctypes`` loads; no
PyTorch header is included, so a build takes seconds. The library lands in
``_build_out/`` beside this file (git-ignored), named by a digest of its
source and of every shared header (``csrc/*.cuh``), so an edited source or
header is rebuilt and an unchanged one is reused. The compiler's output
(ptxas's registers and spills) lands beside the library under the same
name, so it always belongs to the build it sits next to.
``build_all`` starts one ``nvcc`` per source, all at once, waits for them
together and says which sources it compiled. It holds a file lock on
``_build_out/`` while it does, and each library and log lands by
``os.replace``, so processes that load the kernels at once (a driver and its
GPU workers) build each source once and never load a half-written library.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
OUT = Path(__file__).resolve().parent / "_build_out"
SOURCES = ("flash_fwd", "flash_bwd", "paged_decode", "moe_gemm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return OUT / f"lib{name}-{h.hexdigest()[:12]}.so"


def log_path(name: str) -> Path:
    """The compiler's output (ptxas register / shared-memory report) of the
    build of the current sources; it exists once they have been compiled."""
    return _target(name).with_suffix(".log")


def _start(name: str):
    """Starts nvcc for one source unless its library is already built.
    Returns (process, tmp, target) or None."""
    target = _target(name)
    if target.exists():
        return None
    OUT.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".so.tmp{os.getpid()}")
    log = open(f"{tmp}.log", "w")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=log, stderr=subprocess.STDOUT,
    )
    log.close()
    return proc, tmp, target


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, target = started
    code = proc.wait()
    os.replace(f"{tmp}.log", log_path(name))
    if code != 0:
        raise KernelBuildError(f"nvcc failed for {name}.cu:\n{log_path(name).read_text()}")
    os.replace(tmp, target)


def build_all(names=SOURCES) -> tuple[str, ...]:
    """Compiles every named source that is not built yet, in parallel;
    returns the names it compiled (not those already built)."""
    OUT.mkdir(parents=True, exist_ok=True)
    with _lock, open(OUT / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        started = {n: _start(n) for n in names if n not in _libs}
        errors = []
        for n, s in started.items():
            try:
                _finish(n, s)
            except KernelBuildError as e:
                errors.append(str(e))
        if errors:
            raise KernelBuildError("\n".join(errors))
        return tuple(n for n, s in started.items() if s is not None)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]

