"""Builds the native C++ components into shared libraries, lazily and cached.

The reference builds its native core with Bazel; here each component is a
single translation unit compiled with g++ at first use (cached by source
mtime), which keeps the repo hermetic with no install step.
"""
from __future__ import annotations

import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_lock = threading.Lock()


def build_lib(name: str, extra_flags: list[str] | None = None) -> str:
    """Compile ``<name>.cpp`` in this directory -> ``_<name>.so``; return path."""
    src = os.path.join(_DIR, f"{name}.cpp")
    out = os.path.join(_DIR, f"_{name}.so")
    with _lock:
        if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
            return out
        tmp = out + f".tmp{os.getpid()}"
        cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", tmp, src, "-lpthread"]
        cmd += extra_flags or []
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    return out
