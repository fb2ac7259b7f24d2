"""Sanitizer builds of the port's C++ store (``ray_tpu_torch/core/native``;
the cases of ``tests/test_sanitizers.py``, built from the port's own
``shm_store.cpp`` and ``shm_store_stress.cpp``, never under ``ray_tpu/``).

Sanitizer builds of the C++ store (reference: TSAN/ASAN Bazel configs,
.bazelrc:112-133 — the native store is where a data race would silently
corrupt user payloads). Compiles the stress harness under ASan+UBSan and
TSan and runs it; sanitizer reports fail the test via nonzero exit."""
import os
import subprocess

import pytest

NATIVE = os.path.join(os.path.dirname(__file__), "..", "ray_tpu_torch", "core", "native")
SRC = [os.path.join(NATIVE, "shm_store.cpp"), os.path.join(NATIVE, "shm_store_stress.cpp")]


def _build_and_run(tag: str, san_flags: list[str], env=None):
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    out = os.path.join(NATIVE, f"_stress_{tag}")
    if not os.path.exists(out) or any(
        os.path.getmtime(s) > os.path.getmtime(out) for s in SRC
    ):
        cmd = ["g++", "-std=c++17", "-O1", "-g", "-fno-omit-frame-pointer",
               *san_flags, *SRC, "-o", out, "-lpthread"]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            pytest.fail(f"{tag} build failed:\n{res.stderr[-3000:]}")
    run_env = {**os.environ, **(env or {})}
    res = subprocess.run([out], capture_output=True, text=True, timeout=600, env=run_env)
    assert res.returncode == 0, (
        f"{tag} stress failed (rc={res.returncode}):\n"
        f"{res.stdout[-1000:]}\n{res.stderr[-4000:]}"
    )
    assert "stress ok" in res.stdout


def test_store_stress_asan():
    _build_and_run(
        "asan",
        ["-fsanitize=address,undefined"],
        env={"ASAN_OPTIONS": "detect_leaks=0"},  # arena handles freed at exit
    )


def test_store_stress_tsan():
    _build_and_run("tsan", ["-fsanitize=thread"])
