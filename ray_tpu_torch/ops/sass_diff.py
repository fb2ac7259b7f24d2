"""Compares the machine code of two builds of the kernels, function by function.

    python3 -m ray_tpu_torch.ops.sass_diff OLD_ROOT [NEW_ROOT]

Each ROOT is a directory holding a ``ray_tpu_torch`` package (NEW_ROOT
defaults to the checkout this module is in), for example an older commit
unpacked with ``git archive <commit> ray_tpu_torch | tar -x -C DIR``.
Each tree's ``_build.build_all`` builds its own sources into its own
``_build_out``; then ``cuobjdump -sass`` of each library is split into its
kernel functions. Functions are keyed by kernel name and template argument
(``flash_fwd_kernel<64>``), so the anonymous namespace's per-file hash in
the mangled name does not count, and each line's whitespace is collapsed
(cuobjdump pads its columns per listing, so raw text differs even between
identical functions). Prints one line per function:

    flash_bwd: flash_bwd_dkv_kernel<64>: 4162 / 4162 lines, identical True

with the first differing lines under a function that differs, and
"only in old" / "only in new" for instances one tree lacks. Exits 1 if a
function both trees have differs. Needs ``nvcc`` and ``cuobjdump`` (CUDA
toolkit) but no GPU.
"""
from __future__ import annotations

import argparse
import difflib
import importlib.util
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
# The length-prefixed name, its int argument and an optional bool one: an
# instance whose bool is false keeps the key of the kernel before the bool
# was added (``flash_fwd_kernel<128, false>`` is ``flash_fwd_kernel<128>``).
_KEY = re.compile(r"\d+([a-z][a-z_]*_kernel)ILi(\d+)E(?:Lb([01])E)?")
_ANON = re.compile(r"_INTERNAL_\w+")


def _cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.exists(cand):
            return cand
    raise SystemExit("cuobjdump not found (PATH or /usr/local/cuda/bin)")


def _build(root: Path, tag: str):
    """Loads ROOT's ray_tpu_torch/ops/_build.py under its own name, builds
    every source and returns the module."""
    path = root / "ray_tpu_torch" / "ops" / "_build.py"
    spec = importlib.util.spec_from_file_location(f"_sass_diff_build_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build_all()
    return mod


def functions(lib: Path) -> dict[str, list[str]]:
    """{kernel<arg>: normalised SASS lines} of one shared library."""
    text = subprocess.run([_cuobjdump(), "-sass", str(lib)], check=True, capture_output=True, text=True).stdout
    out: dict[str, list[str]] = {}
    cur = None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            k = _KEY.search(m.group(1))
            cur = (f"{k.group(1)}<{k.group(2)}{', true' if k.group(3) == '1' else ''}>" if k
                   else _ANON.sub("ANON", m.group(1)))
            out[cur] = []
            continue
        if cur is None:
            continue
        norm = " ".join(_ANON.sub("ANON", line).split())
        if norm.startswith("....."):  # the end of the function's listing
            cur = None
        elif norm:
            out[cur].append(norm)
    return out


def compare(old_root: Path, new_root: Path) -> int:
    old_b, new_b = _build(old_root, "old"), _build(new_root, "new")
    differs = 0
    for name in new_b.SOURCES:
        old_f = functions(old_b._target(name)) if name in old_b.SOURCES else {}
        new_f = functions(new_b._target(name))
        for fn in sorted(set(old_f) | set(new_f)):
            if fn not in new_f:
                print(f"{name}: {fn}: only in old ({len(old_f[fn])} lines)")
            elif fn not in old_f:
                print(f"{name}: {fn}: only in new ({len(new_f[fn])} lines)")
            else:
                same = old_f[fn] == new_f[fn]
                differs += not same
                print(f"{name}: {fn}: {len(old_f[fn])} / {len(new_f[fn])} lines, identical {same}")
                if not same:
                    diff = difflib.unified_diff(old_f[fn], new_f[fn], "old", "new", n=1, lineterm="")
                    for line in list(diff)[:24]:
                        print(f"    {line}")
    return 1 if differs else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_root", type=Path)
    ap.add_argument("new_root", type=Path, nargs="?", default=Path(__file__).resolve().parents[2])
    args = ap.parse_args(argv)
    return compare(args.old_root.resolve(), args.new_root.resolve())


if __name__ == "__main__":
    sys.exit(main())
