"""Datasources: file readers/writers producing/consuming Arrow blocks.

Role-equivalent to the reference's datasource layer
(python/ray/data/_internal/datasource/ — parquet, csv, json,
text, binary, images...). Readers return zero-arg callables (one per file /
split) that the streaming executor runs as remote tasks.
"""
from __future__ import annotations

import glob as _glob
import os
from typing import Callable, Optional

from ray_tpu_torch.data import block as B


def _expand(paths) -> list[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if not f.startswith(".")
            ))
        elif any(c in p for c in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths}")
    return out


def parquet_read_fns(paths) -> list[Callable]:
    def make(path):
        def read():
            import pyarrow.parquet as pq

            return pq.read_table(path)
        return read
    return [make(p) for p in _expand(paths)]


def csv_read_fns(paths) -> list[Callable]:
    def make(path):
        def read():
            import pyarrow.csv as pacsv

            return pacsv.read_csv(path)
        return read
    return [make(p) for p in _expand(paths)]


def json_read_fns(paths) -> list[Callable]:
    def make(path):
        def read():
            import pyarrow.json as pajson

            return pajson.read_json(path)
        return read
    return [make(p) for p in _expand(paths)]


def text_read_fns(paths) -> list[Callable]:
    def make(path):
        def read():
            with open(path) as f:
                lines = [{"text": ln.rstrip("\n")} for ln in f]
            return B.block_from_rows(lines)
        return read
    return [make(p) for p in _expand(paths)]


def binary_read_fns(paths) -> list[Callable]:
    def make(path):
        def read():
            with open(path, "rb") as f:
                return B.block_from_rows([{"bytes": f.read(), "path": path}])
        return read
    return [make(p) for p in _expand(paths)]


def numpy_read_fns(paths) -> list[Callable]:
    def make(path):
        def read():
            import numpy as np

            arr = np.load(path)
            return B.block_from_batch({"data": arr})
        return read
    return [make(p) for p in _expand(paths)]


# -- writers (run as remote tasks, one file per block) ----------------------

def write_parquet_block(blk, dir_path: str, index: int) -> str:
    import pyarrow.parquet as pq

    os.makedirs(dir_path, exist_ok=True)
    path = os.path.join(dir_path, f"part-{index:05d}.parquet")
    pq.write_table(blk, path)
    return path


def write_csv_block(blk, dir_path: str, index: int) -> str:
    import pyarrow.csv as pacsv

    os.makedirs(dir_path, exist_ok=True)
    path = os.path.join(dir_path, f"part-{index:05d}.csv")
    pacsv.write_csv(blk, path)
    return path


def write_json_block(blk, dir_path: str, index: int) -> str:
    import json

    os.makedirs(dir_path, exist_ok=True)
    path = os.path.join(dir_path, f"part-{index:05d}.jsonl")
    with open(path, "w") as f:
        for row in B.block_rows(blk):
            f.write(json.dumps(row) + "\n")
    return path
