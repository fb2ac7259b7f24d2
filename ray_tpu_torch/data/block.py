"""Blocks: the unit of data flow — pyarrow Tables in the object store.

Role-equivalent to the reference's block model (ray.data blocks are Arrow
tables in plasma; SURVEY.md §2.4 Data row). Batch formats mirror the
reference's map_batches contract: "numpy" (dict of ndarrays), "pandas",
"pyarrow", or "rows" (list of dicts).

The port's one seam (``block_from_batch``): a map_batches UDF may return a
dict of ``torch.Tensor`` columns, CPU or CUDA, as a numpy UDF returns
ndarrays. A CUDA column is copied to the host explicitly, and bf16 (which
has no numpy or Arrow type) is carried as fp32. A tensor anywhere else (a
row's value, a list of tensors) is refused, as the reference refuses a
device array there.
"""
from __future__ import annotations

from typing import Any, Iterable, Optional

import numpy as np
import pyarrow as pa

from ray_tpu_torch.util.dtypes import is_tensor as _is_tensor

Block = pa.Table


def block_from_rows(rows: list) -> Block:
    """Rows: dicts -> columnar table; scalars -> single 'item' column."""
    if not rows:
        return pa.table({})
    if isinstance(rows[0], dict):
        cols: dict[str, list] = {k: [] for k in rows[0]}
        for r in rows:
            for k in cols:
                cols[k].append(r.get(k))
        return pa.table({k: _to_array(v) for k, v in cols.items()})
    return pa.table({"item": _to_array(list(rows))})


def _to_array(values: list) -> pa.Array:
    if values and _is_tensor(values[0]):
        raise TypeError(
            "a torch.Tensor inside a row or a list: return a dict of tensor "
            "columns from map_batches, or convert it to numpy first"
        )
    if values and isinstance(values[0], np.ndarray):
        # Tensor column: fixed-shape ndarrays stored as lists (reference uses
        # an ArrowTensorArray extension; plain lists keep us dependency-lean).
        return pa.array([v.tolist() for v in values])
    return pa.array(values)


def block_from_batch(batch: Any) -> Block:
    """Accept whatever a map_batches UDF returned."""
    if isinstance(batch, pa.Table):
        return batch
    if isinstance(batch, dict):
        batch = {k: _tensor_column(v) if _is_tensor(v) else v for k, v in batch.items()}
        return pa.table({k: _to_array(list(v) if isinstance(v, np.ndarray) else v)
                         for k, v in batch.items()})
    if _is_pandas(batch):
        return pa.Table.from_pandas(batch, preserve_index=False)
    if isinstance(batch, list):
        return block_from_rows(batch)
    raise TypeError(f"unsupported batch type {type(batch)}")


def _tensor_column(t) -> np.ndarray:
    """A torch tensor column -> a host ndarray: CUDA tensors are copied to
    the host here (one synchronous D2H copy), bf16 becomes fp32 (exact)."""
    import torch

    t = t.detach()
    if t.device.type != "cpu":
        t = t.to("cpu")
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.resolve_conj().resolve_neg().numpy()


def _is_pandas(x) -> bool:
    try:
        import pandas as pd

        return isinstance(x, pd.DataFrame)
    except ImportError:
        return False


def block_to_batch(block: Block, batch_format: str = "numpy") -> Any:
    if batch_format in ("pyarrow", "arrow"):
        return block
    if batch_format == "pandas":
        return block.to_pandas()
    if batch_format == "numpy":
        return {name: _col_to_numpy(col) for name, col in
                zip(block.column_names, block.columns)}
    if batch_format in ("rows", "default"):
        return block.to_pylist()
    raise ValueError(f"unknown batch_format {batch_format!r}")


def _col_to_numpy(col: "pa.ChunkedArray") -> np.ndarray:
    """Dtype-preserving column -> ndarray (no per-value Python boxing).

    Fixed-size tensor columns (lists of equal-length lists) come back as a
    stacked [rows, ...] ndarray rather than an object array.
    """
    col = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    if _is_list_type(col.type):
        arr = _tensor_col_to_numpy(col)
        if arr is not None:
            return arr
        values = col.to_pylist()
        try:
            return np.asarray(values)  # ragged -> ValueError / object array
        except ValueError:
            out = np.empty(len(values), dtype=object)
            out[:] = values
            return out
    try:
        return col.to_numpy(zero_copy_only=False)
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
        return np.asarray(col.to_pylist())


def _is_list_type(typ) -> bool:
    return (pa.types.is_list(typ) or pa.types.is_large_list(typ)
            or pa.types.is_fixed_size_list(typ))


def _tensor_col_to_numpy(col: "pa.Array") -> Optional[np.ndarray]:
    """Uniform N-D tensor column -> stacked ndarray without Python boxing.

    Unnests every list level (flatten() respects slice offsets), verifying
    per-level uniform widths and absence of nulls; returns None for anything
    ragged or nulled (caller falls back to the boxed path).
    """
    shape = [len(col)]
    arr = col
    while _is_list_type(arr.type):
        if arr.null_count:
            return None
        typ = arr.type
        if pa.types.is_fixed_size_list(typ):
            width = typ.list_size
        else:
            offsets = arr.offsets.to_numpy(zero_copy_only=False)
            widths = np.diff(offsets)
            if len(widths) == 0 or not (widths == widths[0]).all():
                return None
            width = int(widths[0])
        shape.append(width)
        arr = arr.flatten()
    if arr.null_count:
        return None
    try:
        flat = arr.to_numpy(zero_copy_only=False)
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
        return None
    if flat.dtype == object:
        return None
    return flat.reshape(shape)


def block_rows(block: Block) -> list[dict]:
    return block.to_pylist()


def block_num_rows(block: Block) -> int:
    return block.num_rows


def block_slice(block: Block, start: int, end: int) -> Block:
    return block.slice(start, end - start)


def block_take(block: Block, indices: "np.ndarray") -> Block:
    return block.take(pa.array(indices))


def concat_blocks(blocks: Iterable[Block]) -> Block:
    blocks = [b for b in blocks if b.num_rows > 0]
    if not blocks:
        return pa.table({})
    return pa.concat_tables(blocks, promote_options="default")


def block_size_bytes(block: Block) -> int:
    return block.nbytes
