"""ray_tpu_torch.data: lazy, streaming datasets over the port's shared-memory
object store (counterpart of ``ray_tpu.data``, with the same ``__all__``).

Reference surface: ray.data (python/ray/data/__init__.py) — Dataset +
read_* constructors + from_* converters; execution is streaming
(StreamingExecutor) on the port's runtime (``ray_tpu_torch.core``) with
blocks as Arrow tables in the object store. A map_batches UDF may return
torch tensor columns (CPU or CUDA; they land in the block on the host);
``prefetch_to_device`` feeds batches to the GPU on a side stream. Not
exposed at the package's top level: ``import ray_tpu_torch.data as rd``.
"""
from ray_tpu_torch.data.dataset import (
    DataIterator,
    Dataset,
    GroupedData,
    batches_from_blocks,
    from_arrow,
    from_blocks,
    from_items,
    from_numpy,
    from_pandas,
    range,
    range_tensor,
    read_binary_files,
    read_csv,
    read_json,
    read_numpy,
    read_parquet,
    read_text,
)
from ray_tpu_torch.data.infeed import prefetch_to_device

__all__ = [
    "DataIterator",
    "Dataset",
    "GroupedData",
    "batches_from_blocks",
    "from_arrow",
    "from_blocks",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "range_tensor",
    "read_binary_files",
    "read_csv",
    "read_json",
    "read_numpy",
    "read_parquet",
    "read_text",
    "prefetch_to_device",
]
