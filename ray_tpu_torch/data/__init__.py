"""ray_tpu_torch.data — distributed datasets over object-store blocks.

Analog of ``python/ray/data`` (``Dataset`` ``data/dataset.py:139``): read
connectors fan out one task per file, transforms run as tasks or actor
pools over blocks, and ``iter_batches``/``split`` feed training workers.
"""

from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.dataset import ActorPoolStrategy, Dataset, GroupedData
from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline
from ray_tpu_torch.data.datasource import Datasource, FileBasedDatasource, ReadTask
from ray_tpu_torch.data.read_api import (
    from_items,
    from_block_generator,
    from_arrow,
    from_numpy,
    from_pandas,
    range,
    range_tensor,
    read_binary_files,
    read_csv,
    read_datasource,
    read_json,
    read_numpy,
    read_parquet,
    read_text,
)

__all__ = [
    "Dataset",
    "DatasetPipeline",
    "ActorPoolStrategy",
    "GroupedData",
    "Datasource",
    "FileBasedDatasource",
    "ReadTask",
    "read_datasource",
    "Block",
    "BlockAccessor",
    "from_items",
    "from_block_generator",
    "from_arrow",
    "from_numpy",
    "from_pandas",
    "range",
    "range_tensor",
    "read_csv",
    "read_json",
    "read_parquet",
    "read_numpy",
    "read_text",
    "read_binary_files",
]
