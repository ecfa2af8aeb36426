"""Blocks: the unit of distributed data.

Analog of ``python/ray/data/block.py``: a block is an object-store value
holding a batch of rows — a list of rows, a dict-of-numpy column table,
or an Arrow table (``pyarrow.Table``, the reference's native layout —
``python/ray/data/block.py:1`` + ``_internal/arrow_block.py``).
``BlockAccessor`` normalizes the three layouts.  pyarrow is imported only
where an Arrow block is made or asked for.

Arrow blocks ride the object store zero-copy: serialization uses
pickle-5 out-of-band buffers (``_private/serialization.py``), and Arrow
tables expose their column buffers through that protocol, so a put/get
round trip never copies the column data into pickle bytes.  Slicing an
Arrow block (``Table.slice``) is zero-copy too, which makes it the right
layout for large read->train ingest paths.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np

Block = Union[List[Any], Dict[str, np.ndarray], "pa.Table"]


def _loaded_pyarrow():
    """pyarrow if something has imported it, else None: an Arrow block can
    only exist once it has, so a process that never meets one never loads
    it (the card's machine has no pyarrow at all)."""
    return sys.modules.get("pyarrow")


def _is_arrow(block) -> bool:
    pa = _loaded_pyarrow()
    return pa is not None and isinstance(block, pa.Table)


class BlockAccessor:
    def __init__(self, block: Block):
        self.block = block
        self.is_arrow = _is_arrow(block)
        self.is_table = isinstance(block, dict)

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    def num_rows(self) -> int:
        if self.is_arrow:
            return self.block.num_rows
        if self.is_table:
            return len(next(iter(self.block.values()))) if self.block else 0
        return len(self.block)

    def iter_rows(self) -> Iterator[Any]:
        if self.is_arrow:
            names = self.block.column_names
            if names == ["value"]:
                yield from self.block.column("value").to_pylist()
                return
            for row in self.block.to_pylist():
                yield row
            return
        if self.is_table:
            keys = list(self.block)
            if keys == ["value"]:  # simple block: rows are the plain values
                yield from self.block["value"]
                return
            for i in range(self.num_rows()):
                yield {k: self.block[k][i] for k in keys}
        else:
            yield from self.block

    def to_rows(self) -> List[Any]:
        return list(self.iter_rows())

    def to_batch(self) -> Dict[str, np.ndarray]:
        """Columnar view (dict of numpy arrays; zero-copy from Arrow for
        primitive columns without nulls)."""
        if self.is_arrow:
            pa = _loaded_pyarrow()
            out = {}
            for name in self.block.column_names:
                col = self.block.column(name)
                try:
                    out[name] = col.to_numpy(zero_copy_only=False)
                except (pa.ArrowInvalid, ValueError):
                    out[name] = np.asarray(col.to_pylist(), dtype=object)
            return out
        if self.is_table:
            return dict(self.block)
        if not self.block:
            return {}
        first = self.block[0]
        if isinstance(first, dict):
            return {
                k: np.asarray([r[k] for r in self.block]) for k in first
            }
        return {"value": np.asarray(self.block)}

    def to_arrow(self) -> "pa.Table":
        import pyarrow as pa  # ImportError where it is not installed

        if self.is_arrow:
            return self.block
        batch = self.to_batch()
        return pa.table({k: pa.array(v) for k, v in batch.items()})

    def slice(self, start: int, end: int) -> Block:
        if self.is_arrow:
            return self.block.slice(start, end - start)  # zero-copy view
        if self.is_table:
            return {k: v[start:end] for k, v in self.block.items()}
        return self.block[start:end]

    def schema(self) -> Optional[Dict[str, str]]:
        if self.num_rows() == 0:
            return None
        if self.is_arrow:
            return {f.name: str(f.type) for f in self.block.schema}
        batch = self.to_batch()
        return {k: str(v.dtype) for k, v in batch.items()}

    @staticmethod
    def concat(blocks: List[Block]) -> Block:
        blocks = [b for b in blocks if BlockAccessor(b).num_rows() > 0]
        if not blocks:
            return []
        if _is_arrow(blocks[0]):
            pa = _loaded_pyarrow()
            if all(_is_arrow(b) for b in blocks):
                return pa.concat_tables(blocks)
            blocks = [BlockAccessor(b).to_arrow() for b in blocks]
            return pa.concat_tables(blocks)
        if isinstance(blocks[0], dict):
            keys = list(blocks[0])
            batches = [BlockAccessor(b).to_batch() for b in blocks]
            return {k: np.concatenate([b[k] for b in batches]) for k in keys}
        out: List[Any] = []
        for b in blocks:
            out.extend(BlockAccessor(b).to_rows())
        return out

    @staticmethod
    def from_batch(batch: Union[Dict[str, np.ndarray], np.ndarray, List]) -> Block:
        if _is_arrow(batch):
            return batch
        if isinstance(batch, dict):
            return {k: np.asarray(v) for k, v in batch.items()}
        if isinstance(batch, np.ndarray):
            return {"value": batch}
        return list(batch)
