"""Pluggable GCS metadata storage — the StoreClient layer.

Analog of ``src/ray/gcs/store_client/``: the GCS keeps its tables behind a
``StoreClient`` interface with an in-memory default
(``in_memory_store_client.h:31``) and a persistent backend for fault
tolerance (``redis_store_client.h:28``; flags in
``gcs_server_main.cc:26-33``).  Here the persistent backend is sqlite —
single-file, crash-safe, stdlib — enabled with
``init(_gcs_persistence_path=...)``.
On restart the head replays the store (``GcsInitData`` analog,
``gcs_init_data.h:29``): the internal KV (function/class blobs survive),
job history, and prior actor records (marked DEAD — their processes died
with the old head).
"""

from __future__ import annotations

import pickle
import sqlite3
import threading
from typing import Dict, Iterable, List, Optional, Tuple


class StoreClient:
    """table -> key -> bytes.  Implementations must be thread-safe."""

    def put(self, table: str, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def replace_table(self, table: str, items: Iterable[Tuple[bytes, bytes]]) -> None:
        """Atomically replace a table's full contents (one transaction —
        deletions propagate and per-key commit cost is avoided)."""
        for k in self.keys(table):
            self.delete(table, k)
        for k, v in items:
            self.put(table, k, v)

    def get(self, table: str, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def delete(self, table: str, key: bytes) -> None:
        raise NotImplementedError

    def keys(self, table: str) -> List[bytes]:
        raise NotImplementedError

    def items(self, table: str) -> List[Tuple[bytes, bytes]]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class InMemoryStoreClient(StoreClient):
    def __init__(self):
        self._lock = threading.Lock()
        self._tables: Dict[str, Dict[bytes, bytes]] = {}

    def put(self, table, key, value):
        with self._lock:
            self._tables.setdefault(table, {})[key] = value

    def get(self, table, key):
        with self._lock:
            return self._tables.get(table, {}).get(key)

    def delete(self, table, key):
        with self._lock:
            self._tables.get(table, {}).pop(key, None)

    def keys(self, table):
        with self._lock:
            return list(self._tables.get(table, {}).keys())

    def items(self, table):
        with self._lock:
            return list(self._tables.get(table, {}).items())


class SqliteStoreClient(StoreClient):
    """Durable store; one connection guarded by a lock (writes are rare —
    control-plane metadata, not the data plane)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS kv ("
            " tbl TEXT NOT NULL, key BLOB NOT NULL, value BLOB NOT NULL,"
            " PRIMARY KEY (tbl, key))"
        )
        self._db.commit()

    def put(self, table, key, value):
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO kv (tbl, key, value) VALUES (?, ?, ?)",
                (table, key, value),
            )
            self._db.commit()

    def replace_table(self, table, items):
        with self._lock:
            self._db.execute("DELETE FROM kv WHERE tbl = ?", (table,))
            self._db.executemany(
                "INSERT INTO kv (tbl, key, value) VALUES (?, ?, ?)",
                [(table, k, v) for k, v in items],
            )
            self._db.commit()  # one fsync for the whole flush pass

    def get(self, table, key):
        with self._lock:
            row = self._db.execute(
                "SELECT value FROM kv WHERE tbl = ? AND key = ?", (table, key)
            ).fetchone()
        return row[0] if row else None

    def delete(self, table, key):
        with self._lock:
            self._db.execute("DELETE FROM kv WHERE tbl = ? AND key = ?", (table, key))
            self._db.commit()

    def keys(self, table):
        with self._lock:
            rows = self._db.execute(
                "SELECT key FROM kv WHERE tbl = ?", (table,)
            ).fetchall()
        return [r[0] for r in rows]

    def items(self, table):
        with self._lock:
            rows = self._db.execute(
                "SELECT key, value FROM kv WHERE tbl = ?", (table,)
            ).fetchall()
        return list(rows)

    def close(self):
        with self._lock:
            self._db.close()


def dumps(obj) -> bytes:
    return pickle.dumps(obj, protocol=5)


def loads(blob: bytes):
    return pickle.loads(blob)
