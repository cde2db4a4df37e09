"""Embedded ordered key-value store.

Ported from cometbft_tpu/libs/db.py.

The reference depends on cometbft-db (goleveldb et al.) for the block store,
state store, indexers, evidence pool, and light-client store. We provide the
same interface shape (Get/Set/SetSync/Delete/Iterator/Batch) with two
backends: an in-memory sorted map and a persistent store over stdlib
sqlite3 (ordered BLOB primary key gives us prefix iteration).
"""

from __future__ import annotations

import bisect
import os
import sqlite3
import threading
from typing import Dict, Iterator, List, Optional, Tuple


class DB:
    """Interface (reference: cometbft-db DB)."""

    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None

    def set(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def set_sync(self, key: bytes, value: bytes) -> None:
        self.set(key, value)

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def delete_sync(self, key: bytes) -> None:
        self.delete(key)

    def iterator(
        self, start: Optional[bytes] = None, end: Optional[bytes] = None
    ) -> Iterator[Tuple[bytes, bytes]]:
        """Ascending iteration over [start, end)."""
        raise NotImplementedError

    def reverse_iterator(
        self, start: Optional[bytes] = None, end: Optional[bytes] = None
    ) -> Iterator[Tuple[bytes, bytes]]:
        """Descending iteration over [start, end)."""
        raise NotImplementedError

    def prefix_iterator(self, prefix: bytes) -> Iterator[Tuple[bytes, bytes]]:
        return self.iterator(prefix, prefix_end(prefix))

    def new_batch(self) -> "Batch":
        return Batch(self)

    def close(self) -> None:
        pass


def prefix_end(prefix: bytes) -> Optional[bytes]:
    """Smallest byte string greater than every string with this prefix."""
    b = bytearray(prefix)
    for i in reversed(range(len(b))):
        if b[i] != 0xFF:
            b[i] += 1
            return bytes(b[: i + 1])
    return None  # prefix is all 0xff — iterate to end


class Batch:
    """Write batch applied atomically on write() (reference: db.Batch)."""

    def __init__(self, db: "DB"):
        self._db = db
        self._ops: List[Tuple[str, bytes, Optional[bytes]]] = []

    def set(self, key: bytes, value: bytes) -> None:
        self._ops.append(("set", key, value))

    def delete(self, key: bytes) -> None:
        self._ops.append(("del", key, None))

    def write(self) -> None:
        self._db._apply_batch(self._ops)
        self._ops = []

    def write_sync(self) -> None:
        self.write()


class MemDB(DB):
    def __init__(self):
        self._mtx = threading.RLock()
        self._keys: List[bytes] = []  # sorted
        self._m: Dict[bytes, bytes] = {}

    def get(self, key: bytes) -> Optional[bytes]:
        with self._mtx:
            return self._m.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        with self._mtx:
            if key not in self._m:
                bisect.insort(self._keys, key)
            self._m[key] = value

    def delete(self, key: bytes) -> None:
        with self._mtx:
            if key in self._m:
                del self._m[key]
                i = bisect.bisect_left(self._keys, key)
                if i < len(self._keys) and self._keys[i] == key:
                    self._keys.pop(i)

    def _apply_batch(self, ops) -> None:
        with self._mtx:
            for op, k, v in ops:
                if op == "set":
                    self.set(k, v)
                else:
                    self.delete(k)

    def _range_keys(self, start: Optional[bytes], end: Optional[bytes]) -> List[bytes]:
        with self._mtx:
            lo = 0 if start is None else bisect.bisect_left(self._keys, start)
            hi = len(self._keys) if end is None else bisect.bisect_left(self._keys, end)
            return self._keys[lo:hi]

    def iterator(self, start=None, end=None):
        for k in self._range_keys(start, end):
            v = self.get(k)
            if v is not None:
                yield k, v

    def reverse_iterator(self, start=None, end=None):
        for k in reversed(self._range_keys(start, end)):
            v = self.get(k)
            if v is not None:
                yield k, v


class SQLiteDB(DB):
    """Persistent ordered KV on stdlib sqlite3.

    One connection per thread (sqlite3 objects are not thread-portable);
    WAL journaling for crash safety, NORMAL sync for throughput with
    set_sync forcing a checkpointed commit.
    """

    def __init__(self, path: str):
        self._path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._local = threading.local()
        self._all_conns: list = []  # every thread's conn, for close()
        self._conns_mtx = threading.Lock()
        self._closed = False
        conn = self._conn()
        conn.execute(
            "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB NOT NULL) WITHOUT ROWID"
        )
        conn.commit()

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            # check_same_thread off so close() can reap other threads'
            # connections; USE stays thread-local by discipline (self._local)
            conn = sqlite3.connect(
                self._path, timeout=30.0, check_same_thread=False
            )
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=NORMAL")
            # register under the lock, re-checking closed INSIDE it — a
            # thread racing close() must not leave an untracked live
            # connection holding the file lock
            with self._conns_mtx:
                if self._closed:
                    conn.close()
                    raise RuntimeError(f"database {self._path} is closed")
                self._all_conns.append(conn)
            self._local.conn = conn
        return conn

    def get(self, key: bytes) -> Optional[bytes]:
        cur = self._conn().execute("SELECT v FROM kv WHERE k=?", (key,))
        row = cur.fetchone()
        return row[0] if row else None

    def set(self, key: bytes, value: bytes) -> None:
        conn = self._conn()
        conn.execute("INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)", (key, value))
        conn.commit()

    def set_sync(self, key: bytes, value: bytes) -> None:
        conn = self._conn()
        conn.execute("INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)", (key, value))
        conn.commit()
        conn.execute("PRAGMA wal_checkpoint(FULL)")

    def delete(self, key: bytes) -> None:
        conn = self._conn()
        conn.execute("DELETE FROM kv WHERE k=?", (key,))
        conn.commit()

    def _apply_batch(self, ops) -> None:
        conn = self._conn()
        with conn:
            for op, k, v in ops:
                if op == "set":
                    conn.execute("INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)", (k, v))
                else:
                    conn.execute("DELETE FROM kv WHERE k=?", (k,))

    def iterator(self, start=None, end=None):
        q = "SELECT k, v FROM kv"
        cond, args = [], []
        if start is not None:
            cond.append("k >= ?")
            args.append(start)
        if end is not None:
            cond.append("k < ?")
            args.append(end)
        if cond:
            q += " WHERE " + " AND ".join(cond)
        q += " ORDER BY k ASC"
        # snapshot the keys to avoid holding a read cursor across writes
        rows = self._conn().execute(q, args).fetchall()
        for k, v in rows:
            yield bytes(k), bytes(v)

    def reverse_iterator(self, start=None, end=None):
        rows = list(self.iterator(start, end))
        for k, v in reversed(rows):
            yield k, v

    def compact(self) -> None:
        self._conn().execute("VACUUM")

    def close(self) -> None:
        """Close EVERY thread's connection, checkpointing the WAL so no
        stale -wal/-shm sidecars or file locks are left for a maintenance
        command opening the same files from another process. Connections
        are opened check_same_thread=False, so the closing thread may
        checkpoint and close them all — safe because by close() time the
        owning worker threads have stopped using them."""
        with self._conns_mtx:
            self._closed = True
            conns, self._all_conns = self._all_conns, []
        checkpointed = False
        for conn in conns:
            try:
                if not checkpointed:
                    conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")
                    checkpointed = True
            except sqlite3.Error:
                pass
            finally:
                try:
                    conn.close()
                except sqlite3.Error:
                    pass
        self._local.conn = None


def new_db(name: str, backend: str, db_dir: str) -> DB:
    """Factory (reference: cometbft-db NewDB; config db_backend)."""
    if backend in ("memdb", "mem"):
        return MemDB()
    if backend in ("sqlite", "goleveldb", "cleveldb", "badgerdb", "rocksdb", "boltdb"):
        # all persistent backend names map onto sqlite in this build
        return SQLiteDB(os.path.join(db_dir, f"{name}.db"))
    raise ValueError(f"unknown db backend {backend!r}")
