"""Generational device key store: validator sets whose public keys stay on
the device across heights.

Reference: cometbft_tpu/crypto/tpu/keystore.py. Two routes read it:

* ``ed25519_batch.verify_valset_resident`` — a commit against the whole
  set, lane i verified against table row i; each commit ships only
  R ‖ S ‖ h (96 bytes a lane);
* ``verify_batch_indexed`` below — a flush whose every key is in one
  resident set ships R ‖ S ‖ h and an int32 row index per lane (100
  bytes) instead of the keys.

An entry's ``table_dev`` is a ``torch.uint8[n, 32]`` tensor of the keys
in set order, on the device it was built for; ``key_tables`` beside it
holds what the resident kernel reads, each key's comb tables and
validity flag (``ed25519_batch.key_tables_kernel``, int32[n, 65, 32],
8,320 bytes a key), built once at upload. Entries are keyed on the
valset id AND that device, resolved to its index (a bare ``"cuda"`` is
the current card): a lookup from another device misses and builds its
own table, so a table is never read on a device it was not
made for (the reference keyed its compiled executables on shape alone and
handed them placements they were not built for; ROADMAP C-ref 1). Every
entry is stamped with the store generation (bumped on every upload and
invalidation) and the topology generation it was built under
(``_topo_generation``, the default topology's ``generation()``, which a
quarantine or a re-admission bumps); an entry from an older topology
generation is dropped on sight and never verified against.

For the scheduler's and the supervisor's callers the store also answers
``residency()`` (the decision plane's per-flush summary), ``covers``
(the priced router's indexed-route probe), ``generation()``,
``entry_for`` and ``register`` (a host-only entry, with no device table,
for a verify service's generation handshake) as the reference's do
(reference keystore.py:232-349).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

CACHE_MAX = 4


class KeyStoreEntry:
    """One resident validator set."""

    __slots__ = (
        "valset_id",        # bytes digest the caller keyed this set by
        "device",           # torch.device of table_dev
        "generation",       # store generation at upload
        "topo_generation",  # topology generation at build
        "pk_arr",           # np.uint8[n, 32] host copy of the key rows
        "pk_ok",            # np.bool_[n], False for a malformed key
        "index",            # dict: key bytes -> row of table_dev
        "table_dev",        # torch.uint8[n, 32] on ``device``
        "key_tables",       # torch.int32[n, 65, 32] on ``device``, or None
        "n",                # key count
        "hits",             # uses since upload (0 at eviction = thrash)
        "pins",             # in-flight dispatches holding LRU immunity
    )


_HOST = "host"  # the device key of a host-only entry (register)


def _topo_generation() -> int:
    """The device-topology generation (crypto/cuda/topology.py): the
    single seam for staleness. The default topology bumps it on every
    quarantine and re-admission; tests patch it to bump."""
    from cometbft_tpu_torch.crypto.cuda import topology

    return topology.default_topology().generation()


def _key_bytes(pk) -> bytes:
    """One key as raw bytes: bytes-like or a PubKey object."""
    if isinstance(pk, (bytes, bytearray, memoryview)):
        return bytes(pk)
    b = getattr(pk, "bytes", None)
    if callable(b):
        return b()
    return bytes(pk)


def key_rows(pub_keys: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """→ (pk_arr u8[n, 32], pk_ok bool[n]); a key that is not 32 bytes
    gets a zero row and pk_ok False."""
    keys = [_key_bytes(pk) for pk in pub_keys]
    pk_ok = np.array([len(k) == 32 for k in keys], bool)
    parts = [k if ok else b"\x00" * 32 for k, ok in zip(keys, pk_ok)]
    pk_arr = np.frombuffer(b"".join(parts), np.uint8).reshape(len(keys), 32).copy()
    return pk_arr, pk_ok


def _device_key(device) -> str:
    """The card a device names: a bare "cuda" is the current card, so
    "cuda" and "cuda:0" find one entry, and an entry built while card 0
    was current is not found for card 1."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return str(dev)


class DeviceKeyStore:
    def __init__(self, max_entries: int = CACHE_MAX):
        # verify_commit runs from several threads; every touch of the
        # OrderedDict takes this lock, the slow upload runs outside it
        self._entries: "OrderedDict[Tuple[bytes, str], KeyStoreEntry]" = OrderedDict()
        self._mtx = threading.Lock()
        self._max = int(max_entries)
        self._gen = 0
        self._stats = {
            "hits": 0,
            "misses": 0,
            "uploads": 0,
            "invalidations": 0,
            "stale_drops": 0,
            "indexed_dispatches": 0,
            "indexed_lanes": 0,
            "keystore_thrash": 0,  # evicted before serving one use
        }

    def _evict_excess_locked(self) -> None:
        """LRU eviction that skips pinned entries; if every entry is
        pinned the store overflows until an unpin."""
        while len(self._entries) > self._max:
            victim = next((k for k, e in self._entries.items() if e.pins <= 0), None)
            if victim is None:
                return
            e = self._entries.pop(victim)
            if e.hits == 0:
                self._stats["keystore_thrash"] += 1

    def _hit_locked(self, key, e: KeyStoreEntry) -> KeyStoreEntry:
        self._entries.move_to_end(key)
        self._stats["hits"] += 1
        e.hits += 1
        return e

    def _insert_locked(self, key, e: KeyStoreEntry) -> KeyStoreEntry:
        """Insert a freshly built entry, or adopt the entry that a
        concurrent build inserted first."""
        won = self._entries.get(key)
        if won is not None and won.topo_generation == e.topo_generation:
            self._entries.move_to_end(key)
            return won
        self._gen += 1
        e.generation = self._gen
        e.hits = 0
        e.pins = 0
        self._entries[key] = e
        self._stats["uploads"] += 1
        self._evict_excess_locked()
        return e

    def get(self, valset_id: bytes, pub_keys, build, device) -> KeyStoreEntry:
        """The entry for ``valset_id`` on ``device``; on a miss
        ``build(pub_keys)`` makes it (the upload, outside the lock). An
        entry from an older topology generation is dropped and rebuilt."""
        key = (bytes(valset_id), _device_key(device))
        topo_gen = _topo_generation()
        with self._mtx:
            e = self._entries.get(key)
            if e is not None:
                if e.topo_generation == topo_gen:
                    return self._hit_locked(key, e)
                del self._entries[key]
                self._stats["stale_drops"] += 1
            self._stats["misses"] += 1
        e = build(pub_keys)
        e.valset_id = key[0]
        e.device = torch.device(device)
        e.topo_generation = topo_gen
        with self._mtx:
            return self._insert_locked(key, e)

    def pin(self, valset_id: bytes, device) -> bool:
        """Make the entry immune to LRU eviction (refcounted) while a
        dispatch reads it, and count the use. False when it is gone."""
        with self._mtx:
            e = self._entries.get((bytes(valset_id), _device_key(device)))
            if e is None:
                return False
            e.pins += 1
            e.hits += 1
            return True

    def unpin(self, valset_id: bytes, device) -> None:
        with self._mtx:
            e = self._entries.get((bytes(valset_id), _device_key(device)))
            if e is not None:
                e.pins = max(0, e.pins - 1)
            self._evict_excess_locked()

    @contextmanager
    def pinned(self, valset_id: bytes, device):
        """``with store.pinned(vid, device) as ok:`` — pinned for the
        block when the entry exists, always balanced on exit."""
        ok = self.pin(valset_id, device)
        try:
            yield ok
        finally:
            if ok:
                self.unpin(valset_id, device)

    def lookup_fresh(self, device) -> List[KeyStoreEntry]:
        """Entries on ``device`` under the current topology generation,
        most recently used first; stale entries are dropped on sight."""
        topo_gen = _topo_generation()
        dev = _device_key(device)
        with self._mtx:
            stale = [k for k, e in self._entries.items() if e.topo_generation != topo_gen]
            for k in stale:
                del self._entries[k]
                self._stats["stale_drops"] += 1
            return [e for k, e in reversed(self._entries.items()) if k[1] == dev]

    def invalidate(self, valset_id: Optional[bytes] = None) -> int:
        """Drop one set on every device (or everything, None); bumps the
        store generation when anything went."""
        with self._mtx:
            if valset_id is None:
                victims = list(self._entries)
            else:
                victims = [k for k in self._entries if k[0] == bytes(valset_id)]
            for k in victims:
                del self._entries[k]
            if victims:
                self._gen += 1
                self._stats["invalidations"] += len(victims)
        return len(victims)

    def covering_entry(self, pub_keys: Sequence, device) -> Optional[KeyStoreEntry]:
        """The most recently used fresh entry on ``device`` whose table
        holds every key of ``pub_keys``, or None."""
        if not pub_keys:
            return None
        keys = [_key_bytes(pk) for pk in pub_keys]
        for e in self.lookup_fresh(device):
            if all(k in e.index for k in keys):
                return e
        return None

    def covers(self, pub_keys: Sequence, device=None) -> bool:
        """True when ONE fresh entry with a device table (on ``device``,
        or on any device for None) holds every key of ``pub_keys``: the
        priced router's indexed-feasibility probe (reference :232).
        Advisory: ``verify_batch_indexed`` looks again, so an eviction
        in between just sends the flush down the keyed route. Host-only
        entries (``register``) do not count."""
        if not pub_keys:
            return False
        keys = [_key_bytes(pk) for pk in pub_keys]
        topo_gen = _topo_generation()
        want = None if device is None else _device_key(device)
        with self._mtx:
            entries = [
                e for k, e in self._entries.items()
                if k[1] != _HOST and e.topo_generation == topo_gen and (want is None or k[1] == want)
            ]
        return any(all(k in e.index for k in keys) for e in entries)

    def generation(self) -> int:
        """The store generation: the freshness token a verify service
        stamps on its indexed-frame handshake (reference :252)."""
        with self._mtx:
            return self._gen

    def entry_for(self, valset_id: bytes, generation: Optional[int] = None, device=None) -> Optional[KeyStoreEntry]:
        """The entry for ``valset_id`` (on ``device``; the most recently
        used one on any device for None), but only while the caller's
        cached store ``generation`` matches the store's: a stale caller
        is refused (``stale_drops`` counted) (reference :260)."""
        vid = bytes(valset_id)
        want = None if device is None else _device_key(device)
        with self._mtx:
            if generation is not None and generation != self._gen:
                self._stats["stale_drops"] += 1
                return None
            key = next(
                (k for k in reversed(self._entries) if k[0] == vid and (want is None or k[1] == want)),
                None,
            )
            if key is None:
                return None
            return self._hit_locked(key, self._entries[key])

    def register(self, valset_id: bytes, pub_keys) -> KeyStoreEntry:
        """A host-only entry for ``valset_id``: the key rows and the
        index, no device table, so the device routes never read it; a
        new entry bumps the store generation (reference :281). A key
        that is not 32 bytes gets a zero row and ``pk_ok`` False."""
        key = (bytes(valset_id), _HOST)
        with self._mtx:
            e = self._entries.get(key)
            if e is not None:
                return self._hit_locked(key, e)
            self._stats["misses"] += 1
        e = new_entry(pub_keys, None, "cpu")
        e.valset_id = key[0]
        e.device = None
        e.topo_generation = _topo_generation()
        with self._mtx:
            return self._insert_locked(key, e)

    def residency(self) -> dict:
        """The decision plane's per-flush summary: entry and key counts,
        generation, hit rate (reference :334)."""
        with self._mtx:
            hits = self._stats["hits"]
            lookups = hits + self._stats["misses"]
            return {
                "entries": len(self._entries),
                "keys": sum(e.n for e in self._entries.values()),
                "generation": self._gen,
                "hit_rate": (hits / lookups) if lookups else None,
                "indexed_dispatches": self._stats["indexed_dispatches"],
                "thrash": self._stats["keystore_thrash"],
            }

    def note_indexed(self, lanes: int) -> None:
        with self._mtx:
            self._stats["indexed_dispatches"] += 1
            self._stats["indexed_lanes"] += int(lanes)

    def snapshot(self) -> dict:
        """The store's state: generation, entries, stats."""
        with self._mtx:
            return {
                "generation": self._gen,
                "entries": [
                    {
                        "valset_id": e.valset_id.hex()[:16],
                        "device": str(e.device),
                        "generation": e.generation,
                        "topo_generation": e.topo_generation,
                        "keys": e.n,
                        "pins": e.pins,
                    }
                    for e in self._entries.values()
                ],
                "stats": dict(self._stats),
            }


def new_entry(pub_keys: Sequence, table_dev: torch.Tensor, device, key_tables: Optional[torch.Tensor] = None) -> KeyStoreEntry:
    """An unregistered entry for ``pub_keys`` in set order; the index maps
    each well-formed key to its first row. ``key_tables`` are the rows'
    comb tables, which the resident and indexed routes verify against."""
    pk_arr, pk_ok = key_rows(pub_keys)
    e = KeyStoreEntry()
    e.valset_id = b""
    e.device = torch.device(device)
    e.generation = 0
    e.topo_generation = 0
    e.pk_arr = pk_arr
    e.pk_ok = pk_ok
    e.index = {}
    for i in range(len(pk_arr)):
        if pk_ok[i]:
            e.index.setdefault(pk_arr[i].tobytes(), i)
    e.table_dev = table_dev
    e.key_tables = key_tables
    e.n = len(pk_arr)
    e.hits = 0
    e.pins = 0
    return e


_default = DeviceKeyStore()


def default_store() -> DeviceKeyStore:
    return _default


def covers(pub_keys: Sequence, device=None) -> bool:
    """``covers`` of the default store (reference :378)."""
    return _default.covers(pub_keys, device)


def verify_batch_indexed(pub_keys: Sequence, msgs: Sequence, sigs: Sequence, device) -> Optional[List[bool]]:
    """The indexed route: if one fresh entry on ``device`` covers every
    key of the flush, verify against its table by row index, the entry
    pinned for the whole chunk loop. None when no entry covers the flush
    (the caller then ships the keys)."""
    from cometbft_tpu_torch.crypto.cuda import ed25519_batch

    n = len(pub_keys)
    if n == 0:
        return []
    entry = _default.covering_entry(pub_keys, device)
    if entry is None:
        return None
    idx = np.fromiter((entry.index[_key_bytes(pk)] for pk in pub_keys), np.int32, count=n)
    with _default.pinned(entry.valset_id, device):
        out = ed25519_batch.verify_keyed(entry.key_tables, idx, entry.pk_arr[idx], msgs, sigs, device)
    _default.note_indexed(n)
    return [bool(v) for v in out]
