"""BlockStore — parts-encoded persistent block storage.

Ported from cometbft_tpu/store/block_store.py.

Reference: store/store.go — key layout :434-450 (H: meta, P: part,
C: commit, SC: seen commit, BH: by-hash index), SaveBlock :332,
PruneBlocks :248, base/height state under "blockStore".
"""

from __future__ import annotations

import threading
from typing import List, Optional

from cometbft_tpu_torch.libs import protoio
from cometbft_tpu_torch.libs.db import DB
from cometbft_tpu_torch.types.block import Block, BlockMeta, Commit
from cometbft_tpu_torch.types.part_set import Part, PartSet

_STORE_KEY = b"blockStore"


def _meta_key(height: int) -> bytes:
    return b"H:%d" % height


def _part_key(height: int, index: int) -> bytes:
    return b"P:%d:%d" % (height, index)


def _commit_key(height: int) -> bytes:
    return b"C:%d" % height


def _seen_commit_key(height: int) -> bytes:
    return b"SC:%d" % height


def _hash_key(hash_: bytes) -> bytes:
    return b"BH:" + hash_.hex().encode()


def _encode_store_state(base: int, height: int) -> bytes:
    """proto store.BlockStoreState {int64 base=1, int64 height=2}."""
    out = b""
    if base:
        out += protoio.field_varint(1, base)
    if height:
        out += protoio.field_varint(2, height)
    return out


def _decode_store_state(data: bytes):
    r = protoio.WireReader(data)
    base = height = 0
    while not r.at_end():
        f, wt = r.read_tag()
        if f == 1:
            base = r.read_varint()
        elif f == 2:
            height = r.read_varint()
        else:
            r.skip(wt)
    return base, height


class BlockStore:
    """Thread-safe; heights are contiguous [base, height]."""

    def __init__(self, db: DB):
        self._db = db
        self._mtx = threading.RLock()
        raw = db.get(_STORE_KEY)
        if raw:
            self._base, self._height = _decode_store_state(raw)
        else:
            self._base, self._height = 0, 0

    def base(self) -> int:
        with self._mtx:
            return self._base

    def height(self) -> int:
        with self._mtx:
            return self._height

    def size(self) -> int:
        with self._mtx:
            return 0 if self._height == 0 else self._height - self._base + 1

    # -- loads --------------------------------------------------------------

    def load_block_meta(self, height: int) -> Optional[BlockMeta]:
        raw = self._db.get(_meta_key(height))
        return BlockMeta.decode(raw) if raw else None

    def load_block(self, height: int) -> Optional[Block]:
        meta = self.load_block_meta(height)
        if meta is None:
            return None
        parts = []
        for i in range(meta.block_id.part_set_header.total):
            part = self.load_block_part(height, i)
            if part is None:
                return None
            parts.append(part.bytes_)
        return Block.decode(b"".join(parts))

    def load_block_by_hash(self, hash_: bytes) -> Optional[Block]:
        raw = self._db.get(_hash_key(hash_))
        if not raw:
            return None
        return self.load_block(int(raw))

    def load_block_part(self, height: int, index: int) -> Optional[Part]:
        raw = self._db.get(_part_key(height, index))
        return Part.decode(raw) if raw else None

    def load_block_commit(self, height: int) -> Optional[Commit]:
        """The canonical commit for `height` (stored at height+1 save)."""
        raw = self._db.get(_commit_key(height))
        return Commit.decode(raw) if raw else None

    def load_seen_commit(self, height: int) -> Optional[Commit]:
        raw = self._db.get(_seen_commit_key(height))
        return Commit.decode(raw) if raw else None

    # -- saves --------------------------------------------------------------

    def save_block(
        self, block: Block, block_parts: PartSet, seen_commit: Commit
    ) -> None:
        """Reference: store/store.go:332 — meta + every part + LastCommit at
        H-1 + seen commit at H, then advance the store state."""
        if block is None:
            raise ValueError("BlockStore can only save a non-nil block")
        with self._mtx:
            height = block.header.height
            expected = self._height + 1
            if self._height > 0 and height != expected:
                raise ValueError(
                    f"BlockStore can only save contiguous blocks; wanted "
                    f"{expected}, got {height}"
                )
            if not block_parts.is_complete():
                raise ValueError("can only save complete block part sets")

            batch = self._db.new_batch()
            from cometbft_tpu_torch.types.block import BlockID

            block_id = BlockID(block.hash(), block_parts.header())
            meta = BlockMeta(
                block_id=block_id,
                block_size=block.size(),
                header=block.header,
                num_txs=len(block.data.txs),
            )
            batch.set(_meta_key(height), meta.encode())
            batch.set(_hash_key(block.hash()), b"%d" % height)
            for i in range(block_parts.total()):
                batch.set(_part_key(height, i), block_parts.get_part(i).encode())
            if block.last_commit is not None:
                batch.set(_commit_key(height - 1), block.last_commit.encode())
            batch.set(_seen_commit_key(height), seen_commit.encode())

            self._height = height
            if self._base == 0:
                self._base = height
            batch.set(_STORE_KEY, _encode_store_state(self._base, self._height))
            batch.write_sync()

    def save_seen_commit(self, height: int, commit: Commit) -> None:
        self._db.set(_seen_commit_key(height), commit.encode())

    def prune_blocks(self, retain_height: int) -> int:
        """Remove blocks below retain_height; returns count pruned
        (reference: store/store.go:248)."""
        with self._mtx:
            if retain_height <= 0:
                raise ValueError("height must be greater than 0")
            if retain_height > self._height:
                raise ValueError(
                    f"cannot prune beyond the latest height {self._height}"
                )
            if retain_height < self._base:
                return 0
            pruned = 0
            batch = self._db.new_batch()
            for h in range(self._base, retain_height):
                meta = self.load_block_meta(h)
                if meta is None:
                    continue
                batch.delete(_meta_key(h))
                batch.delete(_hash_key(meta.block_id.hash))
                for i in range(meta.block_id.part_set_header.total):
                    batch.delete(_part_key(h, i))
                batch.delete(_commit_key(h))
                batch.delete(_seen_commit_key(h))
                pruned += 1
            self._base = retain_height
            batch.set(_STORE_KEY, _encode_store_state(self._base, self._height))
            batch.write_sync()
            return pruned

    def load_base_meta(self) -> Optional[BlockMeta]:
        with self._mtx:
            if self._base == 0:
                return None
            return self.load_block_meta(self._base)
