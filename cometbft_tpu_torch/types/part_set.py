"""PartSet — blocks split into 64KiB parts with merkle proofs for gossip.

Reference: cometbft_tpu/types/part_set.py (types/part_set.go: PartSet
:150, Part :28); part size constant
types/params.go:18 (BlockPartSizeBytes = 65536).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Optional

from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.libs import protoio
from cometbft_tpu_torch.libs.bits import BitArray
from cometbft_tpu_torch.types.block import PartSetHeader

BLOCK_PART_SIZE_BYTES = 65536


def _encode_proof(p: merkle.Proof) -> bytes:
    out = protoio.field_varint(1, p.total) + protoio.field_varint(2, p.index)
    out += protoio.field_bytes(3, p.leaf_hash)
    for a in p.aunts:
        out += protoio.field_bytes(4, a)
    return out


def _decode_proof(data: bytes) -> merkle.Proof:
    r = protoio.WireReader(data)
    total, index, leaf, aunts = 0, 0, b"", []
    while not r.at_end():
        f, wt = r.read_tag()
        if f == 1:
            total = r.read_varint()
        elif f == 2:
            index = r.read_varint()
        elif f == 3:
            leaf = r.read_bytes()
        elif f == 4:
            aunts.append(r.read_bytes())
        else:
            r.skip(wt)
    return merkle.Proof(total, index, leaf, aunts)


@dataclass
class Part:
    """proto: {uint32 index=1, bytes bytes=2, Proof proof=3 (non-null)}."""

    index: int
    bytes_: bytes
    proof: merkle.Proof

    def validate_basic(self) -> None:
        if self.index < 0:
            raise ValueError("negative part index")
        if len(self.bytes_) > BLOCK_PART_SIZE_BYTES:
            raise ValueError("part bytes too big")

    def encode(self) -> bytes:
        return (
            protoio.field_varint(1, self.index)
            + protoio.field_bytes(2, self.bytes_)
            + protoio.field_message(3, _encode_proof(self.proof))
        )

    @classmethod
    def decode(cls, data: bytes) -> "Part":
        r = protoio.WireReader(data)
        index, bz, proof = 0, b"", merkle.Proof(0, 0, b"", [])
        while not r.at_end():
            f, wt = r.read_tag()
            if f == 1:
                index = r.read_uvarint()
            elif f == 2:
                bz = r.read_bytes()
            elif f == 3:
                proof = _decode_proof(r.read_bytes())
            else:
                r.skip(wt)
        return cls(index, bz, proof)


class PartSet:
    """Thread-safe accumulating part set (reference: part_set.go:150)."""

    def __init__(self, header: PartSetHeader):
        self._mtx = threading.Lock()
        self._header = header
        self._parts: List[Optional[Part]] = [None] * header.total
        self._parts_bit_array = BitArray(header.total)
        self._count = 0
        self._byte_size = 0

    # -- construction ------------------------------------------------------

    @classmethod
    def from_data(cls, data: bytes, part_size: int = BLOCK_PART_SIZE_BYTES) -> "PartSet":
        """Split data into parts with merkle proofs
        (reference: NewPartSetFromData)."""
        total = (len(data) + part_size - 1) // part_size or 1
        chunks = [data[i * part_size : (i + 1) * part_size] for i in range(total)]
        root, proofs = merkle.proofs_from_byte_slices(chunks)
        ps = cls(PartSetHeader(total, root))
        for i, chunk in enumerate(chunks):
            added, err = ps.add_part(Part(i, chunk, proofs[i]))
            if not added:
                raise RuntimeError(f"failed to add own part: {err}")
        return ps

    @classmethod
    def from_header(cls, header: PartSetHeader) -> "PartSet":
        return cls(header)

    # -- accessors ---------------------------------------------------------

    def header(self) -> PartSetHeader:
        return self._header

    def has_header(self, header: PartSetHeader) -> bool:
        return self._header == header

    def bit_array(self) -> BitArray:
        with self._mtx:
            return self._parts_bit_array.copy()

    def hash(self) -> bytes:
        return self._header.hash

    def total(self) -> int:
        return self._header.total

    def count(self) -> int:
        with self._mtx:
            return self._count

    def byte_size(self) -> int:
        with self._mtx:
            return self._byte_size

    def is_complete(self) -> bool:
        with self._mtx:
            return self._count == self._header.total

    def get_part(self, index: int) -> Optional[Part]:
        with self._mtx:
            if 0 <= index < len(self._parts):
                return self._parts[index]
            return None

    # -- mutation ----------------------------------------------------------

    def add_part(self, part: Part):
        """Returns (added, error) (reference: PartSet.AddPart)."""
        with self._mtx:
            if part.index >= self._header.total:
                return False, "unexpected part index"
            if self._parts[part.index] is not None:
                return False, None  # duplicate, not an error
            try:
                part.proof.verify(self._header.hash, part.bytes_)
            except ValueError as e:
                return False, f"invalid part proof: {e}"
            self._parts[part.index] = part
            self._parts_bit_array.set_index(part.index, True)
            self._count += 1
            self._byte_size += len(part.bytes_)
            return True, None

    def get_reader(self) -> bytes:
        """Assembled data (reference returns an io.Reader over parts)."""
        if not self.is_complete():
            raise RuntimeError("cannot read incomplete part set")
        with self._mtx:
            return b"".join(p.bytes_ for p in self._parts)  # type: ignore[union-attr]
