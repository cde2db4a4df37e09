"""tendermint.version.Consensus — {uint64 block=1, uint64 app=2} — and the
block protocol version a header carries.

Reference: cometbft_tpu/proto/version.py (proto/tendermint/version/
types.proto) and cometbft_tpu/version.py:13 (BlockProtocol).
"""

from __future__ import annotations

from dataclasses import dataclass

from cometbft_tpu_torch.libs import protoio

BLOCK_PROTOCOL = 11  # version/version.go BlockProtocol


@dataclass(frozen=True)
class ConsensusVersion:
    block: int = 0
    app: int = 0

    def encode(self) -> bytes:
        return protoio.field_varint(1, self.block) + protoio.field_varint(
            2, self.app
        )

    @classmethod
    def decode(cls, data: bytes) -> "ConsensusVersion":
        r = protoio.WireReader(data)
        block, app = 0, 0
        while not r.at_end():
            field, wt = r.read_tag()
            if field == 1:
                block = r.read_uvarint()
            elif field == 2:
                app = r.read_uvarint()
            else:
                r.skip(wt)
        return cls(block, app)
