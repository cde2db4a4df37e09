"""The canonical test app: a key-value store behind ABCI.

Ported from cometbft_tpu/abci/kvstore.py.

Reference behavior: abci/example/kvstore/kvstore.go (tx "key=value" or raw
bytes; app hash = 8-byte varint of the kv-pair count; /key and /hash query
paths) and persistent_kvstore.go (validator-set changes via
"val:<pubkey-b64>!<power>" txs, tracked through BeginBlock/EndBlock).
"""

from __future__ import annotations

import base64
import json
from typing import Dict, List, Optional

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci.application import BaseApplication
from cometbft_tpu_torch.libs.db import DB, MemDB
from cometbft_tpu_torch.proto.keys import PublicKeyProto

PROTOCOL_VERSION = 0x1

_STATE_KEY = b"stateKey"
_KV_PREFIX = b"kvPairKey:"
VALIDATOR_SET_CHANGE_PREFIX = "val:"
_VALIDATOR_PREFIX = b"val:"

# the most snapshots advertised (reference statesync/snapshots.py:18,
# reactor.go:26); statesync/ is not ported yet
RECENT_SNAPSHOTS = 10

CODE_TYPE_ENCODING_ERROR = 1
CODE_TYPE_BAD_NONCE = 2
CODE_TYPE_UNAUTHORIZED = 3


def _put_varint(n: int) -> bytes:
    """Go binary.PutVarint into an 8-byte buffer (zigzag varint, padded)."""
    from cometbft_tpu_torch.libs.protoio import encode_varint_zigzag

    raw = encode_varint_zigzag(n)
    return raw + b"\x00" * (8 - len(raw))


class _State:
    def __init__(self, db: DB):
        self.db = db
        self.size = 0
        self.height = 0
        self.app_hash = b""
        raw = db.get(_STATE_KEY)
        if raw:
            data = json.loads(raw)
            self.size = data.get("size", 0)
            self.height = data.get("height", 0)
            self.app_hash = base64.b64decode(data.get("app_hash", ""))

    def save(self) -> None:
        self.db.set(
            _STATE_KEY,
            json.dumps(
                {
                    "size": self.size,
                    "height": self.height,
                    "app_hash": base64.b64encode(self.app_hash).decode(),
                }
            ).encode(),
        )


class KVStoreApplication(BaseApplication):
    def __init__(self, db: Optional[DB] = None):
        self.state = _State(db or MemDB())
        self.retain_blocks = 0  # > 0 → request pruning via RetainHeight

    def info(self, req):
        return abci.ResponseInfo(
            data=json.dumps({"size": self.state.size}),
            version="0.17.0",
            app_version=PROTOCOL_VERSION,
            last_block_height=self.state.height,
            last_block_app_hash=self.state.app_hash,
        )

    def check_tx(self, req):
        return abci.ResponseCheckTx(code=abci.CODE_TYPE_OK, gas_wanted=1)

    def deliver_tx(self, req):
        parts = req.tx.split(b"=", 1)
        if len(parts) == 2:
            key, value = parts
        else:
            key, value = req.tx, req.tx
        existed = self.state.db.has(_KV_PREFIX + key)
        self.state.db.set(_KV_PREFIX + key, value)
        if not existed:
            self.state.size += 1
        events = [
            abci.Event(
                type="app",
                attributes=[
                    abci.EventAttribute(b"creator", b"Cosmoshi Netowoko", True),
                    abci.EventAttribute(b"key", key, True),
                    abci.EventAttribute(b"index_key", b"index is working", True),
                    abci.EventAttribute(b"noindex_key", b"index is working", False),
                ],
            )
        ]
        return abci.ResponseDeliverTx(code=abci.CODE_TYPE_OK, events=events)

    def commit(self):
        app_hash = _put_varint(self.state.size)
        self.state.app_hash = app_hash
        self.state.height += 1
        self.state.save()
        resp = abci.ResponseCommit(data=app_hash)
        if self.retain_blocks > 0 and self.state.height >= self.retain_blocks:
            resp.retain_height = self.state.height - self.retain_blocks + 1
        return resp

    def query(self, req):
        if req.path == "/hash":
            return abci.ResponseQuery(
                code=abci.CODE_TYPE_OK,
                value=str(self.state.height).encode(),
                height=self.state.height,
            )
        value = self.state.db.get(_KV_PREFIX + req.data)
        return abci.ResponseQuery(
            code=abci.CODE_TYPE_OK,
            log="exists" if value is not None else "does not exist",
            key=req.data,
            value=value or b"",
            height=self.state.height,
        )


class PersistentKVStoreApplication(KVStoreApplication):
    """kvstore + validator-set updates — the e2e/consensus test app.

    Validator txs: "val:<base64 ed25519 pubkey>!<power>". InitChain seeds
    the set; EndBlock returns accumulated updates; BeginBlock records
    byzantine validators by zeroing their power (reference:
    persistent_kvstore.go).
    """

    def __init__(self, db: Optional[DB] = None):
        super().__init__(db)
        self._val_updates: List[abci.ValidatorUpdate] = []
        self._val_addr_to_pubkey: Dict[bytes, PublicKeyProto] = {}
        self._load_validators()

    # -- validators ---------------------------------------------------------

    def _val_key(self, pubkey_bytes: bytes) -> bytes:
        return _VALIDATOR_PREFIX + base64.b64encode(pubkey_bytes)

    def _load_validators(self) -> None:
        from cometbft_tpu_torch.crypto import ed25519

        for key, raw in self.state.db.prefix_iterator(_VALIDATOR_PREFIX):
            update = abci.ValidatorUpdate.decode(raw)
            pk = update.pub_key
            addr = ed25519.PubKeyEd25519(pk.data).address()
            self._val_addr_to_pubkey[addr] = pk

    def validators(self) -> List[abci.ValidatorUpdate]:
        out = []
        for _, raw in self.state.db.prefix_iterator(_VALIDATOR_PREFIX):
            out.append(abci.ValidatorUpdate.decode(raw))
        return out

    def update_validator(self, v: abci.ValidatorUpdate) -> abci.ResponseDeliverTx:
        from cometbft_tpu_torch.crypto import ed25519

        pubkey_bytes = v.pub_key.data
        key = self._val_key(pubkey_bytes)
        addr = ed25519.PubKeyEd25519(pubkey_bytes).address()
        if v.power == 0:
            if not self.state.db.has(key):
                return abci.ResponseDeliverTx(
                    code=CODE_TYPE_UNAUTHORIZED,
                    log="Cannot remove non-existent validator",
                )
            self.state.db.delete(key)
            self._val_addr_to_pubkey.pop(addr, None)
        else:
            self.state.db.set(key, v.encode())
            self._val_addr_to_pubkey[addr] = v.pub_key
        self._val_updates.append(v)
        return abci.ResponseDeliverTx(code=abci.CODE_TYPE_OK)

    @staticmethod
    def make_val_set_change_tx(pubkey_b64: str, power: int) -> bytes:
        return f"{VALIDATOR_SET_CHANGE_PREFIX}{pubkey_b64}!{power}".encode()

    def _exec_validator_tx(self, tx: bytes) -> abci.ResponseDeliverTx:
        body = tx[len(VALIDATOR_SET_CHANGE_PREFIX) :].decode()
        if "!" not in body:
            return abci.ResponseDeliverTx(
                code=CODE_TYPE_ENCODING_ERROR,
                log="Expected 'pubkey!power'",
            )
        pubkey_b64, power_str = body.rsplit("!", 1)
        try:
            pubkey = base64.b64decode(pubkey_b64)
            power = int(power_str)
        except Exception:
            return abci.ResponseDeliverTx(
                code=CODE_TYPE_ENCODING_ERROR, log="bad pubkey or power"
            )
        return self.update_validator(
            abci.ValidatorUpdate(PublicKeyProto("ed25519", pubkey), power)
        )

    # -- abci ---------------------------------------------------------------

    def init_chain(self, req):
        for v in req.validators:
            r = self.update_validator(v)
            if r.code != abci.CODE_TYPE_OK:
                raise ValueError(f"error updating validators: {r.log}")
        self._val_updates = []
        return abci.ResponseInitChain()

    def begin_block(self, req):
        self._val_updates = []
        for ev in req.byzantine_validators:
            if ev.type == abci.EVIDENCE_TYPE_DUPLICATE_VOTE:
                pk = self._val_addr_to_pubkey.get(ev.validator.address)
                if pk is not None:
                    self.update_validator(
                        abci.ValidatorUpdate(pk, ev.validator.power - 1)
                    )
        return abci.ResponseBeginBlock()

    def deliver_tx(self, req):
        if req.tx.startswith(_VALIDATOR_PREFIX):
            return self._exec_validator_tx(req.tx)
        return super().deliver_tx(req)

    def check_tx(self, req):
        if req.tx.startswith(_VALIDATOR_PREFIX):
            body = req.tx[len(VALIDATOR_SET_CHANGE_PREFIX) :].decode(
                errors="replace"
            )
            if "!" not in body:
                return abci.ResponseCheckTx(
                    code=CODE_TYPE_ENCODING_ERROR, log="Expected 'pubkey!power'"
                )
        return super().check_tx(req)

    def end_block(self, req):
        return abci.ResponseEndBlock(validator_updates=list(self._val_updates))

    def query(self, req):
        if req.path == "/val":
            pk = self._val_addr_to_pubkey.get(req.data)
            if pk is None:
                return abci.ResponseQuery(code=abci.CODE_TYPE_OK, value=b"")
            return abci.ResponseQuery(
                code=abci.CODE_TYPE_OK,
                key=req.data,
                value=abci.ValidatorUpdate(pk, 0).encode(),
            )
        return super().query(req)


class SnapshotKVStoreApplication(PersistentKVStoreApplication):
    """kvstore + state-sync snapshots — the statesync test app.

    Reference model: test/e2e/app/{app.go,snapshots.go} — the app state is
    serialized to JSON at every `snapshot_interval`-th commit, chunks are
    fixed-size slices of that JSON, and restore concatenates the chunks and
    imports them wholesale (app.go:240-257). Snapshot hash = sha256 of the
    serialized state.
    """

    def __init__(
        self,
        db: Optional[DB] = None,
        snapshot_interval: int = 0,
        chunk_size: int = 1_000_000,
    ):
        super().__init__(db)
        self.snapshot_interval = snapshot_interval
        self.chunk_size = chunk_size
        self._snapshots: List[abci.Snapshot] = []
        self._snapshot_data: Dict[int, bytes] = {}  # height → serialized state
        self._restore_snapshot: Optional[abci.Snapshot] = None
        self._restore_chunks: List[bytes] = []

    # -- export / import ----------------------------------------------------

    def _export_state(self) -> bytes:
        pairs = {}
        for key, value in self.state.db.prefix_iterator(_KV_PREFIX):
            pairs[base64.b64encode(key[len(_KV_PREFIX):]).decode()] = (
                base64.b64encode(value).decode()
            )
        vals = {}
        for key, raw in self.state.db.prefix_iterator(_VALIDATOR_PREFIX):
            vals[key[len(_VALIDATOR_PREFIX):].decode()] = base64.b64encode(
                raw
            ).decode()
        return json.dumps(
            {
                "height": self.state.height,
                "size": self.state.size,
                "app_hash": base64.b64encode(self.state.app_hash).decode(),
                "pairs": pairs,
                "validators": vals,
            },
            sort_keys=True,
        ).encode()

    def _import_state(self, height: int, data: bytes) -> None:
        doc = json.loads(data)
        if doc["height"] != height:
            raise ValueError(
                f"snapshot height mismatch: {doc['height']} != {height}"
            )
        for key, value in doc["pairs"].items():
            self.state.db.set(
                _KV_PREFIX + base64.b64decode(key), base64.b64decode(value)
            )
        for key, raw in doc["validators"].items():
            self.state.db.set(
                _VALIDATOR_PREFIX + key.encode(), base64.b64decode(raw)
            )
        self.state.height = doc["height"]
        self.state.size = doc["size"]
        self.state.app_hash = base64.b64decode(doc["app_hash"])
        self.state.save()
        self._load_validators()

    # -- abci snapshot connection -------------------------------------------

    def commit(self):
        resp = super().commit()
        if (
            self.snapshot_interval > 0
            and self.state.height % self.snapshot_interval == 0
        ):
            import hashlib
            import math

            data = self._export_state()
            self._snapshot_data[self.state.height] = data
            self._snapshots.append(
                abci.Snapshot(
                    height=self.state.height,
                    format=1,
                    chunks=max(1, math.ceil(len(data) / self.chunk_size)),
                    hash=hashlib.sha256(data).digest(),
                )
            )
            # only the most recent snapshots are ever advertised
            # (statesync RECENT_SNAPSHOTS) — prune the rest
            while len(self._snapshots) > RECENT_SNAPSHOTS:
                old = self._snapshots.pop(0)
                self._snapshot_data.pop(old.height, None)
        return resp

    def list_snapshots(self, req):
        return abci.ResponseListSnapshots(snapshots=list(self._snapshots))

    def load_snapshot_chunk(self, req):
        data = self._snapshot_data.get(req.height)
        if data is None or req.format != 1:
            return abci.ResponseLoadSnapshotChunk(chunk=b"")
        start = req.chunk * self.chunk_size
        return abci.ResponseLoadSnapshotChunk(
            chunk=data[start : start + self.chunk_size]
        )

    def offer_snapshot(self, req):
        if self._restore_snapshot is not None:
            # an abandoned partial restore (e.g. the syncer timed out on
            # chunks and moved to another snapshot) must not poison every
            # future offer — drop the stale attempt and take the new one
            self._restore_snapshot = None
            self._restore_chunks = []
        if req.snapshot is None or req.snapshot.format != 1:
            return abci.ResponseOfferSnapshot(
                result=abci.OFFER_SNAPSHOT_REJECT_FORMAT
            )
        self._restore_snapshot = req.snapshot
        self._restore_chunks = []
        return abci.ResponseOfferSnapshot(result=abci.OFFER_SNAPSHOT_ACCEPT)

    def apply_snapshot_chunk(self, req):
        if self._restore_snapshot is None:
            raise RuntimeError("no restore in progress")
        self._restore_chunks.append(req.chunk)
        if len(self._restore_chunks) == self._restore_snapshot.chunks:
            self._import_state(
                self._restore_snapshot.height, b"".join(self._restore_chunks)
            )
            self._restore_snapshot = None
            self._restore_chunks = []
        return abci.ResponseApplySnapshotChunk(
            result=abci.APPLY_CHUNK_ACCEPT
        )
