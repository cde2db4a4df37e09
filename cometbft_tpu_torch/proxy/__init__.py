"""proxy — the node's four logical ABCI connections.

Ported from cometbft_tpu/proxy/__init__.py.

Reference: proxy/multi_app_conn.go:47-55 (consensus/mempool/query/snapshot
clients from one ClientCreator) and proxy/app_conn.go:13-52 (per-connection
interfaces with the Sync/Async split). Here each AppConn is a thin facade
over a Client; the facades keep call sites honest about which connection
they use.
"""

from __future__ import annotations

from typing import Callable, Optional

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci.client import Client, ReqRes
from cometbft_tpu_torch.abci.client import (  # noqa: F401  (re-exports)
    new_local_client_creator,
    new_socket_client_creator,
)
from cometbft_tpu_torch.libs.service import BaseService

ClientCreator = Callable[[], Client]


class AppConnConsensus:
    def __init__(self, client: Client):
        self._client = client

    def error(self) -> Optional[Exception]:
        return self._client.error()

    def init_chain_sync(self, req: abci.RequestInitChain) -> abci.ResponseInitChain:
        return self._client.init_chain_sync(req)

    def begin_block_sync(
        self, req: abci.RequestBeginBlock
    ) -> abci.ResponseBeginBlock:
        return self._client.begin_block_sync(req)

    def deliver_tx_async(self, req: abci.RequestDeliverTx) -> ReqRes:
        return self._client.deliver_tx_async(req)

    def end_block_sync(self, req: abci.RequestEndBlock) -> abci.ResponseEndBlock:
        return self._client.end_block_sync(req)

    def commit_sync(self) -> abci.ResponseCommit:
        return self._client.commit_sync()

    def flush_sync(self) -> None:
        self._client.flush_sync()


class AppConnMempool:
    def __init__(self, client: Client):
        self._client = client

    def error(self) -> Optional[Exception]:
        return self._client.error()

    def check_tx_async(self, req: abci.RequestCheckTx) -> ReqRes:
        return self._client.check_tx_async(req)

    def check_tx_sync(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        return self._client.check_tx_sync(req)

    def flush_async(self) -> ReqRes:
        return self._client.flush_async()

    def flush_sync(self) -> None:
        self._client.flush_sync()


class AppConnQuery:
    def __init__(self, client: Client):
        self._client = client

    def error(self) -> Optional[Exception]:
        return self._client.error()

    def echo_sync(self, msg: str) -> abci.ResponseEcho:
        return self._client.echo_sync(msg)

    def info_sync(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        return self._client.info_sync(req)

    def query_sync(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        return self._client.query_sync(req)


class AppConnSnapshot:
    def __init__(self, client: Client):
        self._client = client

    def error(self) -> Optional[Exception]:
        return self._client.error()

    def list_snapshots_sync(
        self, req: abci.RequestListSnapshots
    ) -> abci.ResponseListSnapshots:
        return self._client.list_snapshots_sync(req)

    def offer_snapshot_sync(
        self, req: abci.RequestOfferSnapshot
    ) -> abci.ResponseOfferSnapshot:
        return self._client.offer_snapshot_sync(req)

    def load_snapshot_chunk_sync(
        self, req: abci.RequestLoadSnapshotChunk
    ) -> abci.ResponseLoadSnapshotChunk:
        return self._client.load_snapshot_chunk_sync(req)

    def apply_snapshot_chunk_sync(
        self, req: abci.RequestApplySnapshotChunk
    ) -> abci.ResponseApplySnapshotChunk:
        return self._client.apply_snapshot_chunk_sync(req)


class AppConns(BaseService):
    """Owns the four clients' lifecycle (reference: multiAppConn)."""

    def __init__(self, client_creator: ClientCreator):
        super().__init__("proxyAppConns")
        self._creator = client_creator
        self._consensus_client: Optional[Client] = None
        self._mempool_client: Optional[Client] = None
        self._query_client: Optional[Client] = None
        self._snapshot_client: Optional[Client] = None

    def on_start(self) -> None:
        self._query_client = self._creator()
        self._snapshot_client = self._creator()
        self._mempool_client = self._creator()
        self._consensus_client = self._creator()
        for c in self._clients():
            c.start()

    def on_stop(self) -> None:
        for c in self._clients():
            if c.is_running():
                c.stop()

    def _clients(self):
        return [
            c
            for c in (
                self._query_client,
                self._snapshot_client,
                self._mempool_client,
                self._consensus_client,
            )
            if c is not None
        ]

    def consensus(self) -> AppConnConsensus:
        return AppConnConsensus(self._consensus_client)

    def mempool(self) -> AppConnMempool:
        return AppConnMempool(self._mempool_client)

    def query(self) -> AppConnQuery:
        return AppConnQuery(self._query_client)

    def snapshot(self) -> AppConnSnapshot:
        return AppConnSnapshot(self._snapshot_client)


def new_app_conns(client_creator: ClientCreator) -> AppConns:
    return AppConns(client_creator)
