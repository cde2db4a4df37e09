"""The Application interface every ABCI app implements.

Ported from cometbft_tpu/abci/application.py.

Reference: abci/types/application.go:11-32 (Application) and :35
(BaseApplication — the no-op base). One method per ABCI request; consensus
drives Info/InitChain/BeginBlock/DeliverTx/EndBlock/Commit, the mempool
drives CheckTx, RPC drives Query, statesync drives the snapshot calls.
"""

from __future__ import annotations

from cometbft_tpu_torch.abci import types as abci


class Application:
    # Info/Query connection
    def info(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        raise NotImplementedError

    def set_option(self, req: abci.RequestSetOption) -> abci.ResponseSetOption:
        raise NotImplementedError

    def query(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        raise NotImplementedError

    # Mempool connection
    def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        raise NotImplementedError

    # Consensus connection
    def init_chain(self, req: abci.RequestInitChain) -> abci.ResponseInitChain:
        raise NotImplementedError

    def begin_block(self, req: abci.RequestBeginBlock) -> abci.ResponseBeginBlock:
        raise NotImplementedError

    def deliver_tx(self, req: abci.RequestDeliverTx) -> abci.ResponseDeliverTx:
        raise NotImplementedError

    def end_block(self, req: abci.RequestEndBlock) -> abci.ResponseEndBlock:
        raise NotImplementedError

    def commit(self) -> abci.ResponseCommit:
        raise NotImplementedError

    # State-sync connection
    def list_snapshots(
        self, req: abci.RequestListSnapshots
    ) -> abci.ResponseListSnapshots:
        raise NotImplementedError

    def offer_snapshot(
        self, req: abci.RequestOfferSnapshot
    ) -> abci.ResponseOfferSnapshot:
        raise NotImplementedError

    def load_snapshot_chunk(
        self, req: abci.RequestLoadSnapshotChunk
    ) -> abci.ResponseLoadSnapshotChunk:
        raise NotImplementedError

    def apply_snapshot_chunk(
        self, req: abci.RequestApplySnapshotChunk
    ) -> abci.ResponseApplySnapshotChunk:
        raise NotImplementedError


class BaseApplication(Application):
    """Returns empty/OK responses for everything — apps override a subset."""

    def info(self, req):
        return abci.ResponseInfo()

    def set_option(self, req):
        return abci.ResponseSetOption()

    def query(self, req):
        return abci.ResponseQuery(code=abci.CODE_TYPE_OK)

    def check_tx(self, req):
        return abci.ResponseCheckTx(code=abci.CODE_TYPE_OK)

    def init_chain(self, req):
        return abci.ResponseInitChain()

    def begin_block(self, req):
        return abci.ResponseBeginBlock()

    def deliver_tx(self, req):
        return abci.ResponseDeliverTx(code=abci.CODE_TYPE_OK)

    def end_block(self, req):
        return abci.ResponseEndBlock()

    def commit(self):
        return abci.ResponseCommit()

    def list_snapshots(self, req):
        return abci.ResponseListSnapshots()

    def offer_snapshot(self, req):
        return abci.ResponseOfferSnapshot()

    def load_snapshot_chunk(self, req):
        return abci.ResponseLoadSnapshotChunk()

    def apply_snapshot_chunk(self, req):
        return abci.ResponseApplySnapshotChunk()


def dispatch_request(app: Application, req: abci.Request) -> abci.Response:
    """Route one Request envelope to the app → Response envelope (the shared
    core of the local client and the socket server)."""
    kind, value = req.kind, req.value
    try:
        if kind == "echo":
            return abci.Response("echo", abci.ResponseEcho(value.message))
        if kind == "flush":
            return abci.Response("flush", abci.ResponseFlush())
        if kind == "info":
            return abci.Response("info", app.info(value))
        if kind == "set_option":
            return abci.Response("set_option", app.set_option(value))
        if kind == "init_chain":
            return abci.Response("init_chain", app.init_chain(value))
        if kind == "query":
            return abci.Response("query", app.query(value))
        if kind == "begin_block":
            return abci.Response("begin_block", app.begin_block(value))
        if kind == "check_tx":
            return abci.Response("check_tx", app.check_tx(value))
        if kind == "deliver_tx":
            return abci.Response("deliver_tx", app.deliver_tx(value))
        if kind == "end_block":
            return abci.Response("end_block", app.end_block(value))
        if kind == "commit":
            return abci.Response("commit", app.commit())
        if kind == "list_snapshots":
            return abci.Response("list_snapshots", app.list_snapshots(value))
        if kind == "offer_snapshot":
            return abci.Response("offer_snapshot", app.offer_snapshot(value))
        if kind == "load_snapshot_chunk":
            return abci.Response(
                "load_snapshot_chunk", app.load_snapshot_chunk(value)
            )
        if kind == "apply_snapshot_chunk":
            return abci.Response(
                "apply_snapshot_chunk", app.apply_snapshot_chunk(value)
            )
        return abci.Response("exception", abci.ResponseException("unknown request"))
    except Exception as e:  # app panics become ResponseException on the wire
        return abci.Response("exception", abci.ResponseException(str(e)))
