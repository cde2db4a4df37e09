"""ABCI clients: in-process (local) and socket (out-of-process).

Ported from cometbft_tpu/abci/client.py.

Reference: abci/client/local_client.go:29 (one shared mutex around the
app), abci/client/socket_client.go:119,153 (pipelined send/recv routines
over a length-prefixed proto stream, FIFO request/response matching,
Flush batching). The async surface (``*_async`` returning a ReqRes with a
completion callback) is what the mempool's CheckTx pipeline builds on.
"""

from __future__ import annotations

import queue
import socket
import threading
from typing import Callable, List, Optional

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci.application import Application, dispatch_request
from cometbft_tpu_torch.libs import protoio
from cometbft_tpu_torch.libs.service import BaseService


class ReqRes:
    """A request paired with its (eventually delivered) response."""

    def __init__(self, request: abci.Request):
        self.request = request
        self.response: Optional[abci.Response] = None
        self._done = threading.Event()
        self._cb: Optional[Callable[[abci.Response], None]] = None
        self._mtx = threading.Lock()

    def set_callback(self, cb: Callable[[abci.Response], None]) -> None:
        """Runs cb immediately if the response already arrived."""
        with self._mtx:
            if self.response is not None:
                cb(self.response)
                return
            self._cb = cb

    def set_done(self, response: abci.Response) -> None:
        with self._mtx:
            self.response = response
            cb = self._cb
        if cb is not None:
            cb(response)
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> abci.Response:
        if not self._done.wait(timeout):
            raise TimeoutError("ABCI request timed out")
        return self.response


class ClientError(Exception):
    pass


def _unwrap(res: abci.Response, want: str):
    if res.kind == "exception":
        raise ClientError(res.value.error)
    if res.kind != want:
        raise ClientError(f"unexpected response {res.kind!r}, want {want!r}")
    return res.value


class Client(BaseService):
    """Common surface: sync wrappers over the async primitives."""

    def request_async(self, req: abci.Request) -> ReqRes:
        raise NotImplementedError

    def flush_sync(self) -> None:
        raise NotImplementedError

    def error(self) -> Optional[Exception]:
        return None

    # -- sync helpers (reference AppConn*Sync methods) ----------------------

    def _call(self, kind: str, value) -> object:
        rr = self.request_async(abci.Request(kind, value))
        self.flush_sync()
        return _unwrap(rr.wait(), kind)

    def echo_sync(self, msg: str) -> abci.ResponseEcho:
        return self._call("echo", abci.RequestEcho(msg))

    def info_sync(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        return self._call("info", req)

    def set_option_sync(self, req: abci.RequestSetOption) -> abci.ResponseSetOption:
        return self._call("set_option", req)

    def query_sync(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        return self._call("query", req)

    def init_chain_sync(self, req: abci.RequestInitChain) -> abci.ResponseInitChain:
        return self._call("init_chain", req)

    def begin_block_sync(
        self, req: abci.RequestBeginBlock
    ) -> abci.ResponseBeginBlock:
        return self._call("begin_block", req)

    def check_tx_sync(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        return self._call("check_tx", req)

    def deliver_tx_sync(self, req: abci.RequestDeliverTx) -> abci.ResponseDeliverTx:
        return self._call("deliver_tx", req)

    def end_block_sync(self, req: abci.RequestEndBlock) -> abci.ResponseEndBlock:
        return self._call("end_block", req)

    def commit_sync(self) -> abci.ResponseCommit:
        return self._call("commit", abci.RequestCommit())

    def list_snapshots_sync(
        self, req: abci.RequestListSnapshots
    ) -> abci.ResponseListSnapshots:
        return self._call("list_snapshots", req)

    def offer_snapshot_sync(
        self, req: abci.RequestOfferSnapshot
    ) -> abci.ResponseOfferSnapshot:
        return self._call("offer_snapshot", req)

    def load_snapshot_chunk_sync(
        self, req: abci.RequestLoadSnapshotChunk
    ) -> abci.ResponseLoadSnapshotChunk:
        return self._call("load_snapshot_chunk", req)

    def apply_snapshot_chunk_sync(
        self, req: abci.RequestApplySnapshotChunk
    ) -> abci.ResponseApplySnapshotChunk:
        return self._call("apply_snapshot_chunk", req)

    # -- async helpers used by the mempool ----------------------------------

    def check_tx_async(self, req: abci.RequestCheckTx) -> ReqRes:
        return self.request_async(abci.Request("check_tx", req))

    def deliver_tx_async(self, req: abci.RequestDeliverTx) -> ReqRes:
        return self.request_async(abci.Request("deliver_tx", req))

    def flush_async(self) -> ReqRes:
        return self.request_async(abci.Request("flush", abci.RequestFlush()))


class LocalClient(Client):
    """In-process app behind one shared mutex (builtin mode)."""

    def __init__(self, app: Application, mtx: Optional[threading.Lock] = None):
        super().__init__("LocalClient")
        self._app = app
        self._app_mtx = mtx or threading.Lock()

    def request_async(self, req: abci.Request) -> ReqRes:
        rr = ReqRes(req)
        with self._app_mtx:
            res = dispatch_request(self._app, req)
        rr.set_done(res)
        return rr

    def flush_sync(self) -> None:
        pass


class SocketClient(Client):
    """Pipelined client over a unix/TCP socket.

    A writer thread drains the request queue (flushing after each Flush
    request); a reader thread matches responses FIFO against in-flight
    ReqRes — the same two-routine structure as the reference's
    sendRequestsRoutine/recvResponseRoutine.
    """

    def __init__(self, addr: str, must_connect: bool = False):
        super().__init__("SocketClient")
        self._addr = addr
        self._must_connect = must_connect
        self._sock: Optional[socket.socket] = None
        self._queue: "queue.Queue[Optional[ReqRes]]" = queue.Queue()
        self._pending: "queue.Queue[ReqRes]" = queue.Queue()
        self._err: Optional[Exception] = None
        self._err_mtx = threading.Lock()

    def error(self) -> Optional[Exception]:
        with self._err_mtx:
            return self._err

    def on_start(self) -> None:
        self._sock = _dial(self._addr)
        self._wfile = self._sock.makefile("wb")
        self._rfile = self._sock.makefile("rb")
        threading.Thread(target=self._send_loop, daemon=True).start()
        threading.Thread(target=self._recv_loop, daemon=True).start()

    def on_stop(self) -> None:
        self._queue.put(None)
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass

    def _fail(self, e: Exception) -> None:
        with self._err_mtx:
            if self._err is None:
                self._err = e
        # unblock everything in flight AND everything still queued to send
        for q in (self._pending, self._queue):
            while True:
                try:
                    rr = q.get_nowait()
                except queue.Empty:
                    break
                if rr is not None:
                    rr.set_done(
                        abci.Response("exception", abci.ResponseException(str(e)))
                    )

    def _send_loop(self) -> None:
        while self.is_running():
            rr = self._queue.get()
            if rr is None:
                return
            try:
                self._pending.put(rr)
                protoio.write_delimited(self._wfile, rr.request.encode())
                if rr.request.kind == "flush":
                    self._wfile.flush()
            except OSError as e:
                self._fail(e)
                return

    def _recv_loop(self) -> None:
        while self.is_running():
            try:
                data = protoio.read_delimited(self._rfile)
                res = abci.Response.decode(data)
            except (OSError, EOFError, ValueError) as e:
                self._fail(e)
                return
            try:
                rr = self._pending.get_nowait()
            except queue.Empty:
                self._fail(ClientError("unexpected response with nothing in flight"))
                return
            if res.kind not in ("exception", rr.request.kind):
                self._fail(
                    ClientError(
                        f"response {res.kind!r} does not match request "
                        f"{rr.request.kind!r}"
                    )
                )
                return
            rr.set_done(res)

    def request_async(self, req: abci.Request) -> ReqRes:
        rr = ReqRes(req)
        err = self.error()
        if err is not None:
            rr.set_done(abci.Response("exception", abci.ResponseException(str(err))))
            return rr
        self._queue.put(rr)
        return rr

    def flush_sync(self) -> None:
        rr = self.flush_async()
        rr.wait(timeout=30)
        err = self.error()
        if err is not None:
            raise ClientError(str(err))


def _dial(addr: str) -> socket.socket:
    """'unix://path', 'tcp://host:port', or bare 'host:port'."""
    if addr.startswith("unix://"):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(addr[len("unix://") :])
        return s
    if addr.startswith("tcp://"):
        addr = addr[len("tcp://") :]
    host, _, port = addr.rpartition(":")
    s = socket.create_connection((host or "127.0.0.1", int(port)))
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return s


def new_local_client_creator(app: Application) -> Callable[[], Client]:
    mtx = threading.Lock()
    return lambda: LocalClient(app, mtx)


def new_socket_client_creator(addr: str) -> Callable[[], Client]:
    return lambda: SocketClient(addr)
