"""The port's ABCI layer (cometbft_tpu_torch/abci/types.py,
application.py, client.py, kvstore.py and proxy/) against the JAX
package's, on the CPU.

The same script of requests goes to a kvstore app behind each package's
proxy (``new_app_conns`` over a local client creator; the consensus,
mempool, query and snapshot connections): info, init_chain with the
genesis validators, check_tx (good, bad, a malformed ``val:``),
begin_block with a real header and LastCommitInfo, deliver_tx (kvstore
pairs, raw bytes, a ``val:`` that changes a power, one that adds a key,
one that removes a validator, one that removes a stranger, malformed
ones), end_block, commit, then queries (a key, a missing key, ``/val``,
``/hash`` style paths) and the snapshot calls, over two blocks. Every
request and response must encode to the same bytes, as the Request and
Response oneofs, and the port must decode the reference's bytes back to
the same encoding. A case for each kvstore app: the in-memory one, the
persistent one with validator updates, the snapshotting one.
"""

import pytest
import torch
import torch_state_chain as sc

torch.set_num_threads(1)

APPS = {
    "kvstore": lambda p: p.kvstore.KVStoreApplication(),
    "persistent": lambda p: p.kvstore.PersistentKVStoreApplication(p.db.MemDB()),
    "snapshot": lambda p: p.kvstore.SnapshotKVStoreApplication(p.db.MemDB(), snapshot_interval=1, chunk_size=64),
}


def script(pkg: str, app_name: str):
    """Every (request, response) of the script, as oneof bytes."""
    chain = sc.Chain(pkg, 4, 7, "cpu")
    p = chain.pkg
    a = p.abci
    conns = p.proxy.new_app_conns(p.client.new_local_client_creator(APPS[app_name](p)))
    conns.start()
    cons, mem, query, snap = conns.consensus(), conns.mempool(), conns.query(), conns.snapshot()
    out = []

    def call(kind, conn_fn, req, *args):
        res = conn_fn(req, *args) if req is not None else conn_fn(*args)
        out.append((a.Request(kind, req if req is not None else a.RequestCommit()).encode(),
                    a.Response(kind, res).encode()))
        return res

    vals = chain.state.validators.validators
    updates = [a.ValidatorUpdate(p.keys.pub_key_to_proto(v.pub_key), v.voting_power) for v in vals]
    call("info", query.info_sync, a.RequestInfo(version="0.34.28", block_version=11, p2p_version=8))
    call("init_chain", cons.init_chain_sync, a.RequestInitChain(
        time=chain.genesis.genesis_time, chain_id=sc.CHAIN_ID, validators=updates, initial_height=1))
    new_key = sc.signer(p, b"abci-new").get_pub_key().bytes()
    for h in (1, 2):
        block, _, _ = chain.propose(h, sc.kv_txs(h, 3, 60, 7))
        for tx in (b"a=b", b"raw-bytes", b"val:no-bang"):
            call("check_tx", mem.check_tx_sync, a.RequestCheckTx(tx=tx))
        info = a.LastCommitInfo(round=0, votes=[
            a.VoteInfo(validator=a.Validator(v.address, v.voting_power), signed_last_block=i % 2 == 0)
            for i, v in enumerate(vals)
        ])
        call("begin_block", cons.begin_block_sync, a.RequestBeginBlock(
            hash=block.hash(), header=block.header, last_commit_info=info))
        txs = list(block.data.txs) + [b"k%d=v" % h, b"plain%d" % h, b"=empty-key", b"val:@@@!1",
                                      b"val:" + b"x" * 4 + b"!notanumber"]
        if h == 1:
            txs += [sc.val_tx(vals[0].pub_key.bytes(), 55), sc.val_tx(new_key, 9)]
        else:
            txs += [sc.val_tx(vals[1].pub_key.bytes(), 0), sc.val_tx(b"\x01" * 32, 0)]
        for tx in txs:
            rr = cons.deliver_tx_async(a.RequestDeliverTx(tx=bytes(tx)))
            cons.flush_sync()
            res = rr.wait()
            out.append((a.Request("deliver_tx", a.RequestDeliverTx(tx=bytes(tx))).encode(), res.encode()))
        call("end_block", cons.end_block_sync, a.RequestEndBlock(height=h))
        call("commit", cons.commit_sync, None)
        for path, data in (("", b"k%d" % h), ("", b"missing"), ("/val", vals[0].address),
                           ("/val", b"\x00" * 20), ("/store", b"k1")):
            call("query", query.query_sync, a.RequestQuery(data=data, path=path, height=h))
        snaps = call("list_snapshots", snap.list_snapshots_sync, a.RequestListSnapshots())
        for s in snaps.snapshots:
            for chunk in range(s.chunks):
                call("load_snapshot_chunk", snap.load_snapshot_chunk_sync,
                     a.RequestLoadSnapshotChunk(height=s.height, format=s.format, chunk=chunk))
    call("info", query.info_sync, a.RequestInfo())
    conns.stop()
    chain.stop()
    return out


@pytest.mark.parametrize("app", sorted(APPS))
def test_abci_script_matches_reference(app):
    from cometbft_tpu_torch.abci import types as port_abci

    want = script(sc.REF, app)
    got = script(sc.PORT, app)
    assert len(got) == len(want)
    for i, ((wreq, wres), (greq, gres)) in enumerate(zip(want, got)):
        assert greq == wreq, i
        assert gres == wres, (i, port_abci.Response.decode(gres), port_abci.Response.decode(wres))
        assert port_abci.Request.decode(wreq).encode() == wreq, i
        assert port_abci.Response.decode(wres).encode() == wres, i
