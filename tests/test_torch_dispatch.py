"""The port's chunked dispatch (cometbft_tpu_torch/crypto/cuda/mesh.py) on
the CPU.

* ``verify_batch(device="cpu")`` with a chunk cap of 64 at n in
  {63, 64, 65, 129} keeps lane order across chunk edges, as
  tests/test_wire_format.py::TestChunkedCompactDispatch checks for the
  reference; the oracles are the port's CPU verifier and the reference's
  ``crypto/ed25519.py``;
* the loop itself, with a kernel that echoes its lanes: chunks of at most
  the cap, in order, chunk i+1 packed right after chunk i is launched,
  numpy arrays copied to the device and tensors and None passed through;
* a set cancel event raises ``DispatchCancelled`` at the next chunk edge;
* an invalid ``CBFT_TPU_MAX_CHUNK`` raises; the configured cap yields to
  the environment;
* a gpu verifier's flush on the keyed route, and ``"cpu"``'s, give Python
  bools.

Verdicts are compared with exact equality. One test runs every check
(see tests/test_torch_field.py for why each of these files holds one
test).
"""

import json
import threading

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu_torch.crypto import batch as port_batch
from cometbft_tpu_torch.crypto import ed25519 as ed
from cometbft_tpu_torch.crypto import purepy
from cometbft_tpu_torch.crypto.cuda import ed25519_batch, keystore, mesh

torch.set_num_threads(1)


def _batch(n, corrupt_every):
    keys = [ed.gen_priv_key_from_secret(b"chunk-%d" % (i % 7)) for i in range(n)]
    msgs = [b"chunk msg %d" % i for i in range(n)]
    sigs = [k.sign(m) for k, m in zip(keys, msgs)]
    for i in range(0, n, corrupt_every):
        s = bytearray(sigs[i])
        s[i % 64] ^= 0x01
        sigs[i] = bytes(s)
    return [k.pub_key().bytes() for k in keys], msgs, sigs


def check_chunk_edges_keep_lane_order(monkeypatch):
    monkeypatch.setenv("CBFT_TPU_MAX_CHUNK", "64")
    monkeypatch.setenv("CBFT_TPU_HASH", "host")
    pks, msgs, sigs = _batch(129, corrupt_every=9)
    want = [purepy.ed25519_verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    assert want == [ref_ed.PubKeyEd25519(p).verify_signature(m, s) for p, m, s in zip(pks, msgs, sigs)]
    assert want.count(False) == 15
    chunks = []
    real = ed25519_batch.verify_kernel_compact

    def counted(wire):
        chunks.append(wire.shape[1])
        return real(wire)

    monkeypatch.setattr(ed25519_batch, "verify_kernel_compact", counted)
    for n in (63, 64, 65, 129):
        chunks.clear()
        assert ed25519_batch.verify_batch(pks[:n], msgs[:n], sigs[:n], device="cpu") == want[:n]
        assert chunks == [64] * (n // 64) + ([n % 64] if n % 64 else [])


def check_loop_order(monkeypatch):
    events = []

    def packed(start, end):
        events.append(("stage", start))
        lanes = np.arange(start, end, dtype=np.int64)
        return [lanes % 3 == 0, torch.tensor([start]), None]

    def kernel(mask, start, none):
        assert none is None and isinstance(mask, torch.Tensor)
        events.append(("launch", int(start)))
        return mask

    monkeypatch.setenv("CBFT_TPU_MAX_CHUNK", "10")
    out = mesh.dispatch_batch(kernel, packed, 45, 8192, "cpu")
    assert out.tolist() == [i % 3 == 0 for i in range(45)]
    starts = list(range(0, 45, 10))
    assert [e[1] for e in events if e[0] == "launch"] == starts
    # chunk i+1 is packed right after chunk i launches
    events.clear()
    mesh.dispatch_batch(kernel, packed, 25, 8192, "cpu")
    assert events == [("stage", 0), ("launch", 0), ("stage", 10), ("launch", 10), ("stage", 20), ("launch", 20)]
    assert mesh.dispatch_batch(kernel, packed, 0, 8192, "cpu").tolist() == []


def check_cancel_at_a_chunk_edge(monkeypatch):
    monkeypatch.setenv("CBFT_TPU_MAX_CHUNK", "4")
    cancel = threading.Event()
    launched = []

    def packed(start, end):
        return [np.ones(end - start, bool)]

    def kernel(mask):
        launched.append(mask.shape[0])
        cancel.set()  # the watchdog gives up while chunk 0 runs
        return mask

    assert mesh.current_cancel_event() is None
    with mesh.cancel_scope(cancel):
        assert mesh.current_cancel_event() is cancel
        with pytest.raises(mesh.DispatchCancelled, match="before chunk 1"):
            mesh.dispatch_batch(kernel, packed, 10, 8192, "cpu")
    assert mesh.current_cancel_event() is None
    assert launched == [4]


def check_knobs(monkeypatch):
    assert mesh.chunk_cap(8192) == 8192 and ed25519_batch.MAX_CHUNK == 8192
    try:
        mesh.configure_chunk_cap(100)
        assert mesh.chunk_cap(8192) == 100
        monkeypatch.setenv("CBFT_TPU_MAX_CHUNK", "300")
        assert mesh.resolve_chunk_cap(8192) == 300
    finally:
        mesh.configure_chunk_cap(None)
    for bad in ("abc", "0", "-64", "1.5"):
        monkeypatch.setenv("CBFT_TPU_MAX_CHUNK", bad)
        with pytest.raises(ValueError, match="CBFT_TPU_MAX_CHUNK"):
            mesh.chunk_cap(8192)
    with pytest.raises(ValueError, match="max_chunk"):
        mesh.configure_chunk_cap(0)


def check_keyed_and_cpu_verdicts_are_bools(monkeypatch):
    """A flush that no resident set covers takes the keyed route; its
    verdicts, like "cpu"'s, are Python bools in input order."""
    store = keystore.default_store()
    store.invalidate()
    pks, msgs, sigs = _batch(7, corrupt_every=3)
    want = [purepy.ed25519_verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    base = store.snapshot()["stats"]["indexed_dispatches"]
    for backend in (lambda: port_batch.GPUBatchVerifier(device="cpu"), "cpu"):
        bv = port_batch.new_batch_verifier(backend)
        for p, m, s in zip(pks, msgs, sigs):
            bv.add(ed.PubKeyEd25519(p), m, s)
        ok, mask = bv.verify()
        assert (ok, mask) == (False, want) and want.count(False) == 3
        assert all(type(v) is bool for v in mask)
        assert json.loads(json.dumps(mask)) == want
    assert store.snapshot()["stats"]["indexed_dispatches"] == base


def test_chunked_dispatch(monkeypatch):
    for check in (check_chunk_edges_keep_lane_order, check_loop_order,
                  check_cancel_at_a_chunk_edge, check_knobs,
                  check_keyed_and_cpu_verdicts_are_bools):
        with monkeypatch.context() as m:
            check(m)
