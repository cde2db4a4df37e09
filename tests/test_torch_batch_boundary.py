"""The rest of the port's batch boundary (cometbft_tpu_torch/crypto/batch.py)
against the JAX package's (cometbft_tpu/crypto/batch.py:26-66, :413-494),
on the CPU.

* BackendSpec, unwrap_backend and backend_name resolve every form a
  backend travels in: a name, a spec, a scheduler (``.submit`` +
  ``.spec``), a supervisor (``.verify_items`` + ``.spec``); the registry
  (register_backend, set_default_backend, default_backend) and
  supports_batch_verification answer as the reference's, the port's
  default being "gpu";
* new_batch_verifier takes ``subsystem=``: under a scheduler both
  packages build a ScheduledBatchVerifier that submits the collected
  items once, tagged with the subsystem, and returns the scheduler's
  answer; under a supervisor both build a SupervisedBatchVerifier that
  hands the collected items to ``verify_items`` once and answers with
  its mask;
* routing resolves through the spec: ``resident_commit_eligible`` is
  true under ``BackendSpec("gpu")`` and under a scheduler whose spec is
  "gpu" (``torch.cuda.is_available`` patched: the check builds the
  verifier and launches nothing), false under "cpu"; ``backend_device``
  names the card, the host tree (None) or the plain twin's device;
* a verify_commit under a scheduler whose spec names the plain-twin gpu
  verifier takes the resident route (one key-store upload), and gives
  the reference's "cpu" verdicts, errors included;
* ``BackendSpec.max_chunk`` reaches ``crypto/cuda/mesh.py``'s chunk cap
  for that verifier only: a 5-lane keyed flush under a cap of 2 launches
  the compact kernel's plain twin three times, and the cap is gone after.

One test runs every check (see tests/test_torch_field.py for why each of
these files holds one test).
"""

import copy

import torch
import torch_chain as tc

from cometbft_tpu.crypto import batch as ref_batch
from cometbft_tpu.crypto import secp256k1 as ref_secp
from cometbft_tpu.crypto import sr25519 as ref_sr
from cometbft_tpu.types import test_util
from cometbft_tpu.types.block import CommitSig as RefCommitSig
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import PubKey
from cometbft_tpu_torch.crypto import batch as port_batch
from cometbft_tpu_torch.crypto import secp256k1 as secp
from cometbft_tpu_torch.crypto import sr25519 as sr
from cometbft_tpu_torch.crypto.cuda import ed25519_batch, keystore, mesh
from cometbft_tpu_torch.crypto.ed25519 import PubKeyEd25519
from cometbft_tpu_torch.types.block import BlockID

torch.set_num_threads(1)

PLAIN = "gpu-plain-twin"


class _Scheduler:
    """A scheduler as crypto/scheduler.py shapes one: ``.submit`` returns
    a future, ``.spec`` names the backend behind it."""

    def __init__(self, spec, answer=(True, [True])):
        self.spec = spec
        self.answer = answer
        self.calls = []

    def submit(self, items, subsystem=None):
        self.calls.append(([(pk.bytes(), m, s) for pk, m, s in items], subsystem))
        answer = self.answer

        class _Future:
            def result(self):
                return answer

        return _Future()


class _Supervisor:
    """A supervisor as crypto/supervisor.py shapes one: ``.verify_items``
    returns a mask, ``.spec`` names the backend behind it."""

    spec = ref_batch.BackendSpec("cpu")

    def __init__(self, mask=(True,)):
        self.mask = list(mask)
        self.calls = []

    def verify_items(self, items):
        self.calls.append([(pk.bytes(), m, s) for pk, m, s in items])
        return list(self.mask)


class _OtherKey(PubKey):
    def bytes(self) -> bytes:
        return b"\x02" * 32

    def type(self) -> str:
        return "bls12_381"


def _fields(backend):
    """A name as is, a spec as its fields (the two packages' BackendSpec
    classes differ)."""
    if isinstance(backend, str):
        return backend
    return (type(backend).__name__, backend.name, backend.min_batch, backend.max_chunk)


def check_resolution():
    port_spec = port_batch.BackendSpec("cpu", min_batch=7, max_chunk=64)
    ref_spec = ref_batch.BackendSpec("cpu", min_batch=7, max_chunk=64)
    assert (port_spec.name, port_spec.min_batch, port_spec.max_chunk) == (ref_spec.name, ref_spec.min_batch, ref_spec.max_chunk)
    for port_b, ref_b in (("cpu", "cpu"), (port_spec, ref_spec), (_Scheduler(port_spec), _Scheduler(ref_spec)),
                          (_Scheduler("cpu"), _Scheduler("cpu"))):
        assert port_batch.backend_name(port_b) == ref_batch.backend_name(ref_b)
        assert _fields(port_batch.unwrap_backend(port_b)) == _fields(ref_batch.unwrap_backend(ref_b))
    assert _fields(port_batch.unwrap_backend(_Supervisor())) == _fields(ref_batch.unwrap_backend(_Supervisor()))
    assert port_batch.backend_name(None) == port_batch.default_backend() == "gpu"
    assert port_batch.backend_name(tc.gpu_on_cpu) is None
    for name in ("nope",):
        want = tc.outcome(lambda: ref_batch.set_default_backend(name))
        assert tc.outcome(lambda: port_batch.set_default_backend(name)) == want
        want = tc.outcome(lambda: ref_batch.new_batch_verifier(ref_batch.BackendSpec(name)))
        assert tc.outcome(lambda: port_batch.new_batch_verifier(port_batch.BackendSpec(name))) == want
    port_batch.set_default_backend("cpu")
    try:
        assert isinstance(port_batch.new_batch_verifier(), port_batch.CPUBatchVerifier)
        assert port_batch.resident_commit_eligible(5) is False
    finally:
        port_batch.set_default_backend("gpu")
    assert port_batch.default_backend() == "gpu"
    keys = [
        (PubKeyEd25519(b"\x01" * 32), tc.signers(["k"])[0].get_pub_key()),
        (secp.gen_priv_key_from_secret(b"k").pub_key(), ref_secp.gen_priv_key_from_secret(b"k").pub_key()),
        (sr.gen_priv_key_from_secret(b"k").pub_key(), ref_sr.gen_priv_key_from_secret(b"k").pub_key()),
    ]
    for port_key, ref_key in keys:
        assert port_batch.supports_batch_verification(port_key) == ref_batch.supports_batch_verification(ref_key) is True
    assert port_batch.supports_batch_verification(_OtherKey()) is False


def check_scheduler_and_supervisor():
    pvs = tc.signers(["s0", "s1"])
    items = [(pv.get_pub_key(), b"msg%d" % i, pv.priv_key.sign(b"msg%d" % i)) for i, pv in enumerate(pvs)]
    port_items = [(PubKeyEd25519(pk.bytes()), m, s) for pk, m, s in items]
    ref_s, port_s = _Scheduler("cpu", (True, [True, True])), _Scheduler("cpu", (True, [True, True]))
    ref_bv = ref_batch.new_batch_verifier(ref_s, subsystem="consensus")
    port_bv = port_batch.new_batch_verifier(port_s, subsystem="consensus")
    assert type(port_bv).__name__ == type(ref_bv).__name__ == "ScheduledBatchVerifier"
    assert port_bv.verify() == ref_bv.verify() == (False, [])
    for (pk, m, s), (ppk, pm, ps) in zip(items, port_items):
        ref_bv.add(pk, m, s)
        port_bv.add(ppk, pm, ps)
    assert port_bv.count() == ref_bv.count() == 2
    assert port_bv.verify() == ref_bv.verify() == (True, [True, True])
    assert port_s.calls == ref_s.calls and port_s.calls[0][1] == "consensus"
    assert tc.outcome(lambda: port_bv.add(None, b"", b"")) == tc.outcome(lambda: ref_bv.add(None, b"", b""))
    for sub in (None, "blocksync", "light"):
        assert isinstance(port_batch.new_batch_verifier("cpu", subsystem=sub), port_batch.CPUBatchVerifier)
    ref_sup, port_sup = _Supervisor([True, False]), _Supervisor([True, False])
    ref_bv = ref_batch.new_batch_verifier(ref_sup, subsystem="consensus")
    port_bv = port_batch.new_batch_verifier(port_sup, subsystem="consensus")
    assert type(port_bv).__name__ == type(ref_bv).__name__ == "SupervisedBatchVerifier"
    assert port_bv.verify() == ref_bv.verify() == (False, [])
    for (pk, m, s), (ppk, pm, ps) in zip(items, port_items):
        ref_bv.add(pk, m, s)
        port_bv.add(ppk, pm, ps)
    assert port_bv.count() == ref_bv.count() == 2
    assert port_bv.verify() == ref_bv.verify() == (False, [True, False])
    assert port_sup.calls == ref_sup.calls and len(port_sup.calls) == 1


def check_routing_through_the_spec(monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        for backend in (port_batch.BackendSpec("gpu"), _Scheduler(port_batch.BackendSpec("gpu")), _Scheduler("gpu"), None):
            assert port_batch.resident_commit_eligible(180, backend) is True, backend
            assert port_batch.backend_device(backend).type == "cuda"
            assert port_batch.resident_commit_eligible(0, backend) is False
    for backend in ("cpu", port_batch.BackendSpec("cpu"), _Scheduler("cpu"), _Scheduler(port_batch.BackendSpec("cpu"))):
        assert port_batch.resident_commit_eligible(180, backend) is False
        assert port_batch.backend_device(backend) is None
    assert port_batch.backend_device(tc.gpu_on_cpu) == torch.device("cpu")
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        for backend in (port_batch.BackendSpec("gpu"), _Scheduler("gpu")):
            got = tc.outcome(lambda: port_batch.resident_commit_eligible(180, backend))
            assert got[0] == "RuntimeError" and "CUDA" in got[1]


def check_commit_under_a_scheduler():
    vals, pvs = tc.make_set([f"r{i}" for i in range(5)], seed=9)
    bid = test_util.make_block_id()
    commit = test_util.make_commit(bid, 3, 0, vals, pvs, tc.CHAIN_ID)
    bad = copy.deepcopy(commit)
    bad.signatures[2].signature = bad.signatures[2].signature[:-1] + b"\x00"
    under = copy.deepcopy(commit)
    for i in range(3):
        under.signatures[i] = RefCommitSig.absent()
    port_vals = tc.port_vals(vals)
    port_bid = BlockID.decode(bid.encode())
    scheduler = _Scheduler(port_batch.BackendSpec(PLAIN))
    keystore.default_store().invalidate()
    base = keystore.default_store().snapshot()["stats"]
    for label, c in (("signed", commit), ("corrupted", bad), ("under 2/3", under)):
        want = tc.outcome(lambda: vals.verify_commit(tc.CHAIN_ID, bid, 3, c, backend="cpu"))
        port_c = convert.commit_from_reference(c.encode())
        for backend in (scheduler, port_batch.BackendSpec(PLAIN)):
            got = tc.outcome(lambda: port_vals.verify_commit(tc.CHAIN_ID, port_bid, 3, port_c, backend=backend))
            assert got == want, (label, got, want)
    st = keystore.default_store().snapshot()["stats"]
    assert st["uploads"] - base["uploads"] == 1 and st["hits"] - base["hits"] == 5, st
    assert scheduler.calls == []  # the resident route, not the scheduler's dispatch


def check_max_chunk(monkeypatch):
    pvs = tc.signers([f"c{i}" for i in range(5)])
    keystore.default_store().invalidate()
    launches = []
    real = ed25519_batch.verify_kernel_compact
    monkeypatch.setattr(ed25519_batch, "verify_kernel_compact", lambda *a: launches.append(a[0].shape[-1]) or real(*a))
    items = [(PubKeyEd25519(pv.get_pub_key().bytes()), b"m%d" % i, pv.priv_key.sign(b"m%d" % i)) for i, pv in enumerate(pvs)]
    items[3] = (items[3][0], items[3][1], b"\x00" * 64)
    want = (False, [True, True, True, False, True])
    for spec, chunks in ((port_batch.BackendSpec(PLAIN, max_chunk=2), 3), (port_batch.BackendSpec(PLAIN), 1)):
        launches.clear()
        bv = port_batch.new_batch_verifier(spec)
        assert bv.max_chunk == spec.max_chunk
        for it in items:
            bv.add(*it)
        assert bv.verify() == want
        assert len(launches) == chunks, (spec, launches)
    assert mesh.resolve_chunk_cap(8192) == 8192


def test_batch_boundary_matches_reference(monkeypatch):
    port_batch.register_backend(PLAIN, tc.gpu_on_cpu)
    try:
        check_resolution()
        check_scheduler_and_supervisor()
        check_routing_through_the_spec(monkeypatch)
        check_commit_under_a_scheduler()
        with monkeypatch.context() as m:
            check_max_chunk(m)
    finally:
        port_batch._registry.pop(PLAIN, None)
