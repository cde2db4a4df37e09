"""The port's VerifyScheduler (cometbft_tpu_torch/crypto/scheduler.py)
against the JAX package's (cometbft_tpu/crypto/scheduler.py), on the CPU.

Every case runs the same script in both packages, over ``"cpu"``, a
gated CPU verifier (a wedged device plane the test releases) or a
fault-injected supervisor on one virtual fault domain, with flushes made
deterministic (explicit ``flush()``, deadlines far off or short and
waited for); the verdicts, the flush reasons, the dispatch counts, the
QoS lanes' counters and the overload outcomes must be equal:

* coalescing: three requests, one with a bad signature, ride one
  explicit flush, and each future gets its own slice (demux);
* the flush reasons: size (the lane budget reached), deadline, explicit,
  drain (stop) and broken (an open breaker flushes at once);
* QoS assembly: consensus strictly first, then the lower classes by
  weighted deficit round-robin; a drain takes everything in class order;
* bounded submit: a block-policy submit past the queue bound waits out
  its deadline and verifies inline on the CPU; a shed-policy one sheds
  after the class's shed deadline; a drop-policy one is ``rejected``;
  a browned-out class (the supervisor degraded) is dropped;
* stop: a wedged worker's pending futures fail loudly; a stopped or
  never-started scheduler answers inline;
* the decision ledger: one record a flush, with the route taken, the
  router and the fallback events;
* a stress run: twelve submitting threads under a 10 µs switch interval,
  every future its own verdicts, none lost, the counts adding up.

Then the port alone, over the plain-twin gpu verifier registered as
``"gpu-plain"`` behind a supervisor: a commit verified with the
scheduler as its backend takes the resident route (one key-store upload,
no flush), and consensus's batch preverify through
``new_batch_verifier(scheduler, subsystem="consensus")`` feeds a VoteSet
whose verdicts and commit equal the reference's on "cpu".

One test loops over every case (see tests/test_torch_field.py for why
each of these files holds one test).
"""

import itertools
import os
import sys
import threading

import torch
import torch_chain as tc
import torch_plane as tp

from cometbft_tpu.proto.gogo import Timestamp as RefTimestamp
from cometbft_tpu.types import test_util
from cometbft_tpu.types.vote import SIGNED_MSG_TYPE_PRECOMMIT
from cometbft_tpu.types.vote_set import VoteSet as RefVoteSet
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import batch as port_batch
from cometbft_tpu_torch.crypto.cuda import keystore
from cometbft_tpu_torch.types.block import BlockID
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.types.vote_set import VoteSet

torch.set_num_threads(1)

FAR = 10_000_000  # µs: a deadline no case waits for
_names = itertools.count()


def gated(pkg):
    """A CPU verifier whose verify() waits for the gate: a wedged plane."""
    gate, entered = threading.Event(), threading.Event()

    class Gated(pkg.batch.CPUBatchVerifier):
        def verify(self):
            entered.set()
            gate.wait()
            return super().verify()

    name = f"plane-gated-{pkg.name}-{next(_names)}"
    pkg.batch.register_backend(name, Gated)
    return pkg.batch.BackendSpec(name), gate, entered


def results(futs):
    return [(f.result(timeout=30), f.rejected) for f in futs]


def coalesce(pkg):
    s = pkg.scheduler.VerifyScheduler(spec="cpu", flush_us=FAR)
    s.start()
    try:
        reqs = [tp.make_items(pkg, 3, b"c0"), tp.make_items(pkg, 4, b"c1", poison=(1,)), tp.make_items(pkg, 2, b"c2")]
        futs = [s.submit(r, subsystem=sub) for r, sub in zip(reqs, ("consensus", "blocksync", "light"))]
        s.flush()
        out = {"results": results(futs), "dispatches": s.n_dispatches}
    finally:
        s.stop()
    snap = s.queue_snapshot()
    out["reasons"], out["routes"] = snap["flush_reasons"], {k: v for k, v in snap["routes"].items() if k != "service"}
    out["signatures"] = s.metrics.signatures.value()
    return out


def flush_reasons(pkg):
    out = {}
    s = pkg.scheduler.VerifyScheduler(spec="cpu", flush_us=FAR, lane_budget=8)
    s.start()
    a, b = s.submit(tp.make_items(pkg, 4, b"s0")), s.submit(tp.make_items(pkg, 4, b"s1"))
    out["size"] = results([a, b])
    s.stop()
    out["size_reasons"] = dict(s.queue_snapshot()["flush_reasons"])
    s = pkg.scheduler.VerifyScheduler(spec="cpu", flush_us=20_000)
    s.start()
    out["deadline"] = results([s.submit(tp.make_items(pkg, 2, b"d0"))])
    s.stop()
    out["deadline_reasons"] = dict(s.queue_snapshot()["flush_reasons"])
    s = pkg.scheduler.VerifyScheduler(spec="cpu", flush_us=FAR)
    s.start()
    fut = s.submit(tp.make_items(pkg, 2, b"dr"))
    s.stop()
    out["drain"] = results([fut])
    out["drain_reasons"] = dict(s.queue_snapshot()["flush_reasons"])
    plan, sup = tp.faulty(pkg, seed=21, breaker_threshold=1, plan_kw={"exception_rate": 1.0})
    sup.verify_items(tp.make_items(pkg, 2, b"trip"))
    s = pkg.scheduler.VerifyScheduler(spec=sup.spec, flush_us=FAR, supervisor=sup)
    s.start()
    out["broken"] = results([s.submit(tp.make_items(pkg, 3, b"br", poison=(0,)))])
    s.stop()
    sup.stop()
    out["broken_reasons"] = dict(s.queue_snapshot()["flush_reasons"])
    out["broken_metric"] = s.metrics.flushes.with_labels(reason="broken").value()
    return out


def qos_assembly(pkg):
    s = pkg.scheduler.VerifyScheduler(spec="cpu", flush_us=FAR, lane_budget=100_000, qos="default")
    s.start()
    out = {}
    try:
        futs = []
        for sub, n in (("mempool", 4), ("consensus", 2), ("light", 2), ("evidence", 1), ("blocksync", 4)):
            for i in range(n):
                futs.append(s.submit(tp.make_items(pkg, 4, sub.encode() + bytes([i])), subsystem=sub))
        with s._cond:
            first = s._assemble_locked(12, unbounded=False)
            second = s._assemble_locked(12, unbounded=False)
            rest = s._assemble_locked(1, unbounded=True)
        out["order"] = [[(r.qclass, r.subsystem) for r in b] for b in (first, second, rest)]
        s._dispatch(first + second + rest, "explicit")
        out["results"] = results(futs)
        out["snapshot"] = s.queue_snapshot()["qos"]
    finally:
        s.stop()
    return out


def bounded_submit(pkg):
    out = {}
    spec, gate, entered = gated(pkg)
    os.environ["CBFT_SUBMIT_TIMEOUT_MS"] = "100"
    try:
        s = pkg.scheduler.VerifyScheduler(spec=spec, flush_us=500, max_queue=8)
        s.start()
        a = s.submit(tp.make_items(pkg, 8, b"ba"))
        assert entered.wait(10)
        b = s.submit(tp.make_items(pkg, 8, b"bb"))
        c = s.submit(tp.make_items(pkg, 4, b"bc", poison=(1,)))  # waits 100 ms, then inline CPU
        out["inline"] = (c.done(), c.result(timeout=0))
        gate.set()
        out["results"] = results([a, b])
        s.stop()
        out["metrics"] = (s.metrics.backpressure_waits.value(), s.metrics.backpressure_timeouts.value())
    finally:
        del os.environ["CBFT_SUBMIT_TIMEOUT_MS"]
        gate.set()
    spec, gate, entered = gated(pkg)
    os.environ["CBFT_QOS_SHED_MS"] = "50"
    try:
        s = pkg.scheduler.VerifyScheduler(
            spec=spec, flush_us=500, qos="consensus,blocksync:shed:4,mempool:drop:4",
        )
        s.start()
        first = s.submit(tp.make_items(pkg, 2, b"q0"), subsystem="consensus")
        assert entered.wait(10)
        futs = [
            s.submit(tp.make_items(pkg, 4, b"q1"), subsystem="blocksync"),
            s.submit(tp.make_items(pkg, 4, b"q2", poison=(3,)), subsystem="blocksync"),  # shed inline
            s.submit(tp.make_items(pkg, 4, b"q3"), subsystem="mempool"),
            s.submit(tp.make_items(pkg, 4, b"q4"), subsystem="mempool"),  # dropped
        ]
        out["early"] = [(f.done(), f.rejected) for f in futs]
        gate.set()
        out["qos_results"] = results([first] + futs)
        s.on_supervisor_state("degraded")  # brownout: mempool first
        out["brownout"] = s.brownout.disabled()
        dropped = s.submit(tp.make_items(pkg, 2, b"q5"), subsystem="mempool")
        out["browned_out"] = (dropped.done(), dropped.rejected, dropped.result(timeout=0))
        s.stop()
        out["qos"] = s.queue_snapshot()["qos"]["classes"]
    finally:
        del os.environ["CBFT_QOS_SHED_MS"]
        gate.set()
    return out


def stopping(pkg):
    out = {}
    spec, gate, entered = gated(pkg)
    s = pkg.scheduler.VerifyScheduler(spec=spec, flush_us=500, join_timeout_s=0.2)
    s.start()
    a = s.submit(tp.make_items(pkg, 2, b"w0"))
    assert entered.wait(10)
    b = s.submit(tp.make_items(pkg, 2, b"w1"))
    s.stop()
    out["wedged"] = [tc.outcome(lambda f=f: f.result(timeout=0)) for f in (a, b)]
    gate.set()
    s = pkg.scheduler.VerifyScheduler(spec="cpu", flush_us=FAR)
    fut = s.submit(tp.make_items(pkg, 3, b"in", poison=(2,)))  # never started: inline
    out["inline"] = (fut.done(), fut.result(timeout=0), dict(s.queue_snapshot()["flush_reasons"]))
    s.start()
    s.stop()
    fut = s.submit(tp.make_items(pkg, 1, b"post"))
    out["after_stop"] = (fut.done(), fut.result(timeout=0))
    return out


def decision_records(pkg):
    led = pkg.decisions.DecisionLedger()
    prev = pkg.decisions.set_default_ledger(led)
    try:
        plan, sup = tp.faulty(pkg, seed=22, breaker_threshold=1)
        s = pkg.scheduler.VerifyScheduler(spec=sup.spec, flush_us=FAR, supervisor=sup, router="threshold")
        s.start()
        futs = [s.submit(tp.make_items(pkg, 3, b"r0"))]
        s.flush()
        futs[0].result(timeout=30)
        plan.exception_rate = 1.0
        futs.append(s.submit(tp.make_items(pkg, 3, b"r1", poison=(1,))))
        s.flush()
        out = {"results": results(futs)}
        s.stop()
        sup.stop()
        out["counts"] = led.counts()
        out["records"] = [
            {k: r[k] for k in ("n", "bucket", "reason", "taken", "final", "router", "events", "feasible", "breakers")}
            for r in led.snapshot()["recent"]
        ]
        out["routes"] = {k: v for k, v in s.queue_snapshot()["routes"].items() if k != "service"}
    finally:
        pkg.decisions.set_default_ledger(prev)
    return out


CASES = (coalesce, flush_reasons, qos_assembly, bounded_submit, stopping, decision_records)


def stress(pkg):
    """Twelve threads submit 15 requests each under a 10 µs switch
    interval through a small lane budget: every future completes with
    its own slice, none is lost, and the counts add up."""

    class Parity(pkg.batch.CPUBatchVerifier):
        def verify(self):
            items, self._items = self._items, []
            mask = [sig[0] % 2 == 0 for _, _, sig in items]
            return all(mask), mask

    pkg.batch.register_backend("plane-parity", Parity)
    s = pkg.scheduler.VerifyScheduler(spec=pkg.batch.BackendSpec("plane-parity"), flush_us=200, lane_budget=16)
    s.start()
    bad, want_total = [], [0]
    lock = threading.Lock()
    pk = tp.key(pkg, b"stress").pub_key()

    def submitter(t):
        for r in range(15):
            n = 1 + (t + r) % 5
            items = [(pk, b"m", bytes([(t * 31 + r * 7 + i) % 256]) * 64) for i in range(n)]
            want = [it[2][0] % 2 == 0 for it in items]
            got = s.submit(items, subsystem=("consensus", "blocksync", "light")[t % 3]).result(timeout=30)
            with lock:
                want_total[0] += n
                if got != (all(want), want):
                    bad.append((t, r, got, want))

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submitter, args=(t,)) for t in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        alive = [t for t in threads if t.is_alive()]
    finally:
        sys.setswitchinterval(prev)
        s.stop()
    return {"alive": len(alive), "bad": bad, "requests": s.metrics.requests.value(),
            "signatures": s.metrics.signatures.value() == want_total[0], "coalesced": 0 < s.n_dispatches <= 180}


def check_against_reference():
    tp.compare(CASES)
    got = coalesce(tp.PORT)
    assert got["dispatches"] == 1 and got["reasons"]["explicit"] == 1, got
    assert [r[0] for r in got["results"]] == [(True, [True] * 3), (False, [True, False, True, True]), (True, [True] * 2)]
    got = bounded_submit(tp.PORT)
    assert got["early"] == [(False, False), (True, False), (False, False), (True, True)], got["early"]
    for pkg in tp.BOTH:
        got = stress(pkg)
        assert got == {"alive": 0, "bad": [], "requests": 180, "signatures": True, "coalesced": True}, (pkg.name, got)


def check_resident_route_and_vote_set():
    """The port over the plain twins behind a supervisor and a scheduler."""
    tp.register_plain()
    vals, pvs = tc.make_set([f"sv{i}" for i in range(5)], seed=13)
    bid = test_util.make_block_id(b"\x07" * 32)
    height = 12
    votes = [
        test_util.make_vote(pv, tc.CHAIN_ID, i, height, 0, SIGNED_MSG_TYPE_PRECOMMIT, bid, RefTimestamp(tc.T0 + i, 0))
        for i, pv in enumerate(pvs)
    ]
    commit = test_util.make_commit(bid, height, 0, vals, pvs, tc.CHAIN_ID, votes[0].timestamp)
    port_vals = tc.port_vals(vals)
    sup = tp.PORT.supervisor.BackendSupervisor(
        spec=tp.PLAIN, audit_pct=100, audit_sync=True, hedge_pct=0,
        topology=tp.PORT.topology.DeviceTopology.virtual(1),
    )
    sched = tp.PORT.scheduler.VerifyScheduler(spec=tp.PLAIN, flush_us=50_000, supervisor=sup)
    sched.start()
    try:
        store = keystore.default_store()
        store.invalidate()
        base = store.snapshot()["stats"]
        assert port_batch.resident_commit_eligible(5, sched) and port_batch.backend_device(sched) == torch.device("cpu")
        want = tc.outcome(lambda: vals.verify_commit(tc.CHAIN_ID, bid, height, commit, backend="cpu"))
        got = tc.outcome(lambda: port_vals.verify_commit(
            tc.CHAIN_ID, BlockID.decode(bid.encode()), height, convert.commit_from_reference(commit.encode()),
            backend=sched))
        assert got == want is None
        st = store.snapshot()["stats"]
        assert st["uploads"] - base["uploads"] == 1 and sched.n_dispatches == 0, st
        # consensus's preverify through the scheduler, one corrupted vote
        port_votes = [Vote.decode(v.encode()) for v in votes]
        port_votes[2].signature = port_votes[2].signature[:3] + bytes([port_votes[2].signature[3] ^ 1]) + \
            port_votes[2].signature[4:]
        ref_votes = [type(v).decode(v.encode()) for v in votes]
        ref_votes[2].signature = port_votes[2].signature
        bv = port_batch.new_batch_verifier(sched, subsystem="consensus")
        ref_bv = tp.ref_batch.new_batch_verifier("cpu")
        for pv_, rv in zip(port_votes, ref_votes):
            bv.add(port_vals.validators[pv_.validator_index].pub_key, pv_.sign_bytes(tc.CHAIN_ID), pv_.signature)
            ref_bv.add(vals.validators[rv.validator_index].pub_key, rv.sign_bytes(tc.CHAIN_ID), rv.signature)
        mask = bv.verify()  # one flush, at the 50 ms deadline
        assert mask == ref_bv.verify() == (False, [True, True, False, True, True])
        assert sched.n_dispatches == 1 and st["indexed_dispatches"] < store.snapshot()["stats"]["indexed_dispatches"]
        for v, ok in zip(port_votes, mask[1]):
            if ok:
                v.sig_batch_verified = (tc.CHAIN_ID, port_vals.validators[v.validator_index].pub_key.bytes())
        vs = VoteSet(tc.CHAIN_ID, height, 0, SIGNED_MSG_TYPE_PRECOMMIT, port_vals)
        ref_vs = RefVoteSet(tc.CHAIN_ID, height, 0, SIGNED_MSG_TYPE_PRECOMMIT, vals)
        got = [tc.outcome(lambda v=v: vs.add_vote(v)) for v in port_votes]
        want = [tc.outcome(lambda v=v: ref_vs.add_vote(v)) for v in ref_votes]
        assert got == want, (got, want)
        assert vs.make_commit().encode() == ref_vs.make_commit().encode()
        assert sup.state() == "healthy" and sup.metrics.cpu_verdicts.value() == 0
        assert sched.metrics.cpu_fallbacks.value() == 0
    finally:
        sched.stop()
        sup.stop()


def test_scheduler_matches_reference():
    check_against_reference()
    check_resident_route_and_vote_set()
