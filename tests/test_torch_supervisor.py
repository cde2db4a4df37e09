"""The port's BackendSupervisor and fault injection
(cometbft_tpu_torch/crypto/supervisor.py, crypto/faults.py) against the
JAX package's (cometbft_tpu/crypto/supervisor.py, crypto/faults.py), on
the CPU.

Every case runs the same script in both packages: a FaultyBackend over
``"cpu"`` on the same seeded FaultPlan, a supervisor over it on one
virtual fault domain (hedging off except in the hedge case, canary
backoff long so that only explicit probes run), and the same seeded
items; the released masks, the breaker states and every counter both
packages keep must be equal:

* the breaker walk HEALTHY → DEGRADED → BROKEN over three exception
  dispatches, CPU routing while broken, a failing canary doubling its
  backoff, then a passing canary re-admitting the backend and the next
  batch reaching it again;
* the corruption audit, synchronous (the CPU's verdicts released, the
  breaker tripped) and in the background;
* the watchdog on a hang: the dispatch abandoned, the breaker tripped,
  the zombie thread gone at its cancel event;
* the OOM ladder: an out-of-memory fault (while the cap is wider than
  the plan's allocator model allows) halves the chunk-cap gauge,
  ``chunk_recover_n`` clean dispatches bring it back;
* transient retry: one flap retried clean, two flaps a failure;
* triage: a mixed mask localised on the device and charged to the
  submitting subsystems through the scheduler's origins;
* a hedge the CPU wins against a slow device;
* a short chaos soak (``run_chaos_soak``) on one seed: no lost future, no
  wrong verdict, the backend re-admitted;
* ``classify_device_error`` on the reference's spellings, and on CUDA's
  in the port (out of memory is OOM; a sticky launch error is persistent
  whatever else it says).

Then the port alone, over the plain-twin gpu verifier registered as
``"gpu-plain"``: the routes resolved through the supervisor's spec (the
resident commit route, the device), the indexed route through the key
store, a fault plan in front of the gpu routes, ``warmup_canary`` and the
``verify_supervisor_cpu_verdicts`` count of every CPU-released batch;
and the port's lane caps on the background audit and on hedging, with
the CPU ladder forced to pure Python.

One test loops over every case (see tests/test_torch_field.py for why
each of these files holds one test).
"""

import os
import threading

import torch
import torch_plane as tp

from cometbft_tpu_torch import native
from cometbft_tpu_torch.crypto import batch as port_batch
from cometbft_tpu_torch.crypto.cuda import keystore
from cometbft_tpu_torch.crypto.supervisor import classify_device_error

torch.set_num_threads(1)


def breaker_walk(pkg):
    plan, sup = tp.faulty(pkg, seed=3, breaker_threshold=3)
    items = tp.make_items(pkg, 6, b"walk", poison=(2,))
    want = tp.cpu_mask(pkg, items)
    out = {"states": [], "masks": []}
    plan.exception_rate = 1.0
    for _ in range(3):
        out["masks"].append(sup.verify_items(items) == want)
        out["states"].append(sup.state())
    before = plan.dispatches
    out["masks"].append(sup.verify_items(items) == want)  # broken: CPU, the backend untouched
    out["untouched"] = plan.dispatches == before
    out["failed_probe"] = sup.probe_now()
    out["backoff_doubled"] = sup._backoff_s == 2 * 60.0
    plan.clear()
    out["probe"] = sup.probe_now()
    out["states"].append(sup.state())
    before = plan.dispatches
    out["masks"].append(sup.verify_items(items) == want)
    out["reached_again"] = plan.dispatches > before
    out["summary"] = tp.sup_summary(sup)
    sup.stop()
    return out


def audit_sync(pkg):
    plan, sup = tp.faulty(pkg, seed=4, audit_pct=100, audit_sync=True)
    items = tp.make_items(pkg, 5, b"audit", poison=(4,))
    out = {"clean": sup.verify_items(items) == tp.cpu_mask(pkg, items), "state0": sup.state()}
    plan.corrupt_rate = 1.0
    out["corrupt"] = sup.verify_items(items) == tp.cpu_mask(pkg, items)
    out["summary"] = tp.sup_summary(sup)
    sup.stop()
    return out


def audit_background(pkg):
    plan, sup = tp.faulty(pkg, seed=5, audit_pct=100, audit_sync=False, plan_kw={"corrupt_rate": 1.0})
    items = tp.make_items(pkg, 4, b"bg")
    flipped = [not v for v in tp.cpu_mask(pkg, items)]
    out = {"released": sup.verify_items(items)}
    tp.wait_for(lambda: sup.metrics.audit_mismatches.value() >= 1, what="the background audit")
    tp.wait_for(lambda: sup.state() == "broken", what="the audit trip")
    out["released_flipped_lanes"] = sum(a == b for a, b in zip(out.pop("released"), flipped))
    out["summary"] = tp.sup_summary(sup)
    sup.stop()
    return out


def watchdog(pkg):
    plan, sup = tp.faulty(pkg, seed=6, dispatch_timeout_ms=150, plan_kw={"hang_rate": 1.0, "hang_s": 30.0})
    items = tp.make_items(pkg, 4, b"hang", poison=(0,))
    base = tp.live_threads("supervised-dispatch")
    out = {"mask": sup.verify_items(items) == tp.cpu_mask(pkg, items)}
    tp.wait_for(lambda: tp.live_threads("supervised-dispatch") <= base, what="the zombie's exit")
    out["zombie_gone"] = True
    out["summary"] = tp.sup_summary(sup)
    sup.stop()
    return out


def oom_ladder(pkg):
    plan, sup = tp.faulty(pkg, seed=7, chunk_recover_n=2, plan_kw={"oom_rate": 1.0, "oom_above_lanes": 4096})
    items = tp.make_items(pkg, 4, b"oom")
    gauges = [sup.metrics.chunk_cap.value()]
    out = {"masks": []}
    for _ in range(3):
        out["masks"].append(sup.verify_items(items) == tp.cpu_mask(pkg, items))
        gauges.append(sup.metrics.chunk_cap.value())
    out["gauges"] = gauges
    out["ooms_fired"] = plan.ooms_fired
    out["summary"] = tp.sup_summary(sup)
    sup.stop()
    return out


def transient(pkg):
    out = {}
    for n in (1, 2):
        plan, sup = tp.faulty(pkg, seed=8, plan_kw={"transient_n": n})
        items = tp.make_items(pkg, 3, b"flap")
        out[n] = (sup.verify_items(items) == tp.cpu_mask(pkg, items), tp.sup_summary(sup))
        sup.stop()
    return out


def triage(pkg):
    plan, sup = tp.faulty(pkg, seed=9)
    items = tp.make_items(pkg, 12, b"triage", poison=(2, 9, 10))
    origins = [(5, "consensus", 10), (7, "blocksync", 11)]
    out = {"mask": sup.verify_items(items, reason="size", origins=origins), "want": tp.cpu_mask(pkg, items)}
    out["summary"] = tp.sup_summary(sup)
    sup.stop()
    return out


def hedge(pkg):
    plan, sup = tp.faulty(pkg, seed=10, hedge_pct=100, dispatch_timeout_ms=10_000)
    items = tp.make_items(pkg, 2, b"hedge")
    for _ in range(3):  # warm the latency model's bucket
        sup.verify_items(items)
    plan.hang_rate, plan.hang_s = 1.0, 3.0
    out = {"mask": sup.verify_items(items) == tp.cpu_mask(pkg, items)}
    plan.clear()
    tp.wait_for(lambda: tp.live_threads("supervisor-hedge-relay") == 0, what="the hedge relay")
    out["summary"] = tp.sup_summary(sup)
    sup.stop()
    return out


def soak(pkg):
    # the invariants only: which dispatches a loaded host lets the
    # watchdog kill (and so the breaker's last state) is timing's
    got = pkg.faults.run_chaos_soak(n_blocks=8, batch=9, seed=11, dispatch_timeout_ms=1000, probe_base_ms=10)
    return {k: got[k] for k in ("blocks", "batch", "regimes", "wrong_verdicts", "lost_futures", "readmitted",
                                "device_resumed_after_recovery")}


CASES = (breaker_walk, audit_sync, audit_background, watchdog, oom_ladder, transient, triage, hedge, soak)


def check_against_reference():
    tp.compare(CASES)
    # the walk's own sense, beyond equality
    walk = breaker_walk(tp.PORT)
    assert walk["states"] == ["degraded", "degraded", "broken", "healthy"] and all(walk["masks"]), walk
    assert walk["untouched"] and walk["reached_again"] and walk["probe"] and not walk["failed_probe"]
    oom = oom_ladder(tp.PORT)
    # halved by the OOM, recovered after two clean dispatches, halved
    # again when the recovered cap is once more too wide for the model
    assert oom["gauges"] == [8192, 4096, 8192, 4096] and oom["ooms_fired"] == 2, oom


def check_classify():
    spellings = [
        RuntimeError("RESOURCE_EXHAUSTED: out of HBM"),
        RuntimeError("UNAVAILABLE: socket closed"),
        RuntimeError("boom"),
        RuntimeError("DEADLINE_EXCEEDED while waiting"),
        ValueError("zoomed in"),
    ]
    for exc in spellings:
        assert classify_device_error(exc) == tp.ref_supervisor.classify_device_error(exc), exc
    chained = RuntimeError("chunk 3 failed")
    chained.__cause__ = RuntimeError("unavailable: try again")
    assert classify_device_error(chained) == tp.ref_supervisor.classify_device_error(chained) == "transient"
    cuda = {
        "oom": [
            torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
            RuntimeError("ed25519_verify_resident: CUDA launch failed (cudaError 2: out of memory)"),
        ],
        "persistent": [
            RuntimeError("CUDA error: an illegal memory access was encountered"),
            RuntimeError("secp256k1_verify: CUDA launch failed (cudaError 700: an illegal memory access was "
                         "encountered); try again"),
            RuntimeError("CUDA error: unspecified launch failure (out of memory?)"),
            RuntimeError("CUDA error: device-side assert triggered"),
        ],
    }
    for want, excs in cuda.items():
        for exc in excs:
            assert classify_device_error(exc) == want, exc


def check_port_gpu_routes():
    """Over the plain-twin gpu verifier: the indexed route, a fault plan
    in front of the gpu routes, the canary, the CPU-verdict count."""
    tp.register_plain()
    items = tp.make_items(tp.PORT, 6, b"gpu", poison=(4,))
    want = tp.cpu_mask(tp.PORT, items)
    store = keystore.default_store()
    store.invalidate()
    sup = tp.PORT.supervisor.BackendSupervisor(
        spec=tp.PLAIN, audit_pct=100, audit_sync=True, hedge_pct=0,
        topology=tp.PORT.topology.DeviceTopology.virtual(1),
    )
    assert sup.verify_items(items, route="indexed") == want  # nothing resident: the partition path
    assert sup.metrics.indexed_fallbacks.value() == 1
    # every route resolves through the supervisor's spec
    assert port_batch.backend_device(sup) == torch.device("cpu") and port_batch.resident_commit_eligible(6, sup)
    pks = [pk.bytes() for pk, _, _ in items]
    assert port_batch.verify_commit_valset(pks, [m for _, m, _ in items], [s for _, _, s in items], sup) == want
    base = store.snapshot()["stats"]["indexed_dispatches"]
    assert sup.verify_items(items, route="indexed") == want
    assert sup.metrics.indexed_dispatches.value() == 1
    assert store.snapshot()["stats"]["indexed_dispatches"] == base + 1
    assert sup.verify_items(items, route="sharded") == want  # no multi-card mesh: the fall-through
    assert sup.metrics.sharded_fallbacks.value() == 1
    bv = port_batch.new_batch_verifier(sup)
    for it in items:
        bv.add(*it)
    assert bv.verify() == (False, want)
    sup.warmup_canary()
    tp.wait_for(lambda: tp.total(sup.metrics.probes) >= 1, what="the warm-up canary")
    assert sup.state() == "healthy" and sup.metrics.cpu_verdicts.value() == 0
    # audited: the partition path, the sharded fall-through, the verifier's
    # flush; the indexed route releases unaudited, as the reference's does
    assert sup.metrics.audit_mismatches.value() == 0 and sup.metrics.audits.value() == 3
    sup.stop()
    # faults in front of the gpu routes: the walk, verdicts always right
    plan, sup = tp.faulty(tp.PORT, seed=12, inner=tp.PLAIN, breaker_threshold=3, dispatch_timeout_ms=60_000)
    plan.exception_rate = 1.0
    for _ in range(3):
        assert sup.verify_items(items) == want
    assert sup.state() == "broken" and sup.metrics.cpu_verdicts.value() == 3
    assert sup.verify_items(items) == want and sup.metrics.cpu_routed.value() == 1
    assert sup.metrics.cpu_verdicts.value() == 4
    plan.clear()
    assert sup.probe_now() and sup.state() == "healthy"
    before = plan.dispatches
    assert sup.verify_items(items) == want and plan.dispatches > before
    sup.stop()
    # a stuck zombie must not keep the process: the worker threads are daemons
    assert all(t.daemon for t in threading.enumerate() if t.name.startswith("supervis"))


def check_port_lane_caps():
    """The port's two lane caps (the reference has neither), which hold
    while the CPU ladder stands on pure Python (forced here: the native
    rung turned off): a background audit of a wider batch re-verifies a
    sample of ``AUDIT_MAX_LANES`` lanes, and still catches a corrupted
    dispatch; a dispatch wider than ``HEDGE_MAX_LANES`` is never hedged,
    however late; the synchronous audit checks the whole batch whatever
    the cap. tests/test_torch_supervisor_native.py holds the native
    rung, where the caps do not apply."""
    sv = tp.PORT.supervisor
    assert (sv.AUDIT_MAX_LANES, sv.HEDGE_MAX_LANES) == (256, 256)
    try:
        os.environ["CBFT_NATIVE_ED25519"] = "0"
        native.reset()
        assert native.rung() == native.PUREPY and sv.lane_caps_apply()
        items = tp.make_items(tp.PORT, 8, b"caps", poison=(6,))
        want = tp.cpu_mask(tp.PORT, items)
        # every lane bad, every verdict flipped to good: no triage, and any
        # sample of the released mask disagrees with the CPU
        bad = tp.make_items(tp.PORT, 8, b"caps", poison=range(8))
        sv.AUDIT_MAX_LANES = 3
        for sync, corrupt, its, lanes in ((False, 1.0, bad, [3]), (False, 0.0, items, [1, 3]),
                                          (True, 0.0, items, [1, 8])):
            plan, sup = tp.faulty(tp.PORT, seed=13, audit_pct=100, audit_sync=sync, plan_kw={"corrupt_rate": corrupt})
            audited, cpu_verify = [], sup._cpu_verify
            sup._cpu_verify = lambda x: audited.append(len(x)) or cpu_verify(x)
            got = sup.verify_items(its)
            tp.wait_for(lambda: sup.metrics.audits.value() >= 1, what="the audit")
            if corrupt:
                assert got == [True] * 8
                tp.wait_for(lambda: sup.state() == "broken", what="the audit trip")
                assert sup.metrics.audit_mismatches.value() == 1
            else:
                assert got == want and sup.state() == "healthy" and sup.metrics.audit_mismatches.value() == 0
            # a mixed mask: triage confirms the one bad lane on the CPU first
            assert audited == lanes, (sync, corrupt, audited)
            sup.stop()
        for cap, fires in ((1, 0), (2, 1)):
            sv.HEDGE_MAX_LANES = cap
            plan, sup = tp.faulty(tp.PORT, seed=10, hedge_pct=100, dispatch_timeout_ms=10_000)
            two = items[:2]
            for _ in range(3):  # warm the latency model's bucket
                sup.verify_items(two)
            plan.hang_rate, plan.hang_s = 1.0, 0.5
            assert sup.verify_items(two) == want[:2]
            plan.clear()
            tp.wait_for(lambda: tp.live_threads("supervisor-hedge-relay") == 0, what="the hedge relay")
            assert sup.metrics.hedge_fires.value() == fires, (cap, sup.metrics.hedge_fires.value())
            sup.stop()
    finally:
        sv.AUDIT_MAX_LANES = sv.HEDGE_MAX_LANES = 256
        os.environ.pop("CBFT_NATIVE_ED25519", None)
        native.reset()


def test_supervisor_matches_reference():
    check_against_reference()
    check_classify()
    check_port_gpu_routes()
    check_port_lane_caps()
