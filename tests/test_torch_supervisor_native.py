"""The port's BackendSupervisor with the native CPU rung live
(cometbft_tpu_torch/crypto/supervisor.py over cometbft_tpu_torch/native)
against the JAX package's supervisor, on the CPU.

With the native rung, the port's lane caps (``HEDGE_MAX_LANES``,
``AUDIT_MAX_LANES``, 256) do not apply, and the supervisor behaves as the
reference's, which has no caps:

* audit: a 100% background audit of a 1,024-lane dispatch checks all
  1,024 lanes (one CPU check of the whole batch), finds the batch clean,
  and a corrupted 1,024-lane dispatch trips the breaker;
* hedge: a 1,024-lane dispatch that hangs past its predicted p99 is
  hedged on the CPU, and the CPU's mask is released.

The same script runs in both packages over a FaultyBackend on ``"cpu"``;
the audited lane counts, masks, states and hedge counts must be equal.
tests/test_torch_supervisor.py holds the caps with pure Python forced.
One test, a case each.
"""

import pytest
import torch
import torch_plane as tp

from cometbft_tpu_torch import native

torch.set_num_threads(1)

LANES = 1024


def audit(pkg, corrupt: float):
    items = tp.make_items(pkg, LANES, b"native-audit", poison=(17, 600))
    want = tp.cpu_mask(pkg, items)
    plan, sup = tp.faulty(pkg, seed=5, audit_pct=100, audit_sync=False, plan_kw={"corrupt_rate": corrupt})
    audited, cpu_verify = [], sup._cpu_verify
    sup._cpu_verify = lambda x: audited.append(len(x)) or cpu_verify(x)
    got = sup.verify_items(items)
    tp.wait_for(lambda: sup.metrics.audits.value() >= 1, what="the audit")
    if corrupt:
        tp.wait_for(lambda: sup.state() == "broken", what="the audit trip")
    out = {
        "released_is_cpu": got == want, "audited": audited, "state": sup.state(),
        "mismatches": sup.metrics.audit_mismatches.value(), "bad": want.count(False),
    }
    sup.stop()
    return out


def hedge(pkg):
    items = tp.make_items(pkg, LANES, b"native-hedge", poison=(3,))
    want = tp.cpu_mask(pkg, items)
    plan, sup = tp.faulty(pkg, seed=10, hedge_pct=100, dispatch_timeout_ms=20_000)
    for _ in range(3):  # warm the latency model's bucket
        sup.verify_items(items)
    plan.hang_rate, plan.hang_s = 1.0, 1.5
    got = sup.verify_items(items)
    plan.clear()
    tp.wait_for(lambda: tp.live_threads("supervisor-hedge-relay") == 0, what="the hedge relay")
    out = {"mask": got == want, "hedge_fires": sup.metrics.hedge_fires.value()}
    sup.stop()
    return out


@pytest.mark.parametrize("case", ["clean audit", "corrupted audit", "hedge"])
def test_native_rung_lifts_the_lane_caps(case):
    native.reset()
    assert native.rung() == native.NATIVE, native.why()
    assert not tp.PORT.supervisor.lane_caps_apply()
    if case == "hedge":
        want, got = hedge(tp.REF), hedge(tp.PORT)
        assert got == want and got["hedge_fires"] == 1, (got, want)
        return
    corrupt = 1.0 if case == "corrupted audit" else 0.0
    want, got = audit(tp.REF, corrupt), audit(tp.PORT, corrupt)
    assert got == want, (got, want)
    # the whole batch in one CPU check: triage confirms the two bad lanes first
    assert got["audited"][-1] == LANES and got["bad"] == 2
    if corrupt:
        assert got["state"] == "broken" and got["mismatches"] >= 1
    else:
        assert got["state"] == "healthy" and got["released_is_cpu"] and got["mismatches"] == 0
