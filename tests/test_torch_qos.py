"""The port's QoS policy (cometbft_tpu_torch/crypto/qos.py) against the JAX
package's (cometbft_tpu/crypto/qos.py), on the CPU.

* ``parse_qos_classes`` over the default ladder, ``off``, custom specs and
  every malformed one (the same classes, or the same error);
* ``resolve_class`` for tagged, untagged, unknown and aliased subsystems,
  against the default ladder and a custom one; the class codes;
* ``TokenBucket`` and ``TenantQuotas`` on an injected clock: takes,
  refills, bursts, independent tenants, rate 0 unlimited;
* ``BrownoutController`` on an injected clock: the ladder tripped lowest
  class first under burn or a degraded supervisor, the cooldown, the
  hysteresis band, and re-admission in reverse after a clean streak;
* the knobs' env precedence and ``QoSMetrics``' exposition.

One test loops over every case (see tests/test_torch_field.py for why
each of these files holds one test).
"""

import os

import torch_plane as tp


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the verdict is the exception
        return (type(e).__name__, str(e))


def _spec(s):
    return None if s is None else [(c.name, c.policy, c.max_queue, c.weight, c.shed_ms) for c in s]


SPECS = (
    None, "", "default", "off", "OFF", "consensus", "consensus,blocksync:shed:8192:4,mempool:drop",
    "consensus:block:16:8, light:shed , mempool:drop:2:1", "evidence,consensus", "consensus,nosuch",
    "consensus,consensus", "consensus:yield", "consensus:block:0", "consensus:block:4:0",
    "consensus:block:4:1:9", ",,", "blocksync:shed:x", 7,
)
SUBSYSTEMS = (None, "", "consensus", "evidence", "blocksync", "light", "mempool", "statesync", "rpc", "unknown", "Mempool")


def parsing(pkg):
    q = pkg.qos
    out = {"specs": [_outcome(lambda s=s: _spec(q.parse_qos_classes(s))) for s in SPECS]}
    ladders = (q.parse_qos_classes("default"), q.parse_qos_classes("consensus,light:shed,mempool:drop"))
    out["resolve"] = [
        [q.resolve_class(sub, tuple(c.name for c in ladder)) for sub in SUBSYSTEMS] for ladder in ladders
    ]
    out["aliases"] = dict(q.SUBSYSTEM_ALIASES)
    out["order"] = list(q.CLASS_ORDER)
    out["codes"] = [_outcome(lambda n=n: q.class_code(n)) for n in (None, "consensus", "mempool", "nope")]
    out["names"] = [_outcome(lambda c=c: q.class_name(c)) for c in (0, 1, 5, 250, 255)]
    return out


def knobs(pkg):
    q = pkg.qos
    out = []
    for env, fn, args in (
        ("CBFT_QOS_SHED_MS", q.shed_ms_default, ((), (120,))),
        ("CBFT_QOS_CLASSES", q.qos_classes_default, ((), ("off",))),
        ("CBFT_QOS_TENANT_RATE", q.tenant_rate_default, ((), (500,))),
    ):
        for a in args:
            out.append(fn(*a))
        os.environ[env] = "77" if env != "CBFT_QOS_CLASSES" else "consensus"
        try:
            for a in args:
                out.append(fn(*a))
        finally:
            del os.environ[env]
    return out


def buckets(pkg):
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731 - the injected clock
    b = pkg.qos.TokenBucket(rate=10, burst=10, clock=clock)
    steps = []
    for dt, n in ((0, 4), (0, 4), (0, 4), (0.1, 1), (0.1, 2), (5, 10), (0, 1), (0.05, 1)):
        t[0] += dt
        steps.append(b.try_take(n))
    default_burst = pkg.qos.TokenBucket(rate=3, clock=clock).burst
    quotas = pkg.qos.TenantQuotas(rate=4, burst=4, clock=clock)
    takes = []
    for dt, tenant, n in ((0, "a", 4), (0, "a", 1), (0, "b", 4), (0, None, 2), (0, "untagged", 3), (0.5, "a", 2), (0, "b", 1)):
        t[0] += dt
        takes.append(quotas.try_take(tenant, n))
    off = pkg.qos.TenantQuotas(rate=0)
    return {"steps": steps, "burst": default_burst, "takes": takes, "off": (off.enabled, off.try_take("x", 10**9)),
            "unlimited": pkg.qos.TokenBucket(rate=0, clock=clock).try_take(10**9)}


def brownout(pkg):
    t = [0.0]
    changes = []
    bo = pkg.qos.BrownoutController(
        ["mempool", "light", "blocksync"], trip_burn=2.0, clear_burn=1.0, readmit_clears=2,
        step_cooldown_s=0.25, clock=lambda: t[0], on_change=lambda c, d: changes.append((c, d)),
    )
    trace = []
    script = (
        ("burn", 3.0, 0.0), ("burn", 3.0, 0.1), ("burn", 3.0, 0.3), ("burn", 1.5, 0.3), ("state", "degraded", 0.3),
        ("state", "healthy", 0.0), ("burn", 0.5, 0.3), ("burn", 0.5, 0.3), ("burn", 0.5, 0.1), ("burn", 0.5, 0.3),
        ("burn", 0.5, 0.3), ("state", "broken", 0.3), ("state", "healthy", 0.3), ("burn", 0.2, 0.3),
        ("burn", 0.2, 0.3), ("burn", 0.2, 0.3), ("burn", 0.2, 0.3), ("burn", 0.2, 0.3),
    )
    for kind, value, dt in script:
        t[0] += dt
        (bo.observe_burn if kind == "burn" else bo.observe_state)(value)
        trace.append((bo.disabled(), bo.allows("mempool"), bo.allows("consensus"), bo.snapshot()))
    return {"trace": trace, "changes": changes}


def metrics(pkg):
    reg = pkg.metrics.Registry()
    m = pkg.qos.QoSMetrics(reg)
    m.admits.with_labels(qclass="consensus").add(3)
    m.sheds.with_labels(qclass="blocksync", policy="shed").add()
    m.depth.with_labels(qclass="light").set(2)
    m.brownout_active.with_labels(qclass="mempool").set(1)
    return reg.expose()


def test_qos_matches_reference():
    tp.compare((parsing, knobs, buckets, brownout, metrics))
    got = parsing(tp.PORT)
    assert [c[0] for c in got["specs"][2][1]] == ["consensus", "evidence", "blocksync", "light", "mempool"]
    assert [c[1] for c in got["specs"][2][1]] == ["block", "block", "shed", "shed", "drop"]
    assert brownout(tp.PORT)["changes"][:2] == [("mempool", True), ("light", True)]
