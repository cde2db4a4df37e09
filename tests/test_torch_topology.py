"""The port's device topology and OOM chunk-cap ladder
(cometbft_tpu_torch/crypto/cuda/topology.py, crypto/cuda/mesh.py) against
the JAX package's (cometbft_tpu/crypto/tpu/topology.py, mesh.py:78-330),
and the port's key store under it, on the CPU.

* handles and topologies: labels, kinds, snapshots, fingerprints, the
  quarantine set and its generation, and ``reset_runtime_state``, on the
  same script in both packages;
* the shrink/recover ladder of one handle: halvings to the floor, the
  hysteresis of ``note_clean_dispatch``, the capacity fraction and the
  chunk cap at each step; the module shims over the default topology's
  device 0; route parsing and ``route_scope``;
* ``mesh.chunk_cap`` under ``device_scope``: the port lowers it by the
  scoped handle's shrink levels (the reference does so inside its
  dispatch loop, ``DeviceHandle.chunk_cap``), and by device 0's outside
  any scope;
* ``detect`` counts ``torch.cuda.device_count()`` and raises without a
  card (the reference falls back to one device);
* the key store's entries go stale when the default topology's
  generation moves (a quarantine): the entry is dropped, never verified
  against, and rebuilt; ``covers``, ``generation``, ``entry_for``,
  ``register`` and ``residency`` answer as the reference's do.

One test loops over every case (see tests/test_torch_field.py for why
each of these files holds one test).
"""

import torch
import torch_plane as tp

from cometbft_tpu_torch.crypto import batch as port_batch
from cometbft_tpu_torch.crypto.cuda import keystore

torch.set_num_threads(1)


def topologies(pkg):
    topo = pkg.topology.DeviceTopology.virtual(3)
    out = {"labels": topo.labels(), "len": len(topo), "fp": topo.fingerprint(), "kind": topo.kind,
           "single": pkg.topology.DeviceTopology.single().snapshot(), "virtual0": len(pkg.topology.DeviceTopology.virtual(0))}
    steps = []
    for idx, flag in ((1, True), (1, True), (2, True), (1, False), (0, False)):
        steps.append((topo.set_quarantined(idx, flag), topo.generation(),
                      [d.label for d in topo.healthy_devices()], topo.is_quarantined(idx)))
    topo.device(2).shrink_chunk_cap()
    out["before_reset"] = topo.snapshot()
    topo.reset_runtime_state()
    out["after_reset"] = topo.snapshot()
    out["steps"] = steps
    out["empty"] = _outcome(lambda: pkg.topology.DeviceTopology([]))
    return out


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the verdict is the exception
        return (type(e).__name__, str(e))


def ladder(pkg):
    h = pkg.topology.DeviceTopology.virtual(1).device(0)
    steps = []
    for _ in range(pkg.mesh.MAX_SHRINK_LEVELS + 1):
        steps.append(("shrink", h.shrink_chunk_cap(), h.chunk_shrink_levels(), h.capacity_fraction(),
                      h.chunk_cap(8192, 64), h.chunk_cap(8192, 1)))
    for _ in range(8):
        steps.append(("clean", h.note_clean_dispatch(3), h.chunk_shrink_levels(), h.chunk_cap(8192, 64)))
    h.shrink_chunk_cap()  # an OOM restarts the streak
    steps.append(("clean", h.note_clean_dispatch(3), h.chunk_shrink_levels()))
    h.reset_chunk_shrink()
    steps.append(("reset", h.chunk_shrink_levels(), h.memory_guard_cap(), h.capacity_fraction()))
    shim = []
    pkg.mesh.reset_chunk_shrink()
    for _ in range(2):
        shim.append((pkg.mesh.shrink_chunk_cap(), pkg.mesh.chunk_shrink_levels()))
    for _ in range(3):
        shim.append((pkg.mesh.note_clean_dispatch(2), pkg.mesh.chunk_shrink_levels()))
    pkg.mesh.reset_chunk_shrink()
    shim.append(pkg.mesh.chunk_shrink_levels())
    routes = [_outcome(lambda r=r: pkg.mesh.parse_route(r)) for r in (None, "", " Auto ", "single", "SHARDED", "mesh")]
    with pkg.mesh.route_scope("single"):
        with pkg.mesh.route_scope("sharded"):
            inner = pkg.mesh.current_route()
        outer = pkg.mesh.current_route()
    routes.append((inner, outer, pkg.mesh.current_route()))
    return {"steps": steps, "shim": shim, "routes": routes}


def check_against_reference():
    tp.compare((topologies, ladder))


def check_chunk_cap_under_scope():
    port_mesh, port_topo = tp.PORT.mesh, tp.PORT.topology
    topo = port_topo.DeviceTopology.virtual(2)
    ref_topo = tp.REF.topology.DeviceTopology.virtual(2)
    for t in (topo, ref_topo):
        t.device(1).shrink_chunk_cap()
        t.device(1).shrink_chunk_cap()
    port_mesh.reset_chunk_shrink()
    assert port_mesh.chunk_cap(8192) == 8192
    with port_topo.device_scope(topo.device(1)) as h:
        assert port_topo.current_device() is h
        assert port_mesh.chunk_cap(8192) == ref_topo.device(1).chunk_cap(8192, 1) == 2048
        with port_topo.device_scope(topo.device(0)):
            assert port_mesh.chunk_cap(8192) == 8192 and port_mesh.chunk_cap(100) == 100
        assert port_mesh.chunk_cap(8192) == 2048
    assert port_topo.current_device() is None and port_mesh.chunk_cap(8192) == 8192
    port_mesh.shrink_chunk_cap()
    assert port_mesh.chunk_cap(8192) == 4096
    port_mesh.reset_chunk_shrink()
    # a virtual handle never touches CUDA; no multi-card mesh yet
    assert not topo.device(0).is_cuda()
    assert not port_mesh.sharded_available(topo)


def check_detect(monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        got = _outcome(tp.PORT.topology.DeviceTopology.detect)
        assert got[0] == "RuntimeError" and "CUDA" in got[1], got
        m.setattr(torch.cuda, "is_available", lambda: True)
        for n, kind in ((1, "chip"), (2, "mesh")):
            m.setattr(torch.cuda, "device_count", lambda n=n: n)
            topo = tp.PORT.topology.DeviceTopology.detect()
            assert (len(topo), topo.kind) == (n, kind)


def check_key_store_staleness():
    """A set uploaded under one topology generation is dropped, never
    verified against, and rebuilt once a quarantine moves it."""
    tp.register_plain()
    store = keystore.default_store()
    store.invalidate()
    topo = tp.PORT.topology.default_topology()
    items = tp.make_items(tp.PORT, 3, b"stale", poison=(1,))
    pks, msgs, sigs = [pk.bytes() for pk, _, _ in items], [m for _, m, _ in items], [s for _, _, s in items]
    want = [True, False, True]
    assert port_batch.verify_commit_valset(pks, msgs, sigs, tp.PLAIN) == want
    cpu = torch.device("cpu")
    gen0 = store.generation()
    assert keystore.covers(pks, cpu) and keystore.covers(pks) and not keystore.covers(pks, "cuda:0")
    assert keystore.verify_batch_indexed(pks, msgs, sigs, cpu) == want
    base = store.snapshot()["stats"]
    assert topo.set_quarantined(0, True)
    try:
        assert not keystore.covers(pks, cpu)
        assert keystore.verify_batch_indexed(pks, msgs, sigs, cpu) is None  # the stale entry is not read
        st = store.snapshot()["stats"]
        assert st["stale_drops"] == base["stale_drops"] + 1
        assert port_batch.verify_commit_valset(pks, msgs, sigs, tp.PLAIN) == want  # rebuilt
        st = store.snapshot()["stats"]
        assert st["uploads"] == base["uploads"] + 1 and store.generation() == gen0 + 1
        assert keystore.covers(pks, cpu)
    finally:
        topo.set_quarantined(0, False)
    assert not keystore.covers(pks, cpu)  # re-admission moves the generation too
    # the verify service's handshake helpers (reference keystore.py:252-349)
    vid = b"\x42" * 32
    host = store.register(vid, pks + [b"short"])
    assert host.key_tables is None and not host.pk_ok[-1] and store.generation() == gen0 + 2
    assert store.register(vid, pks) is host and store.generation() == gen0 + 2
    assert store.entry_for(vid) is host and store.entry_for(vid, generation=gen0 + 2) is host
    drops = store.snapshot()["stats"]["stale_drops"]
    assert store.entry_for(vid, generation=gen0) is None
    assert store.snapshot()["stats"]["stale_drops"] == drops + 1
    assert not keystore.covers(pks + [b"short"])  # a host-only entry never feeds the device routes
    res = store.residency()
    assert set(res) == {"entries", "keys", "generation", "hit_rate", "indexed_dispatches", "thrash"}
    assert res["generation"] == store.generation() and res["entries"] == len(store.snapshot()["entries"])
    store.invalidate()


def test_topology_matches_reference(monkeypatch):
    check_against_reference()
    check_chunk_cap_under_scope()
    check_detect(monkeypatch)
    check_key_store_staleness()
