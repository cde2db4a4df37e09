"""The port's key store and its two routes, on the CPU.

* the store (cometbft_tpu_torch/crypto/cuda/keystore.py) on
  ``device="cpu"``: the rotation, LRU, pin, thrash, ``invalidate``,
  stale-generation and snapshot cases of the reference's
  tests/test_keystore.py, plus lookups from another device, which miss.
  The oracles are the port's CPU verifier and the reference's
  ``crypto/ed25519.py``: the reference's store tests fail on the
  reference itself (ROADMAP C-ref 1), so nothing here reaches the
  reference's keystore, mesh or ``verify_valset_resident``;
* the key tables: ``key_tables_plain`` (the CPU twin of the CUDA kernel
  ``ed25519_key_tables``) holds, for seeded keys, a key with y ≥ p, the
  −0 key, a torsioned key and a key that does not decompress (flag 0,
  identity entries), the affine Niels form of every comb multiple
  Σ_i j_i·2^(64i + 16t)·(−A) computed with the port's pure-Python
  Ed25519 (``crypto/purepy.py``); B's tables are those of −B's encoding;
* the kernel: ``verify_resident_plain`` (the CPU twin of the CUDA kernel
  ``ed25519_verify_resident``) over those tables gives the verdicts of
  the reference's jitted ``verify_kernel_resident`` and
  ``verify_kernel_indexed``, called directly at 64 lanes, on identical
  keys and rows, repeated rows and an index out of range included, and on
  lanes for every way R can fail the projective compare (y not below p,
  no root, x = 0 with the sign bit set, a valid R that does not match,
  the sign flipped); the per-flush staging equals the reference's byte
  for byte;
* the commit path: ``ValidatorSet.verify_commit*`` with
  ``backend=lambda: GPUBatchVerifier(device="cpu")`` takes the resident
  route (one upload, then hits, never the keyed wire), and its verdicts
  and errors equal ``"cpu"``'s with an absent lane, a corrupted
  signature, s ≥ L and a commit under 2/3, its lane verdicts those of
  the reference's ``crypto/ed25519.py``; a flush of the resident keys
  takes the indexed route;
* its verdicts are Python bools, on the indexed route and through a gpu
  verifier's flush;
* device keys: a bare ``"cuda"`` resolves to the current card, so
  ``"cuda"`` and ``"cuda:0"`` find one entry and another current card
  misses (``torch.cuda``'s current device and availability patched).

Verdicts are compared with exact equality. One test runs every check
(see tests/test_torch_field.py for why each of these files holds one
test).
"""

import copy
import hashlib

import numpy as np
import torch

from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.crypto.tpu import ed25519_batch as ref_batch
from cometbft_tpu_torch.crypto import batch as port_batch
from cometbft_tpu_torch.crypto import ed25519 as ed
from cometbft_tpu_torch.crypto import purepy
from cometbft_tpu_torch.crypto.cuda import ed25519_batch, field, keystore, vectors
from cometbft_tpu_torch.proto.gogo import Timestamp
from cometbft_tpu_torch.types.block import (
    BLOCK_ID_FLAG_COMMIT,
    BlockID,
    Commit,
    CommitSig,
    PartSetHeader,
)
from cometbft_tpu_torch.types.validator import Validator
from cometbft_tpu_torch.types.validator_set import Fraction, ValidatorSet

torch.set_num_threads(1)

CPU = torch.device("cpu")
_REF_LANES = 64


def _valset(n, tag):
    keys = [ed.gen_priv_key_from_secret(tag + b"-%d" % i) for i in range(n)]
    pks = [k.pub_key().bytes() for k in keys]
    return keys, pks, hashlib.sha256(b"".join(pks)).digest()


def _flush(keys, tag):
    msgs = [tag + b" %d" % i for i in range(len(keys))]
    return msgs, [k.sign(m) for k, m in zip(keys, msgs)]


def _cpu(pks, msgs, sigs):
    return [purepy.ed25519_verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]


def _ref(pks, msgs, sigs):
    """The reference's serial verifier; None marks an absent lane."""
    return [
        m is not None and s is not None and ref_ed.PubKeyEd25519(p).verify_signature(m, s)
        for p, m, s in zip(pks, msgs, sigs)
    ]


def _fake_keys(tag, n=3):
    return [hashlib.sha256(tag + b"-%d" % i).digest() for i in range(n)]


def _build(device):
    return lambda pks: ed25519_batch._build_resident(pks, device)


def check_rotation_lru_and_other_devices(store):
    pks_a, vid_a = _fake_keys(b"rot-a"), hashlib.sha256(b"rot-a").digest()
    e = store.get(vid_a, pks_a, _build(CPU), CPU)
    assert e.table_dev.device == CPU and e.table_dev.dtype == torch.uint8
    assert e.table_dev.tolist() == [list(k) for k in pks_a]
    assert torch.equal(e.key_tables, ed25519_batch.key_tables_plain(e.table_dev))
    base = store.snapshot()["stats"]
    assert store.get(vid_a, pks_a, _build(CPU), CPU) is e
    s = store.snapshot()["stats"]
    assert (s["hits"], s["uploads"]) == (base["hits"] + 1, base["uploads"])
    # a rotated set is a miss and a fresh upload, the old entry kept
    vid_b = hashlib.sha256(b"rot-b").digest()
    store.get(vid_b, _fake_keys(b"rot-b"), _build(CPU), CPU)
    snap = store.snapshot()
    assert snap["stats"]["uploads"] == base["uploads"] + 1
    assert len({x["generation"] for x in snap["entries"]}) == 2
    # another device misses: its own entry, never the CPU table
    assert store.lookup_fresh("cuda") == [] and store.covering_entry(pks_a, "cuda") is None
    assert keystore.verify_batch_indexed(pks_a, [b"m"] * 3, [bytes(64)] * 3, "cuda") is None
    meta = torch.device("meta")
    other = store.get(
        vid_a, pks_a, lambda pks: keystore.new_entry(pks, torch.empty((3, 32), dtype=torch.uint8, device=meta), meta), meta
    )
    assert other is not e and other.device == torch.device("meta")
    assert store.snapshot()["stats"]["uploads"] == base["uploads"] + 2
    assert store.get(vid_a, pks_a, _build(CPU), CPU) is e
    # LRU at CACHE_MAX, oldest first
    store.invalidate()
    vids = [hashlib.sha256(b"lru-%d" % i).digest() for i in range(keystore.CACHE_MAX + 1)]
    for i, vid in enumerate(vids):
        store.get(vid, _fake_keys(b"lru-%d" % i), _build(CPU), CPU)
    held = [k[0] for k in store._entries]
    assert len(held) == keystore.CACHE_MAX and vids[0] not in held and vids[-1] in held
    store.invalidate()


def check_pins_and_thrash(store):
    vid_a = hashlib.sha256(b"pin-a").digest()
    store.get(vid_a, _fake_keys(b"pin-a"), _build(CPU), CPU)
    assert store.pin(vid_a, CPU)
    assert not store.pin(vid_a, "cuda")
    base_thrash = store.snapshot()["stats"]["keystore_thrash"]
    for i in range(keystore.CACHE_MAX + 2):
        store.get(hashlib.sha256(b"press-%d" % i).digest(), _fake_keys(b"press-%d" % i), _build(CPU), CPU)
    held = {k[0] for k in store._entries}
    assert vid_a in held and len(held) == keystore.CACHE_MAX
    # pinning counted as a use, so only never-used entries are thrash
    assert store.snapshot()["stats"]["keystore_thrash"] == base_thrash + 3
    store.unpin(vid_a, CPU)
    store.get(hashlib.sha256(b"pin-z").digest(), _fake_keys(b"pin-z"), _build(CPU), CPU)
    assert vid_a not in {k[0] for k in store._entries}
    with store.pinned(b"\x00" * 32, CPU) as ok:
        assert not ok
    store.invalidate()


def check_staleness_and_indexed_route(store, monkeypatch):
    keys, pks, vid = _valset(4, b"topo")
    msgs, sigs = _flush(keys, b"seed")
    assert ed25519_batch.verify_valset_resident(vid, pks, msgs, sigs, device=CPU) == [True] * 4
    # indexed: repeated rows, a corrupted lane, one upload's table
    lanes = [1, 1, 3, 0, 2, 1]
    f_pks = [pks[i] for i in lanes]
    f_msgs = [b"idx %d" % j for j in range(len(lanes))]
    f_sigs = [keys[i].sign(m) for i, m in zip(lanes, f_msgs)]
    bad = bytearray(f_sigs[2])
    bad[10] ^= 1
    f_sigs[2] = bytes(bad)
    before = store.snapshot()["stats"]
    assert store.covering_entry(f_pks, CPU) is not None
    got = keystore.verify_batch_indexed(f_pks, f_msgs, f_sigs, CPU)
    assert got == _cpu(f_pks, f_msgs, f_sigs) == _ref(f_pks, f_msgs, f_sigs) == [True, True, False, True, True, True]
    s = store.snapshot()["stats"]
    assert s["indexed_dispatches"] == before["indexed_dispatches"] + 1
    assert s["indexed_lanes"] == before["indexed_lanes"] + len(lanes)
    stranger = ed.gen_priv_key_from_secret(b"stranger").pub_key().bytes()
    assert keystore.verify_batch_indexed(f_pks + [stranger], f_msgs + [b"x"], f_sigs + [f_sigs[0]], CPU) is None
    assert keystore.verify_batch_indexed([], [], [], CPU) == []
    # a topology bump makes the entry undispatchable: the indexed route
    # misses and the resident route rebuilds from the keys it is given
    monkeypatch.setattr(keystore, "_topo_generation", lambda: 1)
    drops = store.snapshot()["stats"]["stale_drops"]
    assert keystore.verify_batch_indexed(f_pks, f_msgs, f_sigs, CPU) is None
    assert store.snapshot()["stats"]["stale_drops"] == drops + 1 and store.snapshot()["entries"] == []
    monkeypatch.setattr(keystore, "_topo_generation", lambda: 2)
    store.get(vid, pks, _build(CPU), CPU)
    keys_b, pks_b, _ = _valset(4, b"topo-b")
    monkeypatch.setattr(keystore, "_topo_generation", lambda: 3)
    # the same valset id presented with other keys after a bump: signatures
    # by the old keys must not verify against a reused old table
    assert ed25519_batch.verify_valset_resident(vid, pks_b, msgs, sigs, device=CPU) == [False] * 4
    assert store.snapshot()["entries"][0]["topo_generation"] == 3
    gen0 = store.snapshot()["generation"]
    assert store.invalidate(vid) == 1 and store.invalidate(vid) == 0
    assert store.snapshot()["generation"] == gen0 + 1


def _affine(pt):
    zi = pow(pt[2], purepy.P - 2, purepy.P)
    return pt[0] * zi % purepy.P, pt[1] * zi % purepy.P


def check_key_tables_match_pure_python():
    """Every entry of key_tables_plain against pure-Python multiples."""
    p = purepy.P
    torsioned = vectors._torsioned_signature(0x1F2E3D4C, b"torsion-", True)[1]
    keys = [ed.gen_priv_key_from_secret(b"tables-%d" % i).pub_key().bytes() for i in range(2)]
    keys += [
        (p + 1).to_bytes(32, "little"),  # y >= p: the identity, y taken mod p
        (1 | 1 << 255).to_bytes(32, "little"),  # -0: x = 0 with the sign bit set
        torsioned,
        vectors._no_root_y().to_bytes(32, "little"),  # no root: flag 0
    ]
    arr = np.frombuffer(b"".join(keys), np.uint8).reshape(-1, 32).copy()
    tab = ed25519_batch.key_tables_plain(torch.from_numpy(arr))
    assert tab.dtype == torch.int32 and tuple(tab.shape) == (len(keys), 65, 32)
    assert ed25519_batch.KEY_TABLE_BYTES == 8320
    limbs = lambda row: field.limbs_to_int(row)  # noqa: E731
    for k, pk in enumerate(keys):
        a = purepy.pt_decode(pk)
        assert tab[k, 64].tolist() == [int(a is not None)] + [0] * 31, k
        for t in range(4):
            for j in range(16):
                e = tab[k, 16 * t + j].tolist()
                assert e[30:] == [0, 0]
                if a is None:
                    assert (limbs(e[0:10]), limbs(e[10:20]), limbs(e[20:30])) == (1, 1, 0)
                    continue
                m = sum(((j >> i) & 1) << (64 * i + 16 * t) for i in range(4))
                x, y = _affine(purepy.pt_mul(m, purepy.pt_neg(a)))
                assert (limbs(e[0:10]), limbs(e[10:20]), limbs(e[20:30])) == (
                    (y + x) % p, (y - x) % p, 2 * field.D * x * y % p), (k, t, j)
    assert keys[-1] and purepy.pt_decode(keys[-1]) is None and purepy.pt_decode(keys[3]) is not None
    base = ed25519_batch.base_tables("cpu")
    assert purepy.pt_decode(ed25519_batch.neg_base_encoding()) == purepy.pt_neg(purepy.B)
    assert torch.equal(base, ed25519_batch.key_tables_plain(
        torch.frombuffer(bytearray(ed25519_batch.neg_base_encoding()), dtype=torch.uint8).view(1, 32)))
    yp, ym = (field.limbs_to_int(base[0, 17, k:k + 10].tolist()) for k in (0, 10))  # slice 1, j = 1
    half = pow(2, p - 2, p)
    assert _affine(purepy.pt_mul(1 << 16, purepy.B)) == ((yp - ym) * half % p, (yp + ym) * half % p)


def _reference_rows():
    """64 lanes over 16 keys: shuffled rows with repeats, a corrupted S
    and R, an absent lane, and (for the index) one row out of range."""
    rng = np.random.default_rng(41)
    keys, pks, _ = _valset(16, b"ref-rows")
    rows = rng.integers(0, 16, _REF_LANES)
    msgs = [rng.bytes(int(rng.integers(0, 150))) for _ in range(_REF_LANES)]
    sigs = [keys[r].sign(m) for r, m in zip(rows, msgs)]
    for lane, byte in ((5, 40), (9, 3), (33, 63)):
        s = bytearray(sigs[lane])
        s[byte] ^= 0x04
        sigs[lane] = bytes(s)
    msgs[12] = None
    pk_arr = np.frombuffer(b"".join(pks), np.uint8).reshape(16, 32).copy()
    return pk_arr, rows.astype(np.int32), msgs, sigs


def check_resident_kernel_matches_reference():
    pk_arr, rows, msgs, sigs = _reference_rows()
    lane_keys = pk_arr[rows]
    rsh, valid = ed25519_batch._prepare_rsh_compact(lane_keys, msgs, sigs)
    ref_rsh, ref_valid = ref_batch._prepare_rsh_compact(lane_keys, msgs, sigs)
    assert rsh.tobytes() == ref_rsh.tobytes() and valid.tolist() == ref_valid.tolist()
    want = [m is not None and purepy.ed25519_verify(k.tobytes(), m, s) for k, m, s in zip(lane_keys, msgs, sigs)]
    # lanes 56..62: every way R can fail the projective compare
    r_cases = vectors.resident_r_cases()
    at = _REF_LANES - 1 - len(r_cases)
    r_keys = np.frombuffer(b"".join(c[1] for c in r_cases), np.uint8).reshape(-1, 32)
    lane_keys = lane_keys.copy()
    lane_keys[at:at + len(r_cases)] = r_keys
    rsh[:, at:at + len(r_cases)] = vectors.resident_rows(r_cases)
    valid[at:at + len(r_cases)] = True
    want[at:at + len(r_cases)] = [c[5] for c in r_cases]
    # lane order (the resident commit): row b for lane b
    tables = ed25519_batch.key_tables_plain(torch.from_numpy(lane_keys))
    port = ed25519_batch.verify_resident_plain(tables, None, torch.from_numpy(rsh)).numpy()
    rsh_words = np.ascontiguousarray(np.ascontiguousarray(rsh.T).view("<u4").T)
    ref = np.asarray(ref_batch.verify_kernel_resident(ref_batch._le_words(lane_keys), rsh_words))
    assert port.tolist() == ref.tolist()
    assert (port & valid).tolist() == want
    assert port[at:at + len(r_cases)].tolist() == [c[5] for c in r_cases] == [True, False, False, False, True, False, False]
    # by index (the indexed flush), one index out of range; the R lanes
    # index the rows appended after the set's
    table_keys = np.concatenate([pk_arr, r_keys])
    idx = rows.copy()
    idx[at:at + len(r_cases)] = np.arange(len(pk_arr), len(table_keys))
    idx[20] = len(table_keys) + 5
    tables = ed25519_batch.key_tables_plain(torch.from_numpy(table_keys))
    port = ed25519_batch.verify_resident_plain(tables, torch.from_numpy(idx), torch.from_numpy(rsh)).numpy()
    ref = np.asarray(ref_batch.verify_kernel_indexed(table_keys, idx, rsh))
    assert port.tolist() == ref.tolist()
    assert not port[20] and want[20]
    want[20] = False
    assert (port & valid).tolist() == want
    # a negative index rejects too (the reference would wrap it)
    idx[21] = -1
    assert not ed25519_batch.verify_resident_plain(
        tables, torch.from_numpy(idx[:24]), torch.from_numpy(np.ascontiguousarray(rsh[:, :24]))
    )[21]


def _commit_world(n=8):
    keys = [ed.gen_priv_key_from_secret(b"ks-commit-%d" % i) for i in range(n)]
    vals = ValidatorSet([Validator.new(k.pub_key(), 10 + 3 * i) for i, k in enumerate(keys)])
    by_addr = {k.pub_key().address(): k for k in keys}
    block_id = BlockID(b"\x07" * 32, PartSetHeader(2, b"\x08" * 32))
    commit = Commit(height=9, round=0, block_id=block_id)
    for v in vals.validators:
        commit.signatures.append(CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, Timestamp(1_700_000_000, 5), b""))
    for i, v in enumerate(vals.validators):
        commit.signatures[i].signature = by_addr[v.address].sign(commit.vote_sign_bytes("ks-chain", i))
    return vals, block_id, commit


def _variants(vals, commit):
    out = {"signed": commit}
    c = copy.deepcopy(commit)
    c.signatures[3] = CommitSig.absent()
    out["absent"] = c
    c = copy.deepcopy(commit)
    sig = bytearray(c.signatures[5].signature)
    sig[7] ^= 0x20
    c.signatures[5].signature = bytes(sig)
    out["corrupted"] = c
    c = copy.deepcopy(commit)
    s = int.from_bytes(c.signatures[1].signature[32:], "little") + purepy.L
    c.signatures[1].signature = c.signatures[1].signature[:32] + s.to_bytes(32, "little")
    out["s_ge_l"] = c
    c = copy.deepcopy(commit)
    total, absent = vals.total_voting_power(), 0
    for i, v in enumerate(vals.validators):
        c.signatures[i] = CommitSig.absent()
        absent += v.voting_power
        if (total - absent) * 3 <= total * 2:
            break
    out["under_2/3"] = c
    return out


def _outcome(fn):
    try:
        fn()
        return ("ok",)
    except Exception as e:  # noqa: BLE001 - the verdict is the exception
        return (type(e).__name__, str(e))


def check_commit_takes_the_resident_route(store, monkeypatch):
    vals, block_id, commit = _commit_world()

    def keyed(*_):
        raise AssertionError("a commit under the gpu verifier shipped its keys")

    monkeypatch.setattr(ed25519_batch, "verify_batch", keyed)
    gpu = lambda: port_batch.GPUBatchVerifier(device="cpu")  # noqa: E731
    assert port_batch.resident_commit_eligible(1, gpu)
    assert not port_batch.resident_commit_eligible(8, "cpu")
    assert port_batch.verify_commit_valset([], [], [], "cpu") is None
    calls = {
        "verify_commit": lambda c, b: vals.verify_commit("ks-chain", block_id, 9, c, backend=b),
        "verify_commit_light": lambda c, b: vals.verify_commit_light("ks-chain", block_id, 9, c, backend=b),
        "verify_commit_light_trusting": lambda c, b: vals.verify_commit_light_trusting(
            "ks-chain", c, Fraction(1, 3), backend=b
        ),
    }
    seen = set()
    pks = [v.pub_key.bytes() for v in vals.validators]
    uploads_before = store.snapshot()["stats"]["uploads"]
    for label, c in _variants(vals, commit).items():
        msgs = [None if cs.is_absent() else c.vote_sign_bytes("ks-chain", i) for i, cs in enumerate(c.signatures)]
        sigs = [None if cs.is_absent() else cs.signature for cs in c.signatures]
        lanes = port_batch.verify_commit_valset(pks, msgs, sigs, gpu)
        assert lanes == _ref(pks, msgs, sigs), label
        for name, fn in calls.items():
            before = store.snapshot()["stats"]
            got = _outcome(lambda: fn(c, gpu))
            after = store.snapshot()["stats"]
            want = _outcome(lambda: fn(c, "cpu"))
            assert got == want, (label, name, got, want)
            assert store.snapshot()["stats"] == after, "the cpu backend touched the store"
            seen.add(got[0])
            uploads = after["uploads"] - before["uploads"]
            hits = after["hits"] - before["hits"]
            assert (uploads, hits) == (0, 1), (label, name, uploads, hits)
    assert seen == {"ok", "ValueError", "ErrNotEnoughVotingPowerSigned"}
    assert store.snapshot()["stats"]["uploads"] == uploads_before + 1
    monkeypatch.undo()
    # the precommits of the resident set, flushed by a gpu verifier, take
    # the indexed route
    before = store.snapshot()["stats"]["indexed_dispatches"]
    bv, cpu = gpu(), port_batch.new_batch_verifier("cpu")
    for i, v in enumerate(vals.validators):
        for verifier in (bv, cpu):
            verifier.add(v.pub_key, commit.vote_sign_bytes("ks-chain", i), commit.signatures[i].signature)
    want = _ref(pks, [commit.vote_sign_bytes("ks-chain", i) for i in range(8)], [cs.signature for cs in commit.signatures])
    assert bv.verify() == cpu.verify() == (True, want)
    assert store.snapshot()["stats"]["indexed_dispatches"] == before + 1


def check_indexed_verdicts_are_bools(store):
    """The indexed route hands out Python bools, through the key store and
    through a gpu verifier's flush."""
    keys, pks, vid = _valset(5, b"bools")
    msgs, sigs = _flush(keys, b"bool flush")
    sigs[2] = sigs[2][:3] + bytes([sigs[2][3] ^ 1]) + sigs[2][4:]
    assert ed25519_batch.verify_valset_resident(vid, pks, msgs, sigs, device=CPU) == [True, True, False, True, True]
    got = keystore.verify_batch_indexed(pks, msgs, sigs, CPU)
    assert got == [True, True, False, True, True] and all(type(v) is bool for v in got)
    base = store.snapshot()["stats"]["indexed_dispatches"]
    bv = port_batch.GPUBatchVerifier(device="cpu")
    for k, m, s in zip(keys, msgs, sigs):
        bv.add(k.pub_key(), m, s)
    ok, mask = bv.verify()
    assert (ok, mask) == (False, got) and all(type(v) is bool for v in mask)
    assert store.snapshot()["stats"]["indexed_dispatches"] == base + 1
    store.invalidate()


def check_device_keys(store, monkeypatch):
    """A bare "cuda" is the current card: "cuda" and "cuda:0" find one
    entry, and an entry built while card 0 was current is not found once
    card 1 is."""
    assert keystore._device_key("cpu") == keystore._device_key(CPU) == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert keystore._device_key("cuda") == "cuda:0"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert keystore._device_key("cuda") == keystore._device_key("cuda:0") == "cuda:0"
    pks, vid = _fake_keys(b"dev-key"), hashlib.sha256(b"dev-key").digest()
    meta = torch.device("meta")

    def build(keys):
        return keystore.new_entry(keys, torch.empty((len(keys), 32), dtype=torch.uint8, device=meta), "cuda")

    base = store.snapshot()["stats"]["uploads"]
    e = store.get(vid, pks, build, "cuda")
    assert store.get(vid, pks, build, "cuda:0") is e
    assert store.covering_entry(pks, "cuda:0") is e and store.covering_entry(pks, torch.device("cuda", 0)) is e
    assert store.snapshot()["stats"]["uploads"] == base + 1
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert keystore._device_key("cuda") == "cuda:1"
    assert store.lookup_fresh("cuda") == [] and store.covering_entry(pks, "cuda") is None
    assert store.covering_entry(pks, "cuda:0") is e
    store.invalidate()


def test_keystore_and_resident_routes(monkeypatch):
    store = keystore.default_store()
    store.invalidate()
    try:
        check_rotation_lru_and_other_devices(store)
        check_pins_and_thrash(store)
        with monkeypatch.context() as m:
            check_staleness_and_indexed_route(store, m)
        store.invalidate()
        check_key_tables_match_pure_python()
        check_resident_kernel_matches_reference()
        with monkeypatch.context() as m:
            check_commit_takes_the_resident_route(store, m)
        store.invalidate()
        check_indexed_verdicts_are_bools(store)
        with monkeypatch.context() as m:
            check_device_keys(store, m)
    finally:
        store.invalidate()
