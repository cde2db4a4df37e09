"""The port's native CPU rung (cometbft_tpu_torch/native/) and the CPU
ladder over it, against pure Python and the JAX package's native rung
(cometbft_tpu/native/), on the CPU.

* The rung's own load-time check: its expected verdicts are pure
  Python's on its cases.
* Verdicts: the ladder (``native.ed25519_verify_batch``,
  ``PubKeyEd25519.verify_signature``, ``ed25519.verify_many`` and
  ``CPUBatchVerifier``) equals ``purepy.ed25519_verify`` and the
  reference's ``native.ed25519_verify_batch`` on every Ed25519 case of
  crypto/cuda/vectors.py (the contract's edge cases, the device-hash and
  torsioned cases, every way R can fail, the mixed batch) and on a
  seeded batch of 1,024 lanes with corrupted lanes and wrong lengths.
* Challenges: ``native.ed25519_challenges`` and ``_challenge_scalars``
  at 1,024 lanes (the native route) equal the Python loop, invalid lanes
  zero.
* Signing: the native signer gives purepy's bytes.
* The fall: with ``CC`` pointed at a compiler that fails and a fresh
  build directory, the rung is ``"purepy"``, the fall is counted and
  says why, and every verdict is unchanged; a fresh directory with the
  real compiler builds the rung again.

A case each.
"""

import os
import stat

import numpy as np
import pytest
import torch

from cometbft_tpu import native as ref_native
from cometbft_tpu_torch import native
from cometbft_tpu_torch.crypto import batch as port_batch
from cometbft_tpu_torch.crypto import ed25519 as ed
from cometbft_tpu_torch.crypto import purepy
from cometbft_tpu_torch.crypto.cuda import ed25519_batch, vectors

torch.set_num_threads(1)


def vector_cases():
    return (vectors.edge_cases() + vectors.device_hash_cases() + vectors.r_signature_cases()
            + vectors.mixed_batch())


def wide_batch(n=1024, seed=16):
    """n lanes over 64 keys; every 7th signature has a bit flipped, every
    50th message is changed, lanes 5 and 6 have a short signature and a
    short key."""
    rng = np.random.default_rng(seed)
    keys = [ed.gen_priv_key_from_secret(b"native-%d" % i) for i in range(64)]
    pubs, msgs, sigs = [], [], []
    for i in range(n):
        k = keys[i % 64]
        m = rng.bytes(int(rng.integers(0, 300)))
        s = k.sign(m)
        if i % 7 == 3:
            b = bytearray(s)
            b[int(rng.integers(0, 64))] ^= 1 << int(rng.integers(0, 8))
            s = bytes(b)
        if i % 50 == 11:
            m = m + b"!"
        pubs.append(k.pub_key().bytes())
        msgs.append(m)
        sigs.append(s)
    sigs[5] = sigs[5][:63]
    pubs[6] = pubs[6][:31]
    return pubs, msgs, sigs


def purepy_mask(pubs, msgs, sigs):
    return [len(p) == 32 and len(s) == 64 and purepy.ed25519_verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]


def ladder_masks(pubs, msgs, sigs):
    """Every CPU entry point of the port's ladder on the lanes with a
    32-byte key (a key object needs one)."""
    keep = [i for i, p in enumerate(pubs) if len(p) == 32]
    items = [(ed.PubKeyEd25519(pubs[i]), msgs[i], sigs[i]) for i in keep]
    bv = port_batch.CPUBatchVerifier()
    for it in items:
        bv.add(*it)
    return {
        "native": native.ed25519_verify_batch(pubs, msgs, sigs),
        "one by one": [pk.verify_signature(m, s) for pk, m, s in items],
        "verify_many": ed.verify_many(items),
        "cpu batch": bv.verify()[1],
    }, keep


def check_verdicts(pubs, msgs, sigs):
    want = purepy_mask(pubs, msgs, sigs)
    assert native.rung() == native.NATIVE, native.why()
    assert ref_native.ed25519_verify_batch(pubs, msgs, sigs) == want
    masks, keep = ladder_masks(pubs, msgs, sigs)
    assert masks.pop("native") == want
    for name, mask in masks.items():
        assert mask == [want[i] for i in keep], name
    return want


def failing_cc(tmp_path):
    cc = tmp_path / "cc-that-fails"
    cc.write_text("#!/bin/sh\necho 'no compiler here' >&2\nexit 1\n")
    cc.chmod(cc.stat().st_mode | stat.S_IEXEC)
    return str(cc)


@pytest.mark.parametrize("case", ["vectors", "wide batch", "challenges and signing", "fall to purepy"])
def test_native_rung_matches_purepy_and_reference(case, tmp_path, monkeypatch):
    native.reset()
    try:
        if case == "vectors":
            checks = native._self_check_cases()
            assert [purepy.ed25519_verify(*c[1:]) for c in checks] == list(native.SELF_CHECK_VERDICTS)
            cases = vector_cases()
            want = check_verdicts([c[1] for c in cases], [c[2] for c in cases], [c[3] for c in cases])
            assert True in want and False in want
        elif case == "wide batch":
            want = check_verdicts(*wide_batch())
            assert want.count(False) > 100 and not want[5] and not want[6]
        elif case == "challenges and signing":
            pubs, msgs, sigs = wide_batch()
            pk_arr, sig_arr, valid = ed25519_batch._parse_inputs(pubs, sigs)
            assert (~valid).sum() >= 2
            got = ed25519_batch._challenge_scalars(pk_arr, sig_arr, msgs, valid)
            before = native.stats()["native_calls"]
            monkeypatch.setattr(os, "cpu_count", lambda: 1)  # the Python loop
            loop = ed25519_batch._challenge_scalars(pk_arr, sig_arr, msgs, valid)
            assert native.stats()["native_calls"] == before
            assert np.array_equal(got, loop)
            for i in range(len(msgs)):
                want = purepy.sha512_mod_l(sigs[i][:32], pubs[i], msgs[i]) if valid[i] else 0
                assert int.from_bytes(got[i].tobytes(), "little") == want, i
            raw = native.ed25519_challenges(pk_arr.tobytes(), sig_arr[:, :32].tobytes(), msgs, list(valid))
            assert raw == ref_native.ed25519_challenges(pk_arr.tobytes(), sig_arr[:, :32].tobytes(), msgs,
                                                       list(valid)) == got.tobytes()
            seed = bytes(range(32))
            pub = purepy.ed25519_public_from_seed(seed)
            assert native.ed25519_pub_from_seed(seed) == pub
            assert native.ed25519_sign(seed, b"m") == purepy.ed25519_sign(seed, pub, b"m")
        else:
            cases = vector_cases()
            pubs, msgs, sigs = [c[1] for c in cases], [c[2] for c in cases], [c[3] for c in cases]
            want = purepy_mask(pubs, msgs, sigs)
            falls = native.stats()["falls"]
            monkeypatch.setenv("CC", failing_cc(tmp_path))
            native.reset(build_dir=str(tmp_path / "build-a"))
            assert native.rung() == native.PUREPY
            assert "build failed" in native.why() and "no compiler here" in native.why()
            assert native.stats()["falls"] == falls + 1
            assert not os.path.exists(tmp_path / "build-a" / "libcbft_ed25519.so")
            assert native.ed25519_verify_batch(pubs, msgs, sigs) is None
            served = native.stats()["purepy_calls"]
            masks, keep = ladder_masks(pubs, msgs, sigs)
            assert masks.pop("native") is None
            for name, mask in masks.items():
                assert mask == [want[i] for i in keep], name
            assert native.stats()["purepy_calls"] > served
            assert native.stats()["falls"] == falls + 1  # decided once
            monkeypatch.delenv("CC")
            native.reset(build_dir=str(tmp_path / "build-b"))
            assert native.rung() == native.NATIVE
            assert os.path.exists(tmp_path / "build-b" / "libcbft_ed25519.so")
    finally:
        native.reset()
