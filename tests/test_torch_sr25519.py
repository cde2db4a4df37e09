"""The port's sr25519 path against the JAX package, on the CPU.

* merlin: the port's Keccak-f[1600] and its transcripts (appends, then
  challenges of several lengths) equal the reference's byte for byte;
* keys: mini secrets, public keys, addresses and signatures equal the
  reference's for the same secret, and a reference public key carried
  across with ``convert`` is the port's;
* host packing: the port's ``prepare_batch`` u8[128, B], viewed as
  little-endian u32 rows, equals the reference's u32[32, B] byte for byte,
  with the same validity mask;
* the verifier: ``verify_plain`` (the CPU twin of the CUDA kernel
  ``sr25519_verify``) gives the verdicts of the reference's jitted
  ``verify_kernel`` (called directly, at the reference's 64-lane padded
  shape) and of the reference's and the port's CPU verifiers on
  ``vectors.sr25519_cases`` and 40 mixed lanes; the limb constants that
  the CUDA source takes from ``fe25519.cuh`` equal their definitions;
* the gpu verifier (plain versions): a flush mixing Ed25519, secp256k1 and
  sr25519 keys comes back in input order as Python bools, equal to
  ``"cpu"``'s; ``verify_batch`` keeps lane order across a chunk edge; a
  key type with no kernel still raises before any launch.

Bytes and verdicts are compared with exact equality. Inputs come from
fixed seeds (cometbft_tpu_torch/crypto/cuda/vectors.py). One test runs
every check (see tests/test_torch_field.py for why each of these files
holds one test).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import merlin as ref_merlin
from cometbft_tpu.crypto import sr25519 as ref_sr
from cometbft_tpu.crypto.tpu import sr25519_batch as ref_batch
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import PubKey
from cometbft_tpu_torch.crypto import batch as port_batch
from cometbft_tpu_torch.crypto import ed25519 as ed
from cometbft_tpu_torch.crypto import merlin
from cometbft_tpu_torch.crypto import purepy
from cometbft_tpu_torch.crypto import secp256k1 as secp
from cometbft_tpu_torch.crypto import sr25519 as sr
from cometbft_tpu_torch.crypto.cuda import ed25519_batch, field as fe, mesh, secp256k1_batch, sr25519_batch, vectors

torch.set_num_threads(1)

_REF_LANES = 64  # the reference's _MIN_PAD: its kernel is compiled at this shape only
_CSRC = os.path.join(os.path.dirname(sr25519_batch.__file__), "csrc")


def _columns(cases):
    return [c[1] for c in cases], [c[2] for c in cases], [c[3] for c in cases]


def _cpu(pks, msgs, sigs):
    return [len(p) == 32 and sr.PubKeySr25519(p).verify_signature(m, s) for p, m, s in zip(pks, msgs, sigs)]


def _ref_cpu(pks, msgs, sigs):
    return [len(p) == 32 and ref_sr.PubKeySr25519(p).verify_signature(m, s) for p, m, s in zip(pks, msgs, sigs)]


def check_merlin_matches_reference():
    rng = np.random.default_rng(29)
    for _ in range(3):
        state = bytearray(rng.bytes(200))
        ref_state = bytearray(state)
        merlin.keccak_f1600(state)
        ref_merlin.keccak_f1600(ref_state)
        assert state == ref_state
    t, rt = merlin.Transcript(b"port-test"), ref_merlin.Transcript(b"port-test")
    for n in (0, 1, 165, 166, 167, 400):  # around STROBE's 166-byte rate
        msg = rng.bytes(n)
        t.append_message(b"msg %d" % n, msg)
        rt.append_message(b"msg %d" % n, msg)
        for size in (32, 64, 200):
            assert t.challenge_bytes(b"c", size) == rt.challenge_bytes(b"c", size)


def check_keys_match_reference():
    for i in range(3):
        secret = b"sr-key-%d" % i
        k, rk = sr.gen_priv_key_from_secret(secret), ref_sr.gen_priv_key_from_secret(secret)
        assert k.bytes() == rk.bytes() and k.type() == rk.type() == sr.KEY_TYPE == "sr25519"
        pk, rpk = k.pub_key(), rk.pub_key()
        assert pk.bytes() == rpk.bytes() and pk.address() == rpk.address()
        assert len(pk.bytes()) == sr.PUB_KEY_SIZE == ref_sr.PUB_KEY_SIZE
        assert convert.sr25519_pub_key_from_reference(rpk.bytes()) == pk
        for msg in (b"", b"sr vote %d" % i, bytes(range(200))):
            sig = k.sign(msg)
            assert sig == rk.sign(msg)
            assert pk.verify_signature(msg, sig) and rpk.verify_signature(msg, sig)
            assert not pk.verify_signature(msg + b"!", sig)


def _as_ref_words(wire_u8):
    """The port's u8[128, B] as the reference's u32[32, B] little-endian rows."""
    return np.ascontiguousarray(np.ascontiguousarray(wire_u8.T).view("<u4").T)


def check_packing_matches_reference():
    pks, msgs, sigs = _columns(vectors.sr25519_cases() + vectors.sr25519_mixed())
    wire, valid = sr25519_batch.prepare_batch(pks, msgs, sigs)
    ref_wire, ref_valid = ref_batch.prepare_batch(pks, msgs, sigs)
    assert wire.dtype == np.uint8 and wire.shape == (128, len(pks))
    assert ref_wire.dtype == np.uint32 and ref_wire.shape == (32, len(pks))
    assert _as_ref_words(wire).tobytes() == ref_wire.tobytes()
    assert valid.tolist() == ref_valid.tolist()
    assert 0 < valid.sum() < len(pks)


def _ref_kernel(wire):
    """The reference's jitted verify_kernel on lanes padded to 64 (repeats
    of lane 0), in calls of 64."""
    out = []
    for start in range(0, wire.shape[1], _REF_LANES):
        w = wire[:, start:start + _REF_LANES]
        pad = _REF_LANES - w.shape[1]
        w = np.concatenate([w, np.repeat(w[:, :1], pad, axis=1)], axis=1)
        out += np.asarray(ref_batch.verify_kernel(jnp.asarray(_as_ref_words(w))))[: _REF_LANES - pad].tolist()
    return out


def check_verdicts_match_reference():
    edge = vectors.sr25519_cases()
    cases = edge + vectors.sr25519_mixed()
    pks, msgs, sigs = _columns(cases)
    wire, valid = sr25519_batch.prepare_batch(pks, msgs, sigs)
    plain = sr25519_batch.verify_plain(torch.from_numpy(wire)).tolist()
    assert plain == _ref_kernel(wire)
    cpu = _cpu(pks, msgs, sigs)
    assert cpu == _ref_cpu(pks, msgs, sigs)
    assert (np.array(plain) & valid).tolist() == cpu
    verdict = {c[0]: ok for c, ok in zip(edge, cpu)}
    assert {k for k, ok in verdict.items() if ok} == {"valid", "valid_empty_msg", "identity_key"}
    assert {"a_not_square", "a_negative_t", "a_y_zero", "r_not_square", "r_negative_t", "r_y_zero"} <= set(verdict)
    # the decode failures pass the host's checks: the card rejects them
    for c, ok, v in zip(edge, plain, valid):
        if c[0].endswith(("not_square", "negative_t", "y_zero")):
            assert v and not ok, c[0]
    assert all(ok == c[0].startswith("valid") for c, ok in zip(cases[len(edge):], cpu[len(edge):]))
    # the wrapper on a CPU tensor runs the plain version and counts no launch
    before = sr25519_batch.LAUNCHES
    one = torch.from_numpy(np.ascontiguousarray(wire[:, :2]))
    assert sr25519_batch.verify_kernel(one).tolist() == plain[:2]
    assert sr25519_batch.LAUNCHES == before


def _c_array(src, name):
    body = re.search(name + r"\[10\] = \{([^}]*)\}", src).group(1)
    return [int(t, 16) for t in re.findall(r"0x[0-9a-fA-F]+", body)]


def check_cuda_constants():
    """sr25519_verify.cu takes its constants from fe25519.cuh (shared with
    the Ed25519 kernels) and defines none of its own."""
    with open(os.path.join(_CSRC, "sr25519_verify.cu"), encoding="utf-8") as f:
        cu = f.read()
    assert '#include "fe25519.cuh"' in cu and "__constant__ uint32_t" not in cu
    with open(os.path.join(_CSRC, "fe25519.cuh"), encoding="utf-8") as f:
        header = f.read()
    want = {"K_D": fe.D, "K_D2": fe.D2, "K_SQRT_M1": fe.SQRT_M1, "K_BX": purepy.BX, "K_BY": purepy.BY}
    for name, value in want.items():
        assert _c_array(header, name) == fe.int_to_limbs(value), name
    assert (sr._BASE[0], sr._BASE[1]) == (purepy.BX, purepy.BY)


def check_three_curve_flush():
    """Ed25519, secp256k1 and sr25519 lanes interleaved in one gpu flush
    (plain versions): verdicts in input order, each a Python bool, equal
    to "cpu"'s."""
    sr_cases = vectors.sr25519_mixed(9, seed=31)
    items = []
    for i, (_, pk, msg, sig) in enumerate(sr_cases):
        items.append((sr.PubKeySr25519(pk), msg, sig))
        e = ed.gen_priv_key_from_secret(b"three-curve-ed-%d" % i)
        s = secp.gen_priv_key_from_secret(b"three-curve-secp-%d" % i)
        m = b"three-curve lane %d" % i
        e_sig, s_sig = e.sign(m), s.sign(m)
        if i == 4:
            e_sig = e_sig[:3] + bytes([e_sig[3] ^ 1]) + e_sig[4:]
            s_sig = s_sig[:3] + bytes([s_sig[3] ^ 1]) + s_sig[4:]
        items += [(e.pub_key(), m, e_sig), (s.pub_key(), m, s_sig)]
    got, cpu = port_batch.GPUBatchVerifier(device="cpu"), port_batch.new_batch_verifier("cpu")
    for pk, msg, sig in items:
        got.add(pk, msg, sig)
        cpu.add(pk, msg, sig)
    ok, mask = got.verify()
    want_ok, want = cpu.verify()
    assert (ok, mask) == (want_ok, want) and not ok
    assert all(type(v) is bool for v in mask)
    assert mask[0::3] == _ref_cpu(*_columns(sr_cases)) and mask[0::3].count(False) == 3
    assert mask[1::3].count(False) == mask[2::3].count(False) == 1
    # the sr25519 route alone
    only = port_batch.GPUBatchVerifier(device="cpu")
    for pk, msg, sig in items[0::3][:4]:
        only.add(pk, msg, sig)
    ok, mask = only.verify()
    assert mask == want[0::3][:4] and all(type(v) is bool for v in mask)


def check_chunk_edge(monkeypatch):
    pks, msgs, sigs = _columns(vectors.sr25519_mixed(13, seed=37))
    chunks = []
    real = sr25519_batch.verify_kernel

    def counted(wire):
        chunks.append(wire.shape[1])
        return real(wire)

    monkeypatch.setattr(sr25519_batch, "verify_kernel", counted)
    assert sr25519_batch.MAX_CHUNK == 8192
    try:
        mesh.configure_chunk_cap(8)
        got = sr25519_batch.verify_batch(pks, msgs, sigs, device="cpu")
    finally:
        mesh.configure_chunk_cap(None)
    assert chunks == [8, 5]
    assert got == _cpu(pks, msgs, sigs) and all(type(v) is bool for v in got)
    assert sr25519_batch.verify_batch([], [], [], device="cpu") == []


class _NoKernelKey(PubKey):
    def bytes(self) -> bytes:
        return b"\x03" * 48

    def type(self) -> str:
        return "bls12_381"


def check_unknown_key_type_raises(monkeypatch):
    launched = []
    for mod, name in ((sr25519_batch, "verify_kernel"), (secp256k1_batch, "verify_kernel"),
                      (ed25519_batch, "verify_kernel_compact")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _real=real: launched.append(1) or _real(*a))
    bv = port_batch.GPUBatchVerifier(device="cpu")
    k = sr.gen_priv_key_from_secret(b"unknown-type")
    bv.add(k.pub_key(), b"m", k.sign(b"m"))
    bv.add(_NoKernelKey(), b"m", bytes(64))
    with pytest.raises(NotImplementedError, match="bls12_381"):
        bv.verify()
    assert launched == []
    bv.add(k.pub_key(), b"m", k.sign(b"m"))
    assert bv.verify() == (True, [True]) and launched == [1]


def test_sr25519_matches_reference(monkeypatch):
    check_merlin_matches_reference()
    check_keys_match_reference()
    check_packing_matches_reference()
    check_verdicts_match_reference()
    check_cuda_constants()
    check_three_curve_flush()
    with monkeypatch.context() as m:
        check_chunk_edge(m)
    with monkeypatch.context() as m:
        check_unknown_key_type_raises(m)
