"""The port's device-hash route against the JAX package, on the CPU.

* packing: the port's ``prepare_batch_device_hash_compact`` equals the
  reference's byte for byte;
* the verifier: ``verify_full_compact_plain`` (the CPU twin of the CUDA
  kernel ``ed25519_verify_full_compact``) gives the verdicts of the
  reference's jitted ``verify_full_kernel_compact`` (called directly, at
  the 9-lane shape tests/test_wire_format.py already compiles) and of the
  CPU verifiers on the device-hash vectors (messages at SHA-512's block
  edges, an empty one, torsioned keys whose verdict depends on an exact
  h mod L), the contract's edge cases, and that file's 9-lane
  construction; the h it computes is hashlib's h mod L;
* the route: ``verify_batch(device="cpu")`` under ``CBFT_TPU_HASH=device``
  runs the device-hash kernel's plain version and gives the ``"cpu"``
  backend's verdicts; ``hash_mode`` rejects an unknown value;
* the word wire's device-hash form: the port's
  ``prepare_batch_device_hash`` (u32[24, B] words, the host-padded
  SHA-512 blocks as hi and lo planes, the live block counts) equals the
  reference's byte for byte; ``verify_full_words_plain`` (the CPU twin of
  ``ed25519_verify_full_words``) gives the verdicts of the reference's
  jitted ``verify_full_kernel`` (called directly, at 64 lanes and three
  blocks) and of the CPU verifiers, the torsioned lanes included; under
  ``CBFT_TPU_WIRE=words`` and ``CBFT_TPU_HASH=device`` ``verify_batch``
  takes it.

Verdicts and bytes are compared with exact equality. One test runs every
check (see tests/test_torch_field.py for why each of these files holds
one test).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.crypto.tpu import ed25519_batch as ref_batch
from cometbft_tpu_torch.crypto import ed25519 as ed
from cometbft_tpu_torch.crypto import batch as port_batch
from cometbft_tpu_torch.crypto import purepy
from cometbft_tpu_torch.crypto.cuda import ed25519_batch, scalar, vectors

torch.set_num_threads(1)

_REF_LANES = 9  # tests/test_wire_format.py::test_device_hash_compact_parity
_REF_MP = 320  # its message plane: messages of up to 200 bytes, 3 blocks
_REF_WORD_LANES, _REF_BLOCKS = 64, 3  # the word-wire kernel's one compiled shape


def _columns(cases):
    return [c[1] for c in cases], [c[2] for c in cases], [c[3] for c in cases]


def _nine_lanes():
    """tests/test_wire_format.py's construction: 9 keys, messages of 0-200
    bytes from seed 23, lane 2's S corrupted."""
    rng = np.random.default_rng(23)
    keys = [ed.gen_priv_key_from_secret(b"dh-%d" % i) for i in range(9)]
    msgs = [bytes(rng.bytes(int(rng.integers(0, 200)))) for _ in keys]
    sigs = [k.sign(m) for k, m in zip(keys, msgs)]
    b = bytearray(sigs[2])
    b[40] ^= 0x80
    sigs[2] = bytes(b)
    return [("nine", k.pub_key().bytes(), m, s) for k, m, s in zip(keys, msgs, sigs)]


def _reference_verdicts(wire, msg, mlen):
    """The reference kernel's verdicts, run in groups of 9 lanes with the
    message plane padded to 320 rows (one compiled shape)."""
    n = wire.shape[1]
    out = []
    for start in range(0, n, _REF_LANES):
        end = min(start + _REF_LANES, n)
        w = np.zeros((96, _REF_LANES), np.uint8)
        m = np.zeros((_REF_MP, _REF_LANES), np.uint8)
        ln = np.zeros(_REF_LANES, np.int32)
        w[:, : end - start] = wire[:, start:end]
        m[: msg.shape[0], : end - start] = msg[:, start:end]
        ln[: end - start] = mlen[start:end]
        got = ref_batch.verify_full_kernel_compact(jnp.asarray(w), jnp.asarray(m), jnp.asarray(ln))
        out += np.asarray(got)[: end - start].tolist()
    return np.array(out, bool)


def check_packing_matches_reference():
    pks, msgs, sigs = _columns(vectors.device_hash_cases() + vectors.edge_cases() + _nine_lanes())
    pks = pks + [b"\x01" * 31, pks[0]]
    msgs = msgs + [b"a", b"b"]
    sigs = sigs + [sigs[0], sigs[0][:63]]
    got = ed25519_batch.prepare_batch_device_hash_compact(pks, msgs, sigs)
    want = ref_batch.prepare_batch_device_hash_compact(pks, msgs, sigs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()


def check_torsioned_vectors_need_exact_h():
    """The torsioned key accepted under h mod L is rejected under h + L:
    the vector pins exact reduction."""
    for label, pub, msg, sig in vectors.device_hash_cases():
        if not label.startswith("torsioned"):
            continue
        h = purepy.sha512_mod_l(sig[:32], pub, msg)
        s = int.from_bytes(sig[32:], "little")
        neg_a = purepy.pt_neg(purepy.pt_decode(pub))
        exact = purepy.pt_encode(purepy.pt_double_mul(s, purepy.B, h, neg_a)) == sig[:32]
        plus_l = purepy.pt_encode(purepy.pt_double_mul(s, purepy.B, h + purepy.L, neg_a)) == sig[:32]
        assert exact == (label == "torsioned_h0")
        assert not plus_l


def check_verdicts_match_reference():
    cases = vectors.device_hash_cases() + vectors.edge_cases() + _nine_lanes()
    pks, msgs, sigs = _columns(cases)
    wire, msg, mlen, valid = ed25519_batch.prepare_batch_device_hash_compact(pks, msgs, sigs)
    port = ed25519_batch.verify_full_compact_plain(
        torch.from_numpy(wire), torch.from_numpy(msg), torch.from_numpy(mlen)
    ).numpy() & valid
    verdicts = {
        "ref_kernel": _reference_verdicts(wire, msg, mlen) & valid,
        "ref_cpu": [ref_ed.PubKeyEd25519(p).verify_signature(m, s) for p, m, s in zip(pks, msgs, sigs)],
        "port_cpu": [purepy.ed25519_verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)],
    }
    for name, other in verdicts.items():
        diff = [cases[i][0] for i in range(len(cases)) if bool(port[i]) != bool(other[i])]
        assert not diff, f"port != {name} on {diff}"
    labels = {c[0]: bool(v) for c, v in zip(cases, port)}
    assert labels["torsioned_h0"] and not labels["torsioned_h_nonzero"]
    for n in (0, 47, 48, 175, 176):
        assert labels[f"valid_len_{n}"] and not labels[f"corrupt_len_{n}"]


def check_challenge_matches_hashlib():
    cases = vectors.device_hash_cases() + vectors.mixed_batch(9)
    pks, msgs, sigs = _columns(cases)
    wire, msg, mlen, _ = ed25519_batch.prepare_batch_device_hash_compact(pks, msgs, sigs)
    wire_t = torch.from_numpy(wire)
    h_words = ed25519_batch._challenge_words(wire_t[32:64], wire_t[0:32], torch.from_numpy(msg), torch.from_numpy(mlen))
    h = scalar.words_to_bytes(h_words).numpy()
    for b in range(len(cases)):
        want = int.from_bytes(hashlib.sha512(sigs[b][:32] + pks[b] + msgs[b]).digest(), "little") % purepy.L
        assert h[:, b].tobytes() == want.to_bytes(32, "little"), b


def check_device_hash_route(monkeypatch):
    cases = vectors.device_hash_cases() + vectors.mixed_batch(6)
    calls = []
    real = ed25519_batch.verify_kernel_full_compact

    def counted(*args):
        calls.append(args[0].shape[1])
        return real(*args)

    monkeypatch.setattr(ed25519_batch, "verify_kernel_full_compact", counted)
    monkeypatch.setenv("CBFT_TPU_HASH", "device")
    assert ed25519_batch.hash_route(len(cases)) == "device"
    gpu = port_batch.GPUBatchVerifier(device="cpu")
    cpu = port_batch.new_batch_verifier("cpu")
    for _, pk, msg, sig in cases:
        gpu.add(ed.PubKeyEd25519(pk), msg, sig)
        cpu.add(ed.PubKeyEd25519(pk), msg, sig)
    assert gpu.verify() == cpu.verify()
    assert calls == [len(cases)]
    monkeypatch.setenv("CBFT_TPU_HASH", "auto")
    assert ed25519_batch.hash_route(10**6) == "host"
    monkeypatch.setenv("CBFT_TPU_HASH", "gpu")
    with pytest.raises(ValueError, match="CBFT_TPU_HASH"):
        ed25519_batch.hash_mode()


def check_full_words(monkeypatch):
    cases = vectors.device_hash_cases() + vectors.edge_cases() + _nine_lanes()
    pks, msgs, sigs = _columns(cases)
    got = ed25519_batch.prepare_batch_device_hash(pks, msgs, sigs)
    want = ref_batch.prepare_batch_device_hash(pks, msgs, sigs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()
    wire, hi, lo, nblocks, valid = got
    assert hi.dtype == np.uint32 and hi.shape[0] <= _REF_BLOCKS and len(cases) <= _REF_WORD_LANES
    port = ed25519_batch.verify_full_words_plain(
        torch.from_numpy(wire), torch.from_numpy(hi), torch.from_numpy(lo), torch.from_numpy(nblocks)
    ).numpy()
    n = len(cases)
    w = np.zeros((24, _REF_WORD_LANES), np.uint32)
    h = np.zeros((_REF_BLOCKS, 16, _REF_WORD_LANES), np.uint32)
    lw = np.zeros_like(h)
    nb = np.zeros(_REF_WORD_LANES, np.int32)
    w[:, :n], h[: hi.shape[0], :, :n], lw[: lo.shape[0], :, :n], nb[:n] = wire, hi, lo, nblocks
    ref = np.asarray(ref_batch.verify_full_kernel(jnp.asarray(w), jnp.asarray(h), jnp.asarray(lw), jnp.asarray(nb)))
    assert port.tolist() == ref[:n].tolist()
    cpu = [purepy.ed25519_verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    assert (port & valid).tolist() == cpu
    assert cpu == [ref_ed.PubKeyEd25519(p).verify_signature(m, s) for p, m, s in zip(pks, msgs, sigs)]
    labels = {c[0]: bool(v) for c, v in zip(cases, port)}
    assert labels["torsioned_h0"] and not labels["torsioned_h_nonzero"]
    # the route: words and the device hash take the full word kernel
    calls = []
    real = ed25519_batch.verify_kernel_full_words
    monkeypatch.setattr(ed25519_batch, "verify_kernel_full_words", lambda *a: calls.append(a[1].shape) or real(*a))
    monkeypatch.setenv("CBFT_TPU_WIRE", "words")
    monkeypatch.setenv("CBFT_TPU_HASH", "device")
    assert ed25519_batch.verify_batch(pks, msgs, sigs, device="cpu") == cpu
    assert calls == [hi.shape]


def test_device_hash_matches_reference(monkeypatch):
    check_packing_matches_reference()
    check_torsioned_vectors_need_exact_h()
    check_verdicts_match_reference()
    check_challenge_matches_hashlib()
    with monkeypatch.context() as m:
        check_device_hash_route(m)
    with monkeypatch.context() as m:
        check_full_words(m)
