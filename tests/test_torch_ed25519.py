"""The port's Ed25519 path against the JAX package, on the CPU.

* host packing: the port's ``prepare_batch_compact`` equals the
  reference's byte for byte;
* the verifier: the port's plain torch verifier (the CPU twin of the CUDA
  kernel ``ed25519_verify_compact``) gives the verdicts of the reference's
  jitted ``verify_kernel_compact`` (called directly, at the 64-lane shape
  tests/test_tpu_ed25519.py compiles) and of the reference's
  crypto/ed25519.py verify, on the contract's edge cases and a mixed batch
  of 33;
* keys, signatures and the limb constants written into the CUDA sources
  (``ed25519_verify.cu`` and ``ed25519_resident.cu``, whose comb layout
  also equals the plain twin's) equal their reference or their
  definition;
* the word wire (``CBFT_TPU_WIRE=words``): the port's ``prepare_batch``
  equals the reference's u32[32, B] byte for byte; ``verify_words_plain``
  (the CPU twin of ``ed25519_verify_words``) gives the verdicts of the
  reference's jitted ``verify_kernel`` (called directly, at 64 lanes) and
  of the CPU verifiers; ``verify_batch`` under ``CBFT_TPU_WIRE=words``
  takes it; ``wire_format`` defaults to ``compact`` and rejects an unknown
  value.

Verdicts and bytes are compared with exact equality. Inputs are made from
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

from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.crypto.tpu import ed25519_batch as ref_batch
from cometbft_tpu_torch.crypto import ed25519 as ed
from cometbft_tpu_torch.crypto import purepy
from cometbft_tpu_torch.crypto.cuda import ed25519_batch, field as fe, scalar, vectors

torch.set_num_threads(1)

_REF_LANES = 64  # the batch shape tests/test_tpu_ed25519.py already compiles


def _columns(cases):
    return [c[1] for c in cases], [c[2] for c in cases], [c[3] for c in cases]


def check_packing_matches_reference():
    pks, msgs, sigs = _columns(vectors.edge_cases() + vectors.mixed_batch())
    # plus wrong-length entries, which both mask out
    pks = pks + [b"\x01" * 31, pks[0]]
    msgs = msgs + [b"a", b"b"]
    sigs = sigs + [sigs[0], sigs[0][:63]]
    wire, valid = ed25519_batch.prepare_batch_compact(pks, msgs, sigs)
    ref_wire, ref_valid = ref_batch.prepare_batch_compact(pks, msgs, sigs)
    assert wire.dtype == ref_wire.dtype == np.uint8
    assert wire.shape == ref_wire.shape == (128, len(pks))
    assert wire.tobytes() == ref_wire.tobytes()
    assert valid.tolist() == ref_valid.tolist()


def check_s_below_l_matches_reference():
    rng = np.random.default_rng(5)
    base = np.frombuffer(fe.L.to_bytes(32, "little"), np.uint8)
    rows = [base.copy() for _ in range(4)]
    rows[1][0] -= 1  # L - 1
    rows[2][0] += 1  # L + 1
    rows[3][31] = 0xFF
    s = np.concatenate([np.stack(rows), rng.integers(0, 256, (28, 32), dtype=np.uint8)])
    s[8:] &= np.array([0xFF] * 31 + [0x1F], np.uint8)  # some below L
    assert ed25519_batch._s_below_l(s).tolist() == ref_batch._s_below_l(s).tolist()


def check_wire_unpack():
    rng = np.random.default_rng(11)
    raw = rng.integers(0, 256, size=(9, 32)).astype(np.uint8)
    words = ed25519_batch._words(torch.from_numpy(np.ascontiguousarray(raw.T)))
    limbs = ed25519_batch.unpack_fe(words)
    digits = scalar.digits_msb_first(words)
    bits = np.unpackbits(raw, axis=-1, bitorder="little")
    want_digits = (bits[:, 0:254:2] + 2 * bits[:, 1:254:2])[:, ::-1].T
    assert (digits.numpy() == want_digits).all()
    ys = []
    for b in range(raw.shape[0]):
        val = int.from_bytes(raw[b].tobytes(), "little") & ((1 << 255) - 1)
        assert fe.limbs_to_int(limbs[:, b].tolist()) == val
        ys.append(val % fe.P)
    # encode(x, y) of canonical values gives y's bits and x's parity
    xs = list(range(9))
    enc = ed25519_batch.encode(fe.from_ints(xs), fe.from_ints(ys))
    for b in range(9):
        got = sum(int(enc[j, b]) << (32 * j) for j in range(8))
        assert got == ys[b] | ((xs[b] & 1) << 255)


def check_verdicts_match_reference():
    edge, mixed = vectors.edge_cases(), vectors.mixed_batch()
    cases = edge + mixed
    pks, msgs, sigs = _columns(cases)
    wire, valid = ed25519_batch.prepare_batch_compact(pks, msgs, sigs)
    port = ed25519_batch.verify_compact_plain(torch.from_numpy(wire)).numpy() & valid
    padded = np.zeros((128, _REF_LANES), np.uint8)
    padded[:, : len(cases)] = wire
    verdicts = {
        "ref_kernel": np.asarray(ref_batch.verify_kernel_compact(padded))[: len(cases)] & valid,
        "ref_cpu": [ref_ed.PubKeyEd25519(p).verify_signature(m, s) for p, m, s in zip(pks, msgs, sigs)],
        "port_cpu": [purepy.ed25519_verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)],
    }
    for name, other in verdicts.items():
        diff = [cases[i][0] for i in range(len(cases)) if bool(port[i]) != bool(other[i])]
        assert not diff, f"port != {name} on {diff}"
    accepted = {c[0] for c, v in zip(edge, port) if v}
    rejected = {c[0] for c, v in zip(edge, port) if not v}
    assert {"valid", "identity_key", "noncanonical_key", "minus_zero_key", "canonical_r"} <= accepted
    assert {"corrupt_r", "corrupt_s", "corrupt_msg", "wrong_key", "s_ge_l", "noncanonical_r"} <= rejected
    for i, case in enumerate(mixed):
        if case[0] == "valid":
            assert port[len(edge) + i]


def check_wrapper_on_cpu_runs_the_plain_version():
    pks, msgs, sigs = _columns(vectors.edge_cases()[:3])
    before = ed25519_batch.LAUNCHES
    assert ed25519_batch.verify_batch(pks, msgs, sigs, device="cpu") == [True, True, False]
    assert ed25519_batch.LAUNCHES == before
    assert ed25519_batch.verify_batch([], [], [], device="cpu") == []


def check_keys_match_reference():
    for i in range(3):
        secret = b"key-%d" % i
        port_key = ed.gen_priv_key_from_secret(secret)
        ref_key = ref_ed.gen_priv_key_from_secret(secret)
        assert port_key.bytes() == ref_key.bytes()
        assert port_key.pub_key().address() == ref_key.pub_key().address()
        assert port_key.sign(b"msg %d" % i) == ref_key.sign(b"msg %d" % i)


def check_cuda_constants():
    want = {
        "K_D": fe.D, "K_D2": fe.D2, "K_SQRT_M1": fe.SQRT_M1,
        "K_BX": purepy.BX, "K_BY": purepy.BY,
    }
    for source, names in (("ed25519_verify.cu", want), ("ed25519_resident.cu", ("K_D", "K_D2", "K_SQRT_M1"))):
        src = os.path.join(os.path.dirname(ed25519_batch.__file__), "csrc", source)
        with open(src, encoding="utf-8") as f:
            text = f.read()
        for name in names:
            m = re.search(name + r"\[10\] = \{([^}]*)\}", text)
            assert m, (source, name)
            limbs = [int(v, 16) for v in m.group(1).replace("\n", " ").split(",")]
            assert limbs == fe.int_to_limbs(want[name]), (source, name)
    # the resident source's table layout is the plain twin's
    with open(os.path.join(os.path.dirname(ed25519_batch.__file__), "csrc", "ed25519_resident.cu"), encoding="utf-8") as f:
        text = f.read()
    for name, value in (("COMB_SLICES", ed25519_batch.COMB_SLICES), ("COMB_COLUMNS", ed25519_batch.COMB_COLUMNS),
                        ("SLICE_ENTRIES", ed25519_batch.SLICE_ENTRIES), ("ENTRY_WORDS", ed25519_batch.ENTRY_WORDS)):
        assert re.search(r"#define %s (\d+)" % name, text).group(1) == str(value), name


def check_word_wire(monkeypatch):
    cases = vectors.edge_cases() + vectors.mixed_batch()
    pks, msgs, sigs = _columns(cases)
    pks = pks + [b"\x01" * 31, pks[0]]
    msgs = msgs + [b"a", b"b"]
    sigs = sigs + [sigs[0], sigs[0][:63]]
    wire, valid = ed25519_batch.prepare_batch(pks, msgs, sigs)
    ref_wire, ref_valid = ref_batch.prepare_batch(pks, msgs, sigs)
    assert wire.dtype == ref_wire.dtype == np.uint32
    assert wire.shape == ref_wire.shape == (32, len(pks))
    assert wire.tobytes() == ref_wire.tobytes() and valid.tolist() == ref_valid.tolist()
    # the words are the compact wire's bytes; int32 holding their bits reads the same
    compact, _ = ed25519_batch.prepare_batch_compact(pks, msgs, sigs)
    assert np.ascontiguousarray(compact.T).view("<u4").T.tobytes() == wire.tobytes()
    port = ed25519_batch.verify_words_plain(torch.from_numpy(wire)).numpy()
    assert port.tolist() == ed25519_batch.verify_words_plain(torch.from_numpy(wire.view(np.int32))).tolist()
    padded = np.zeros((32, _REF_LANES), np.uint32)
    padded[:, : len(pks)] = wire
    ref = np.asarray(ref_batch.verify_kernel(jnp.asarray(padded)))[: len(pks)]
    assert port.tolist() == ref.tolist()
    n = len(cases)
    cpu = [purepy.ed25519_verify(p, m, s) for p, m, s in zip(pks[:n], msgs[:n], sigs[:n])]
    assert (port & valid).tolist() == cpu + [False, False]
    assert cpu == [ref_ed.PubKeyEd25519(p).verify_signature(m, s) for p, m, s in zip(pks[:n], msgs[:n], sigs[:n])]
    # the route: CBFT_TPU_WIRE=words with the host hash takes the word kernel
    calls = []
    real = ed25519_batch.verify_kernel_words
    monkeypatch.setattr(ed25519_batch, "verify_kernel_words", lambda w: calls.append(w.dtype) or real(w))
    monkeypatch.delenv("CBFT_TPU_WIRE", raising=False)
    assert ed25519_batch.wire_format() == "compact"
    monkeypatch.setenv("CBFT_TPU_HASH", "host")
    monkeypatch.setenv("CBFT_TPU_WIRE", "words")
    assert ed25519_batch.verify_batch(pks[:n], msgs[:n], sigs[:n], device="cpu") == cpu
    assert ed25519_batch.verify_batch(pks[:1], msgs[:1], sigs[:1], device="cpu") == cpu[:1]  # one lane
    assert calls == [torch.uint32, torch.uint32]
    monkeypatch.setenv("CBFT_TPU_WIRE", "gzip")
    with pytest.raises(ValueError, match="CBFT_TPU_WIRE"):
        ed25519_batch.wire_format()


def test_ed25519_matches_reference(monkeypatch):
    check_packing_matches_reference()
    check_s_below_l_matches_reference()
    check_wire_unpack()
    check_verdicts_match_reference()
    check_wrapper_on_cpu_runs_the_plain_version()
    check_keys_match_reference()
    check_cuda_constants()
    with monkeypatch.context() as m:
        check_word_wire(m)
