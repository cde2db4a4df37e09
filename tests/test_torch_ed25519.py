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
  (``fe25519.cuh``, which every Ed25519 and sr25519 source includes, with
  its comb layout, which equals the plain twin's; ``ge25519_group.cuh``'s
  4p limbs and the scalar recodings of its grouped core) equal their
  reference or their definition;
* every way R can fail the projective compare that replaced the
  inversion (``vectors.resident_r_cases``, each with its key): the plain
  wire twins (compact and word wire) give the verdicts of the reference's
  jitted kernels and of the point arithmetic, and the same R values as
  signatures (``vectors.r_signature_cases``) give the CPU verifiers'
  verdicts through the twins that hash on the card;
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


def _csrc(name):
    with open(os.path.join(os.path.dirname(ed25519_batch.__file__), "csrc", name), encoding="utf-8") as f:
        return f.read()


def check_cuda_constants():
    want = {
        "K_D": fe.D, "K_D2": fe.D2, "K_SQRT_M1": fe.SQRT_M1,
        "K_BX": purepy.BX, "K_BY": purepy.BY,
    }
    text = _csrc("fe25519.cuh")  # the one copy, which every Ed25519 and sr25519 source includes
    for name, value in want.items():
        m = re.search(name + r"\[10\] = \{([^}]*)\}", text)
        assert m, name
        assert [int(v, 16) for v in m.group(1).replace("\n", " ").split(",")] == fe.int_to_limbs(value), name
    for source in ("ed25519_verify.cu", "ed25519_resident.cu", "ge25519_group.cuh"):
        assert "__constant__ uint32_t" not in _csrc(source), source
    # the comb layout (fe25519.cuh) is the plain twin's
    for name, value in (("COMB_SLICES", ed25519_batch.COMB_SLICES), ("COMB_COLUMNS", ed25519_batch.COMB_COLUMNS),
                        ("SLICE_ENTRIES", ed25519_batch.SLICE_ENTRIES), ("ENTRY_WORDS", ed25519_batch.ENTRY_WORDS)):
        assert re.search(r"#define %s (\d+)" % name, text).group(1) == str(value), name
    check_group_recodings(_csrc("ge25519_group.cuh"))


def check_group_recodings(text):
    """The grouped core's literals: 4p limb by limb (u - a - b = u + 4p - a -
    b), the mask that takes a scalar mod 2^254 (the bits the plain twin's 127
    radix-4 digits read), the 4-bit windows from bit 252 down that rebuild
    h, and the comb digits that rebuild s."""
    limbs_p = [(1 << 26) - 19] + [(1 << (25 if i & 1 else 26)) - 1 for i in range(1, 10)]
    assert fe.limbs_to_int(limbs_p) == fe.P
    limbs_4p = [4 * v for v in limbs_p]
    for name, value in (("FE_4P_0", limbs_4p[0]), ("FE_4P_ODD", limbs_4p[1]), ("FE_4P_EVEN", limbs_4p[2])):
        assert int(re.search(r"#define %s (0x[0-9A-Fa-f]+)u" % name, text).group(1), 16) == value, name
    assert set(limbs_4p[1::2]) == {limbs_4p[1]} and set(limbs_4p[2::2]) == {limbs_4p[2]}
    masks = {int(m, 16) for m in re.findall(r"w\[7\] &= (0x[0-9A-Fa-f]+)u;", text)}
    assert masks == {(1 << (254 - 224)) - 1}
    first = int(re.search(r"const int bit = (\d+) - 4 \* \(i / 5\)", text).group(1))
    rng = np.random.default_rng(29)
    for _ in range(8):
        n = int.from_bytes(rng.bytes(32), "little")
        kept = n % (1 << 254)
        windows = [(kept >> bit) & 15 for bit in range(first, -1, -4)]
        assert len(windows) == 64 and sum(d << (4 * (63 - k)) for k, d in enumerate(windows)) == kept
        words = torch.tensor([[(kept >> (32 * j)) & 0xFFFFFFFF] for j in range(8)], dtype=torch.int64)
        digits = ed25519_batch.comb_digits(words)[:, :, 0]  # [slice, column]
        total = sum(int(digits[t, c]) >> i & 1 and 1 << (64 * i + 16 * t + c)
                    for t in range(4) for c in range(16) for i in range(4))
        assert total == kept


def check_r_cases():
    """Every way R can fail the projective compare: the wire-level lanes
    (``resident_r_cases`` with their keys, s and h) through the compact and
    word twins against the point arithmetic's verdicts and the reference's
    jitted kernels; the same R values as signatures under the identity key
    through the twins that hash on the card against the CPU verifiers."""
    r_cases = vectors.resident_r_cases()
    want = [c[5] for c in r_cases]
    assert want == [True, False, False, False, True, False, False]
    wire = vectors.wire_rows(r_cases)
    words = np.ascontiguousarray(np.ascontiguousarray(wire.T).view("<u4").T)
    assert ed25519_batch.verify_compact_plain(torch.from_numpy(wire)).tolist() == want
    assert ed25519_batch.verify_words_plain(torch.from_numpy(words)).tolist() == want
    padded = np.zeros((128, _REF_LANES), np.uint8)
    padded[:, : len(want)] = wire
    assert np.asarray(ref_batch.verify_kernel_compact(padded))[: len(want)].tolist() == want
    padded_words = np.zeros((32, _REF_LANES), np.uint32)
    padded_words[:, : len(want)] = words
    assert np.asarray(ref_batch.verify_kernel(jnp.asarray(padded_words)))[: len(want)].tolist() == want
    sig_cases = vectors.r_signature_cases()
    pks, msgs, sigs = _columns(sig_cases)
    cpu = [purepy.ed25519_verify(p, m, s_) for p, m, s_ in zip(pks, msgs, sigs)]
    assert cpu == want == [ref_ed.PubKeyEd25519(p).verify_signature(m, s_) for p, m, s_ in zip(pks, msgs, sigs)]
    w, m, ml, valid = ed25519_batch.prepare_batch_device_hash_compact(pks, msgs, sigs)
    got = ed25519_batch.verify_full_compact_plain(torch.from_numpy(w), torch.from_numpy(m), torch.from_numpy(ml))
    assert (got.numpy() & valid).tolist() == cpu
    w, hi, lo, nb, valid = ed25519_batch.prepare_batch_device_hash(pks, msgs, sigs)
    got = ed25519_batch.verify_full_words_plain(*(torch.from_numpy(x) for x in (w, hi, lo, nb)))
    assert (got.numpy() & valid).tolist() == cpu


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
    check_r_cases()
    with monkeypatch.context() as m:
        check_word_wire(m)
