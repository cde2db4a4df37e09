"""The port's secp256k1 path against the JAX package, on the CPU.

* the field: every operation of cometbft_tpu_torch/crypto/cuda/secp_field.py
  (the CPU twin of csrc/fe256k1.cuh) against Python ints, from the largest
  carried inputs, and the constants written into the CUDA sources (limbs
  of p, n and β, the tables d·G and d·2^128·G, the GLV lattice words);
* GLV: λ³ ≡ 1 (mod n), β³ ≡ 1 (mod p), λ·G = (β·Gx, Gy), the basis
  vectors in the lattice and g1, g2 from their definitions; ``glv_split``
  (the plain twin of the kernel's split) against Python ints on seeded and
  edge scalars (0, 1, n − 1, λ, near the rounding boundaries), with
  k1 + k2·λ ≡ k (mod n) and |k1|, |k2| < 2^128; the reduction mod n and
  the signed radix-16 digits;
* host packing: the port's ``prepare_batch`` u8[128, B], viewed as
  little-endian u32 rows, equals the reference's u32[32, B] byte for byte,
  with the same flags and validity mask;
* the verifier: ``verify_plain`` (the CPU twin of the CUDA kernel
  ``secp256k1_verify``) gives the verdicts of the reference's jitted
  ``verify_kernel`` (called directly, at the reference's 64-lane padded
  shape) and of the reference's ``PubKeySecp256k1.verify_signature`` on
  ``vectors.secp256k1_cases`` and 40 mixed lanes, the wire-level r + n
  and infinity lanes included, and lanes whose GLV and u1 partial sums
  are equal, opposite or zero;
* keys: addresses, public keys and RFC 6979 signatures equal the
  reference's; a secp256k1 ``PublicKey`` round-trips the proto;
* a 12-validator secp256k1 ``ValidatorSet`` carried across with
  ``convert`` gives the reference's ``hash()`` and its ``verify_commit*``
  verdicts and errors, under ``"cpu"`` and under
  ``GPUBatchVerifier(device="cpu")``, which never takes the resident route
  for it (nor for a set that mixes the curves);
* a flush mixing Ed25519 and secp256k1 keys under the gpu verifier comes
  back in input order as Python bools; ``verify_batch`` keeps lane order
  across a chunk edge.

Bytes and verdicts are compared with exact equality. Inputs come from
fixed seeds (cometbft_tpu_torch/crypto/cuda/vectors.py). One test runs
every check (see tests/test_torch_field.py for why each of these files
holds one test).
"""

import copy
import os
import re

import jax.numpy as jnp
import numpy as np
import torch

from cometbft_tpu.crypto import secp256k1 as ref_secp
from cometbft_tpu.crypto.tpu import secp256k1_batch as ref_batch
from cometbft_tpu.proto import keys as ref_keys
from cometbft_tpu.proto.gogo import Timestamp as RefTimestamp
from cometbft_tpu.types import test_util
from cometbft_tpu.types.block import CommitSig as RefCommitSig
from cometbft_tpu.types.priv_validator import MockPV
from cometbft_tpu.types.validator import Validator as RefValidator
from cometbft_tpu.types.validator_set import Fraction as RefFraction
from cometbft_tpu.types.validator_set import ValidatorSet as RefValidatorSet
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import batch as port_batch
from cometbft_tpu_torch.crypto import ed25519 as ed
from cometbft_tpu_torch.crypto import secp256k1 as secp
from cometbft_tpu_torch.crypto.cuda import mesh, secp256k1_batch, secp_field as fe, vectors
from cometbft_tpu_torch.proto import keys as port_keys
from cometbft_tpu_torch.proto.gogo import Timestamp
from cometbft_tpu_torch.types.block import BLOCK_ID_FLAG_COMMIT, BlockID, Commit, CommitSig, PartSetHeader
from cometbft_tpu_torch.types.validator import Validator
from cometbft_tpu_torch.types.validator_set import Fraction, ValidatorSet

torch.set_num_threads(1)

P, N = fe.P, fe.N
_REF_LANES = 64  # the reference's _MIN_PAD: its kernel is compiled at this shape only
_CSRC = os.path.join(os.path.dirname(secp256k1_batch.__file__), "csrc")
CHAIN_ID = "secp-chain"
HEIGHT = 11


def _values(seed, n=24):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    return vals + [0, 1, 2, 7, P - 1, P - 2, 2**255, 2**32 + 977, N, P - N]


def _raw(values):
    """Limbs of each value as given, limb 9 keeping every bit from 234 up."""
    cols = [[(v >> (26 * i)) & fe.MASK for i in range(9)] + [v >> 234] for v in values]
    return torch.tensor(cols, dtype=torch.int64).T.contiguous()


def _max_carried(n):
    limbs = [fe.MASK] * 10
    limbs[1] += 1 << 15
    return torch.tensor(limbs, dtype=torch.int64)[:, None].repeat(1, n)


def check_field_ops():
    a_vals, b_vals = _values(1), _values(2)[::-1]
    a, b = fe.from_ints(a_vals), fe.from_ints(b_vals)
    pairs = list(zip(a_vals, b_vals))
    assert fe.to_ints(fe.add(a, b)) == [(x + y) % P for x, y in pairs]
    assert fe.to_ints(fe.sub(a, b)) == [(x - y) % P for x, y in pairs]
    assert fe.to_ints(fe.mul(a, b)) == [x * y % P for x, y in pairs]
    assert fe.to_ints(fe.sq(a)) == [x * x % P for x in a_vals]
    assert fe.to_ints(fe.neg(a)) == [(-x) % P for x in a_vals]
    assert fe.to_ints(fe.mul_small(a, fe.B3)) == [21 * x % P for x in a_vals]
    assert fe.to_ints(fe.sqrt_candidate(a)) == [pow(x, (P + 1) // 4, P) for x in a_vals]
    # from the largest carried form, every output stays carried
    top = _max_carried(3)
    v = fe.limbs_to_int(top[:, 0].tolist())
    zero = fe.from_ints([0] * 3)
    for out, want in (
        (fe.mul(top, top), v * v),
        (fe.sq(top), v * v),
        (fe.add(top, top), 2 * v),
        (fe.sub(zero, top), -v),
        (fe.sub(top, zero), v),
        (fe.mul_small(top, fe.B3), 21 * v),
    ):
        assert fe.to_ints(out) == [want % P] * 3
        limbs = out.tolist()
        for i in range(10):
            cap = (1 << 26) + ((1 << 15) if i == 1 else 0)
            assert all(0 <= x < cap for x in limbs[i]), (i, limbs[i])
    # canonical form of unreduced values: p, p + 1, 2^256 - 1, 2^256 + 2^32
    # + 976 (folds to p - 1 + ...), and the largest carried form
    raw = [P, P + 1, 2**256 - 1, 2**256 + 2**32 + 976, 2**260 - 1]
    x = torch.cat([_raw(raw), top[:, :1]], dim=1)
    canon = fe.to_canonical(x)
    got = [fe.limbs_to_int(canon[:, k].tolist()) for k in range(canon.shape[1])]
    assert got == [r % P for r in raw] + [v % P]
    assert fe.eq(fe.from_ints([5, 7, 0]), _raw([P + 5, 8, P])).tolist() == [True, False, True]
    assert fe.is_zero(_raw([P, 0, 1])).tolist() == [True, True, False]
    sel = fe.select(torch.tensor([True, False]), fe.from_ints([3, 4]), fe.from_ints([5, 6]))
    assert fe.to_ints(sel) == [3, 6]


def _c_array(src, name):
    body = re.search(name + r"\[[^=]*=\s*\{(.*?)\};", src, re.S).group(1)
    return [int(t, 16) for t in re.findall(r"0x[0-9a-fA-F]+", body)]


def check_cuda_constants():
    with open(os.path.join(_CSRC, "fe256k1.cuh"), encoding="utf-8") as f:
        hdr = f.read()
    with open(os.path.join(_CSRC, "secp256k1_verify.cu"), encoding="utf-8") as f:
        cu = f.read()
    assert _c_array(hdr, "K_P") == [(P >> (26 * i)) & fe.MASK for i in range(10)]
    assert _c_array(hdr, "K_SUB") == [32 * ((P >> (26 * i)) & fe.MASK) for i in range(10)]
    assert _c_array(cu, "K_N") == fe.int_to_limbs(N)
    assert _c_array(cu, "K_BETA") == fe.int_to_limbs(secp256k1_batch.BETA)
    # d·G and d·2^128·G, d = 0..8, each from the reference's G by the
    # port's scalar multiplication, checked on the curve
    g, g128 = secp256k1_batch.g_tables()
    assert g[1][:2] == (ref_secp._GX, ref_secp._GY) and g[0] == g128[0] == (0, 1, 0)
    for tab, base in ((g, 1), (g128, 1 << 128)):
        for d, (x, y, z) in enumerate(tab[1:], start=1):
            assert (x, y) == secp._point_mul(d * base, (secp.GX, secp.GY)) and z == 1
            assert (y * y - x ** 3 - 7) % P == 0
    assert _c_array(cu, "K_GTAB") == [limb for tab in (g, g128) for pt in tab for c in pt for limb in fe.int_to_limbs(c)]

    def words(v, n):
        return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(n)]

    sb = secp256k1_batch
    for name, value, n in (("K_N_WORDS", N, 8), ("K_GLV_G1", sb.GLV_G1, 8), ("K_GLV_G2", sb.GLV_G2, 8),
                           ("K_GLV_A1", sb.GLV_A1, 4), ("K_GLV_A2", sb.GLV_A2, 5), ("K_GLV_MB1", -sb.GLV_B1, 4),
                           ("K_GLV_B2", sb.GLV_B2, 4)):
        assert _c_array(cu, name) == words(value, n), name
    assert (1 << 260) % P == (0x400 << 26) + 0x3D10 and (1 << 256) % P == 0x1000003D1


def check_glv_constants_and_split():
    """λ, β and the lattice from their definitions; the plain split against
    Python ints on seeded and edge scalars."""
    sb = secp256k1_batch
    lam, beta = sb.LAMBDA, sb.BETA
    assert pow(lam, 3, N) == 1 and lam != 1 and pow(beta, 3, P) == 1 and beta != 1
    assert secp._point_mul(lam, (secp.GX, secp.GY)) == (beta * secp.GX % P, secp.GY)
    # the basis vectors lie in the lattice {(a, b): a + b·λ ≡ 0 (mod n)} and are short
    for a, b in ((sb.GLV_A1, sb.GLV_B1), (sb.GLV_A2, sb.GLV_B2)):
        assert (a + b * lam) % N == 0 and abs(a) < 2**129 and abs(b) < 2**129
    assert sb.GLV_A1 * sb.GLV_B2 - sb.GLV_A2 * sb.GLV_B1 == N  # a basis: determinant n
    assert sb.GLV_G1 == (sb.GLV_B2 * 2**384 + N // 2) // N
    assert sb.GLV_G2 == (-sb.GLV_B1 * 2**384 + N // 2) // N
    rng = np.random.default_rng(29)
    ks = [0, 1, 2, N - 1, N - 2, lam, N - lam, (1 + lam) % N, 2**128, 2**128 - 1, 2**255, N // 2]
    ks += [int.from_bytes(rng.bytes(32), "little") % N for _ in range(48)]
    # near the rounding boundaries of c1 and c2: k·g / 2^384 close to m + 1/2
    for g_i in (sb.GLV_G1, sb.GLV_G2):
        for m in (1, 7, 2**64 + 3, 2**126 + 5):
            k = ((2 * m + 1) * 2**383) // g_i
            ks += [v for v in (k - 1, k, k + 1) if 0 <= v < N]
    words = torch.tensor([[(k >> (32 * j)) & 0xFFFFFFFF for j in range(8)] for k in ks], dtype=torch.int64).T
    m1, neg1, m2, neg2 = sb.glv_split(words)
    for i, k in enumerate(ks):
        k1, k2 = sb.glv_split_int(k)
        assert (k1 + k2 * lam - k) % N == 0 and abs(k1) < 2**128 and abs(k2) < 2**128, k
        got1 = sum(int(m1[j, i]) << (32 * j) for j in range(4)) * (-1 if neg1[i] else 1)
        got2 = sum(int(m2[j, i]) << (32 * j) for j in range(4)) * (-1 if neg2[i] else 1)
        assert (got1, got2) == (k1, k2), k
    assert sb.glv_split_int(lam) == (0, 1) and sb.glv_split_int(0) == (0, 0)
    # u2 reduced mod n, and the signed radix-16 digits
    big = [N, N + 1, 2**256 - 1, N - 1, 0, 5]
    w = torch.tensor([[(k >> (32 * j)) & 0xFFFFFFFF for j in range(8)] for k in big], dtype=torch.int64).T
    red = sb.reduce_mod_n(w)
    assert [sum(int(red[j, i]) << (32 * j) for j in range(8)) for i in range(len(big))] == [k % N for k in big]
    digits = sb.signed_digits(words[:4])
    assert int(digits.min()) >= -7 and int(digits.max()) <= 8
    for i, k in enumerate(ks):
        assert sum(int(digits[j, i]) * 16**j for j in range(sb.NUM_WINDOWS)) == k % 2**128


def _columns(cases):
    return [c[1] for c in cases], [c[2] for c in cases], [c[3] for c in cases]


def _as_ref_words(wire_u8):
    """The port's u8[128, B] as the reference's u32[32, B] little-endian rows."""
    return np.ascontiguousarray(np.ascontiguousarray(wire_u8.T).view("<u4").T)


def check_packing_matches_reference():
    cases, _ = vectors.secp256k1_cases()
    pks, msgs, sigs = _columns(cases + vectors.secp256k1_mixed())
    wire, flags, valid = secp256k1_batch.prepare_batch(pks, msgs, sigs)
    ref_wire, ref_flags, ref_valid = ref_batch.prepare_batch(pks, msgs, sigs)
    assert wire.dtype == np.uint8 and wire.shape == (128, len(pks))
    assert ref_wire.dtype == np.uint32 and ref_wire.shape == (32, len(pks))
    assert _as_ref_words(wire).tobytes() == ref_wire.tobytes()
    assert flags.dtype == ref_flags.dtype == np.int32 and flags.tolist() == ref_flags.tolist()
    assert valid.tolist() == ref_valid.tolist()
    assert 0 < valid.sum() < len(pks) and set(flags[valid].tolist()) == {0, 1}  # both prefixes; r + n >= p


def _cpu(pks, msgs, sigs):
    return [len(p) == 33 and secp.PubKeySecp256k1(p).verify_signature(m, s) for p, m, s in zip(pks, msgs, sigs)]


def _ref_cpu(pks, msgs, sigs):
    return [len(p) == 33 and ref_secp.PubKeySecp256k1(p).verify_signature(m, s) for p, m, s in zip(pks, msgs, sigs)]


def _ref_kernel(wire, flags):
    """The reference's jitted verify_kernel on lanes padded to 64 (repeats of
    lane 0), in calls of 64."""
    out = []
    for start in range(0, wire.shape[1], _REF_LANES):
        w = wire[:, start:start + _REF_LANES]
        f = flags[start:start + _REF_LANES]
        pad = _REF_LANES - w.shape[1]
        w = np.concatenate([w, np.repeat(w[:, :1], pad, axis=1)], axis=1)
        f = np.concatenate([f, np.repeat(f[:1], pad)])
        got = ref_batch.verify_kernel(jnp.asarray(_as_ref_words(w)), jnp.asarray(f))
        out += np.asarray(got)[: _REF_LANES - pad].tolist()
    return out


def check_verdicts_match_reference():
    cases, wire_cases = vectors.secp256k1_cases()
    sig_cases = cases + vectors.secp256k1_mixed()
    pks, msgs, sigs = _columns(sig_cases)
    wire, flags, valid = secp256k1_batch.prepare_batch(pks, msgs, sigs)
    w_wire, w_flags, w_want = vectors.secp256k1_wire(wire_cases)
    all_wire = np.concatenate([wire, w_wire], axis=1)
    all_flags = np.concatenate([flags, w_flags])
    plain = secp256k1_batch.verify_plain(torch.from_numpy(all_wire), torch.from_numpy(all_flags)).tolist()
    ref = _ref_kernel(all_wire, all_flags)
    assert plain == ref
    n = len(sig_cases)
    cpu = _cpu(pks, msgs, sigs)
    assert cpu == _ref_cpu(pks, msgs, sigs)
    assert (np.array(plain[:n]) & valid).tolist() == cpu
    assert plain[n:] == w_want == [True, False, False, True, False, True, True, True, True, True]
    assert all(ok == c[0].startswith("valid") for c, ok in zip(sig_cases, cpu))
    assert cpu.count(False) > len(cases) - 6
    # the wrapper on a CPU tensor runs the plain version
    one = torch.from_numpy(np.ascontiguousarray(wire[:, :2]))
    assert secp256k1_batch.verify_kernel(one, torch.from_numpy(flags[:2])).tolist() == plain[:2]


def check_keys_match_reference():
    for i in range(3):
        secret = b"secp-key-%d" % i
        k, rk = secp.gen_priv_key_from_secret(secret), ref_secp.gen_priv_key_from_secret(secret)
        assert k.bytes() == rk.bytes()
        pk, rpk = k.pub_key(), rk.pub_key()
        assert pk.bytes() == rpk.bytes() and pk.address() == rpk.address()
        assert pk.type() == rpk.type() == "secp256k1"
        for msg in (b"", b"rfc6979 %d" % i, bytes(range(200))):
            sig = k.sign(msg)
            assert sig == rk.sign(msg)
            assert pk.verify_signature(msg, sig) and rpk.verify_signature(msg, sig)
            assert not pk.verify_signature(msg + b"!", sig)
    proto = port_keys.pub_key_to_proto(pk)
    ref_proto = ref_keys.pub_key_to_proto(rpk)
    assert proto.encode() == ref_proto.encode()
    back = port_keys.pub_key_from_proto(port_keys.PublicKeyProto.decode(ref_proto.encode()))
    assert isinstance(back, secp.PubKeySecp256k1) and back == pk
    assert Validator.new(pk, 77).bytes() == RefValidator.new(rpk, 77).bytes()


def _secp_world(n=12):
    privs = [MockPV(ref_secp.gen_priv_key_from_secret(b"secp-val-%d" % i)) for i in range(n)]
    vs = RefValidatorSet([RefValidator.new(pv.get_pub_key(), 10 + 9 * i) for i, pv in enumerate(privs)])
    by_addr = {pv.get_pub_key().address(): pv for pv in privs}
    privs = [by_addr[v.address] for v in vs.validators]
    block_id = test_util.make_block_id()
    commit = test_util.make_commit(block_id, HEIGHT, 0, vs, privs, CHAIN_ID, RefTimestamp(1_700_000_000, 7))
    return vs, block_id, commit


def _variants(vs, commit):
    corrupted = copy.deepcopy(commit)
    sig = bytearray(corrupted.signatures[4].signature)
    sig[20] ^= 0x02
    corrupted.signatures[4].signature = bytes(sig)
    under = copy.deepcopy(commit)
    total, absent = vs.total_voting_power(), 0
    for i, v in enumerate(vs.validators):
        under.signatures[i] = RefCommitSig.absent()
        absent += v.voting_power
        if (total - absent) * 3 <= total * 2:
            break
    return {"signed": commit, "corrupted": corrupted, "under_two_thirds": under}


def _outcome(fn):
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001 - the verdict is the exception
        return (type(e).__name__, str(e))


def _calls(vset, block_id, commit, ref):
    frac = RefFraction(1, 3) if ref else Fraction(1, 3)
    return {
        "verify_commit": lambda b: vset.verify_commit(CHAIN_ID, block_id, HEIGHT, commit, backend=b),
        "verify_commit_light": lambda b: vset.verify_commit_light(CHAIN_ID, block_id, HEIGHT, commit, backend=b),
        "verify_commit_light_trusting": lambda b: vset.verify_commit_light_trusting(CHAIN_ID, commit, frac, backend=b),
    }


def check_validator_set(monkeypatch):
    vs, block_id, commit = _secp_world()
    port_vs = convert.validator_set_from_reference(vs.encode())
    port_bid = BlockID.decode(block_id.encode())
    assert port_vs.encode() == vs.encode()
    assert all(isinstance(v.pub_key, secp.PubKeySecp256k1) for v in port_vs.validators)
    assert port_vs.hash(device="cpu") == vs.hash()

    def resident(*_):
        raise AssertionError("a set with secp256k1 keys took the resident route")

    monkeypatch.setattr(port_batch, "verify_commit_valset", resident)
    gpu = lambda: port_batch.GPUBatchVerifier(device="cpu")  # noqa: E731
    seen = set()
    for label, c in _variants(vs, commit).items():
        port_commit = convert.commit_from_reference(c.encode())
        ref_calls = _calls(vs, block_id, c, True)
        for name, fn in _calls(port_vs, port_bid, port_commit, False).items():
            want = _outcome(lambda: ref_calls[name]("cpu"))
            assert _outcome(lambda: fn("cpu")) == want, (label, name)
            assert _outcome(lambda: fn(gpu)) == want, (label, name, "gpu verifier")
            seen.add(None if want is None else want[0])
    assert seen == {None, "ValueError", "ErrNotEnoughVotingPowerSigned"}
    # a set that mixes the curves takes the add()/verify() protocol too
    keys = [ed.gen_priv_key_from_secret(b"mixed-set-%d" % i) for i in range(3)]
    keys += [secp.gen_priv_key_from_secret(b"mixed-set-%d" % i) for i in range(3)]
    mixed, mixed_commit = _port_commit(keys)
    for b in ("cpu", gpu):
        assert _outcome(lambda: mixed.verify_commit(CHAIN_ID, mixed_commit.block_id, HEIGHT, mixed_commit, backend=b)) is None
    bad = copy.deepcopy(mixed_commit)
    i_ed = next(i for i, v in enumerate(mixed.validators) if v.pub_key.type() == ed.KEY_TYPE)
    bad.signatures[i_ed].signature = bytes(64)
    want = _outcome(lambda: mixed.verify_commit(CHAIN_ID, bad.block_id, HEIGHT, bad, backend="cpu"))
    assert want is not None and want[0] == "ValueError"
    assert _outcome(lambda: mixed.verify_commit(CHAIN_ID, bad.block_id, HEIGHT, bad, backend=gpu)) == want


def _port_commit(keys):
    """A port ValidatorSet of ``keys`` and a commit they all sign."""
    vals = ValidatorSet([Validator.new(k.pub_key(), 20 + i) for i, k in enumerate(keys)])
    by_addr = {k.pub_key().address(): k for k in keys}
    block_id = BlockID(b"\x05" * 32, PartSetHeader(4, b"\x06" * 32))
    commit = Commit(height=HEIGHT, round=0, block_id=block_id)
    for v in vals.validators:
        commit.signatures.append(CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, Timestamp(1_700_000_001, 3), b""))
    for i, v in enumerate(vals.validators):
        commit.signatures[i].signature = by_addr[v.address].sign(commit.vote_sign_bytes(CHAIN_ID, i))
    return vals, commit


def check_mixed_flush():
    """Ed25519 and secp256k1 lanes interleaved in one gpu flush (plain
    versions): verdicts in input order, each a Python bool, equal to
    "cpu"'s."""
    cases = vectors.secp256k1_mixed(12, seed=5)
    items = []
    for i, (_, pk, msg, sig) in enumerate(cases):
        items.append((secp.PubKeySecp256k1(pk), msg, sig))
        k = ed.gen_priv_key_from_secret(b"mixed-flush-%d" % i)
        m = b"ed lane %d" % i
        s = k.sign(m)
        if i % 4 == 1:
            s = s[:9] + bytes([s[9] ^ 4]) + s[10:]
        items.append((k.pub_key(), m, s))
    got, cpu = port_batch.GPUBatchVerifier(device="cpu"), port_batch.new_batch_verifier("cpu")
    for pk, msg, sig in items:
        got.add(pk, msg, sig)
        cpu.add(pk, msg, sig)
    ok, mask = got.verify()
    want_ok, want = cpu.verify()
    assert (ok, mask) == (want_ok, want) and not ok
    assert all(type(v) is bool for v in mask) and all(type(v) is bool for v in want)
    assert mask[0::2] == _ref_cpu(*_columns(cases)) and mask[1::2].count(False) == 3
    # the secp256k1 route alone
    only = port_batch.GPUBatchVerifier(device="cpu")
    for pk, msg, sig in items[0::2][:4]:
        only.add(pk, msg, sig)
    ok, mask = only.verify()
    assert mask == want[0::2][:4] and all(type(v) is bool for v in mask)


def check_chunk_edge(monkeypatch):
    cases = vectors.secp256k1_mixed(13, seed=9)
    pks, msgs, sigs = _columns(cases)
    chunks = []
    real = secp256k1_batch.verify_kernel

    def counted(wire, flags):
        chunks.append(wire.shape[1])
        return real(wire, flags)

    monkeypatch.setattr(secp256k1_batch, "verify_kernel", counted)
    assert secp256k1_batch.MAX_CHUNK == 4096
    try:
        mesh.configure_chunk_cap(8)
        got = secp256k1_batch.verify_batch(pks, msgs, sigs, device="cpu")
    finally:
        mesh.configure_chunk_cap(None)
    assert chunks == [8, 5]
    assert got == _cpu(pks, msgs, sigs) and all(type(v) is bool for v in got)
    assert mesh.chunk_cap(secp256k1_batch.MAX_CHUNK) == 4096


def test_secp256k1_matches_reference(monkeypatch):
    check_field_ops()
    check_cuda_constants()
    check_glv_constants_and_split()
    check_packing_matches_reference()
    check_verdicts_match_reference()
    check_keys_match_reference()
    with monkeypatch.context() as m:
        check_validator_set(m)
    check_mixed_flush()
    with monkeypatch.context() as m:
        check_chunk_edge(m)
