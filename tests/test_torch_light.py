"""The port's light-client verifier (cometbft_tpu_torch/light/verifier.py)
against the JAX package's, on the CPU.

A six-validator set A signs heights 10 and 11; at height 15 a set B, in
which four of A's six stay, signs, and a set C, in which one stays, signs
a rival header. The headers are built and signed with the reference's
types (tests/torch_chain.py), carried across as protobuf bytes, and
verified by both packages: verify_adjacent, verify_non_adjacent and
verify on the signed headers, a corrupted signature, an expired trusted
header, a header from the future, a validators hash that does not match,
next validators that do not match, a set that keeps too little power
(ErrNewValSetCantBeTrusted) and adjacency mistakes; verify_backwards on
the header chain and its failures; validate_trust_level, header_expired
and LightBlock.validate_basic. The reference runs under ``"cpu"``, the
port under ``"cpu"`` and under ``lambda: GPUBatchVerifier(device="cpu")``
(the resident route on the plain twins of the kernels), and each outcome,
exception type name and message, must be equal. One test runs every
check (see tests/test_torch_field.py for why each of these files holds
one test).
"""

import copy

import torch
import torch_chain as tc

from cometbft_tpu.light import verifier as ref_verifier
from cometbft_tpu.proto.gogo import Timestamp as RefTimestamp
from cometbft_tpu.types.block import BlockID as RefBlockID
from cometbft_tpu.types.validator_set import Fraction as RefFraction
from cometbft_tpu_torch.crypto.cuda import keystore
from cometbft_tpu_torch.light import verifier
from cometbft_tpu_torch.proto.gogo import Timestamp
from cometbft_tpu_torch.types.validator_set import Fraction

torch.set_num_threads(1)

PERIOD = 10 * tc.HOUR_NS
DRIFT = 10 * 10**9
NOW = tc.T0 + 200
BACKENDS = ("cpu", tc.gpu_on_cpu)


def _world():
    a, a_pvs = tc.make_set([f"a{i}" for i in range(6)], seed=1)
    b, b_pvs = tc.make_set([f"a{i}" for i in range(4)] + ["b0", "b1"], seed=2)
    c, c_pvs = tc.make_set(["a5", "c0", "c1", "c2", "c3", "c4"], seed=3)
    sh10 = tc.sign(tc.header(10, a, a), a, a_pvs)
    sh10_next_b = tc.sign(tc.header(10, a, b), a, a_pvs)
    last = RefBlockID(sh10.header.hash(), sh10.commit.block_id.part_set_header)
    sh11 = tc.sign(tc.header(11, a, a, last_block_id=last), a, a_pvs)
    sh15 = tc.sign(tc.header(15, b, b), b, b_pvs)
    sh15c = tc.sign(tc.header(15, c, c), c, c_pvs)
    return {
        "a": a, "b": b, "c": c, "sh10": sh10, "sh10_next_b": sh10_next_b,
        "sh11": sh11, "sh15": sh15, "sh15c": sh15c,
    }


def _corrupt(sh, idx):
    bad = copy.deepcopy(sh)
    sig = bytearray(bad.commit.signatures[idx].signature)
    sig[7] ^= 0x20
    bad.commit.signatures[idx].signature = bytes(sig)
    return bad


def _port_args(args):
    out = []
    for a in args:
        if type(a).__name__ == "SignedHeader":
            out.append(tc.port_sh(a))
        elif type(a).__name__ == "ValidatorSet":
            out.append(tc.port_vals(a))
        elif type(a).__name__ == "Timestamp":
            out.append(Timestamp(a.seconds, a.nanos))
        elif type(a).__name__ == "Fraction":
            out.append(Fraction(a.numerator, a.denominator))
        else:
            out.append(a)
    return out


def _same_everywhere(fn_name, *args, label=""):
    """The reference's outcome under "cpu" equals the port's under every
    backend; returns it."""
    want = tc.outcome(lambda: getattr(ref_verifier, fn_name)(*args, backend="cpu"))
    port_args = _port_args(args)
    for backend in BACKENDS:
        got = tc.outcome(lambda: getattr(verifier, fn_name)(*port_args, backend=backend))
        assert got == want, (fn_name, label, backend, got, want)
    return want


def _now(seconds=NOW):
    return RefTimestamp(seconds, 0)


def check_adjacent(w):
    a, sh10, sh11 = w["a"], w["sh10"], w["sh11"]
    cases = {
        "signed": (sh10, sh11, a, PERIOD, _now(), DRIFT),
        "corrupted signature": (sh10, _corrupt(sh11, 2), a, PERIOD, _now(), DRIFT),
        "expired": (sh10, sh11, a, PERIOD, _now(tc.T0 + 11 * 3600), DRIFT),
        "from the future": (sh10, sh11, a, PERIOD, _now(tc.T0 + 52), 10**9),
        "validators hash": (sh10, sh11, w["b"], PERIOD, _now(), DRIFT),
        "next validators": (w["sh10_next_b"], sh11, a, PERIOD, _now(), DRIFT),
        "not adjacent": (sh10, w["sh15"], w["b"], PERIOD, _now(), DRIFT),
    }
    got = {k: _same_everywhere("verify_adjacent", *v, label=k) for k, v in cases.items()}
    assert got["signed"] is None
    assert got["corrupted signature"][0] == "ErrInvalidHeader"
    assert got["expired"][0] == "ErrOldHeaderExpired"
    assert "from the future" in got["from the future"][1]
    assert "to match those that were supplied" in got["validators hash"][1]
    assert got["next validators"][0] == "ErrInvalidHeader"
    assert got["not adjacent"] == ("ValueError", "headers must be adjacent in height")


def check_non_adjacent(w):
    a, sh10 = w["a"], w["sh10"]
    third, two_thirds = RefFraction(1, 3), RefFraction(2, 3)
    # a signer of B that is also in A: its corrupted signature is one the
    # trusting check reads
    a_addrs = {v.address for v in a.validators}
    shared = next(i for i, cs in enumerate(w["sh15"].commit.signatures) if cs.validator_address in a_addrs)
    cases = {
        "signed": (sh10, a, w["sh15"], w["b"], PERIOD, _now(), DRIFT, third),
        "too little power kept": (sh10, a, w["sh15c"], w["c"], PERIOD, _now(), DRIFT, third),
        "trust level 2/3": (sh10, a, w["sh15"], w["b"], PERIOD, _now(), DRIFT, two_thirds),
        "corrupted signature": (sh10, a, _corrupt(w["sh15"], shared), w["b"], PERIOD, _now(), DRIFT, third),
        "expired": (sh10, a, w["sh15"], w["b"], PERIOD, _now(tc.T0 + 11 * 3600), DRIFT, third),
        "validators hash": (sh10, a, w["sh15"], w["c"], PERIOD, _now(), DRIFT, third),
        "adjacent": (sh10, a, w["sh11"], a, PERIOD, _now(), DRIFT, third),
    }
    got = {k: _same_everywhere("verify_non_adjacent", *v, label=k) for k, v in cases.items()}
    assert got["signed"] is None
    assert got["too little power kept"][0] == "ErrNewValSetCantBeTrusted"
    assert got["corrupted signature"][0] == "ValueError" and "wrong signature" in got["corrupted signature"][1]
    assert got["expired"][0] == "ErrOldHeaderExpired"
    assert got["adjacent"] == ("ValueError", "headers must be non adjacent in height")
    # verify dispatches on adjacency
    third = RefFraction(1, 3)
    for label, args in {
        "adjacent": (sh10, a, w["sh11"], a, PERIOD, _now(), DRIFT, third),
        "non-adjacent": (sh10, a, w["sh15"], w["b"], PERIOD, _now(), DRIFT, third),
        "non-adjacent, too little power": (sh10, a, w["sh15c"], w["c"], PERIOD, _now(), DRIFT, third),
        "adjacent, corrupted": (sh10, a, _corrupt(w["sh11"], 0), a, PERIOD, _now(), DRIFT, third),
    }.items():
        _same_everywhere("verify", *args, label=label)


def check_backwards(w):
    h10, h11 = w["sh10"].header, w["sh11"].header
    other_chain = copy.deepcopy(h10)
    other_chain.chain_id = "another"
    later = copy.deepcopy(h10)
    later.time = RefTimestamp(h11.time.seconds + 1, 0)
    wrong_hash = copy.deepcopy(h10)
    wrong_hash.app_hash = b"other"
    zero_height = copy.deepcopy(h10)
    zero_height.height = 0
    cases = {"chain": h10, "another chain": other_chain, "not older": later,
             "hash": wrong_hash, "invalid": zero_height}
    for label, untrusted in cases.items():
        want = tc.outcome(lambda: ref_verifier.verify_backwards(untrusted, h11))
        got = tc.outcome(lambda: verifier.verify_backwards(
            tc.convert.header_from_reference(untrusted.encode()), tc.convert.header_from_reference(h11.encode())))
        assert got == want, (label, got, want)
        assert (want is None) == (label == "chain"), (label, want)


def check_helpers(w):
    for n, d in ((1, 3), (1, 2), (1, 1), (1, 4), (2, 1), (0, 0), (2, 3)):
        want = tc.outcome(lambda: ref_verifier.validate_trust_level(RefFraction(n, d)))
        assert tc.outcome(lambda: verifier.validate_trust_level(Fraction(n, d))) == want, (n, d)
    sh = w["sh10"]
    for now_s in (tc.T0 + 100, tc.T0 + 50 + 10 * 3600, tc.T0 + 51 + 10 * 3600):
        assert verifier.header_expired(tc.port_sh(sh), PERIOD, Timestamp(now_s, 0)) == \
            ref_verifier.header_expired(sh, PERIOD, RefTimestamp(now_s, 0))
    for label, lb in {
        "ok": tc.light_block(w["sh15"], w["b"]),
        "wrong set": tc.light_block(w["sh15"], w["c"]),
        "wrong chain": tc.light_block(w["sh10"], w["a"]),
    }.items():
        chain = "another" if label == "wrong chain" else tc.CHAIN_ID
        want = tc.outcome(lambda: lb.validate_basic(chain))
        port_lb = tc.convert.light_block_from_reference(lb.encode())
        assert port_lb.encode() == lb.encode()
        for backend in BACKENDS:
            assert tc.outcome(lambda: port_lb.validate_basic(chain, backend=backend)) == want, (label, backend)


def check_resident_route(w, base):
    """Under the plain-twin gpu verifier the light checks took the
    resident route: A and B uploaded once each, then hits (C's commit is
    never verified: the trusting check on A stops every step to C)."""
    st = keystore.default_store().snapshot()["stats"]
    uploads, hits = st["uploads"] - base["uploads"], st["hits"] - base["hits"]
    assert uploads == 2 and hits > uploads, st


def test_light_verifier_matches_reference():
    keystore.default_store().invalidate()
    base = keystore.default_store().snapshot()["stats"]
    w = _world()
    for name in ("sh10", "sh11", "sh15", "sh15c"):
        assert tc.port_sh(w[name]).encode() == w[name].encode()
        assert tc.port_sh(w[name]).header.hash() == w[name].header.hash()
    check_adjacent(w)
    check_non_adjacent(w)
    check_backwards(w)
    check_helpers(w)
    check_resident_route(w, base)
