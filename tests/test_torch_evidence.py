"""The port's evidence types and their verification
(cometbft_tpu_torch/types/evidence.py, evidence/verify.py) against the JAX
package's, on the CPU.

* DuplicateVoteEvidence: a validator of a six-validator set signs two
  precommits at one height for two blocks. The evidence is built by the
  reference (``DuplicateVoteEvidence.new``), carried across as its bytes
  (cometbft_tpu_torch/convert.py), and verify_duplicate_vote must give the
  reference's outcome for it and for every way it can be wrong: the
  powers, each signature, the same block twice, two validators, a
  stranger, h/r/s that differ. Its two signatures are checked serially
  (``PubKey.verify_signature``), as the reference does.
* LightClientAttackEvidence: a lunatic attack, a conflicting block at
  height 12 signed by a set that keeps four of the common set's six, from
  a common height of 10; an equivocation at height 12 by the common set
  itself; and tampered copies (a corrupted signature, a wrong total
  power, a set that keeps too little power, a header not derived as the
  trusted one). verify_light_client_attack must give the reference's
  outcome under ``"cpu"`` and under
  ``lambda: GPUBatchVerifier(device="cpu")``.
* bytes(), hash(), abci(), validate_basic() and str() of each, and
  evidence_list_hash, equal the reference's.

Outcomes are compared as exception type name and message; bytes and
hashes with exact equality. One test runs every check (see
tests/test_torch_field.py for why each of these files holds one test).
"""

import copy

import torch
import torch_chain as tc

from cometbft_tpu.evidence import verify as ref_verify
from cometbft_tpu.proto.gogo import Timestamp as RefTimestamp
from cometbft_tpu.types import evidence as ref_evidence
from cometbft_tpu.types import test_util
from cometbft_tpu.types.vote import SIGNED_MSG_TYPE_PRECOMMIT
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.evidence import verify
from cometbft_tpu_torch.types import evidence

torch.set_num_threads(1)

BACKENDS = ("cpu", tc.gpu_on_cpu)


def _vote(pv, idx, height, block_id, ts=5, round_=0):
    return test_util.make_vote(
        pv, tc.CHAIN_ID, idx, height, round_, SIGNED_MSG_TYPE_PRECOMMIT, block_id,
        RefTimestamp(tc.T0 + ts, 0),
    )


def _flip(vote):
    bad = copy.deepcopy(vote)
    sig = bytearray(bad.signature)
    sig[3] ^= 1
    bad.signature = bytes(sig)
    return bad


def _duplicate_cases():
    a, pvs = tc.make_set([f"a{i}" for i in range(6)], seed=1)
    bid1 = test_util.make_block_id(b"\x01" * 32)
    bid2 = test_util.make_block_id(b"\x02" * 32)
    v1, v2 = _vote(pvs[0], 0, 10, bid1), _vote(pvs[0], 0, 10, bid2)
    ev = ref_evidence.DuplicateVoteEvidence.new(v1, v2, RefTimestamp(tc.T0, 0), a)
    stranger = tc.signers(["stranger"])[0]

    def variant(**changes):
        e = copy.deepcopy(ev)
        for k, v in changes.items():
            setattr(e, k, v)
        return e

    return a, {
        "valid": ev,
        "validator power": variant(validator_power=ev.validator_power + 1),
        "total power": variant(total_voting_power=ev.total_voting_power + 1),
        "signature A": variant(vote_a=_flip(ev.vote_a)),
        "signature B": variant(vote_b=_flip(ev.vote_b)),
        "same block": variant(vote_b=_vote(pvs[0], 0, 10, ev.vote_a.block_id, ts=9)),
        "two validators": variant(vote_b=_vote(pvs[1], 1, 10, ev.vote_b.block_id)),
        "stranger": variant(vote_a=_vote(stranger, 0, 10, bid1), vote_b=_vote(stranger, 0, 10, bid2)),
        "heights": variant(vote_b=_vote(pvs[0], 0, 11, ev.vote_b.block_id)),
    }


def check_duplicate_vote():
    a, cases = _duplicate_cases()
    port_a = tc.port_vals(a)
    for label, ev in cases.items():
        port_ev = convert.evidence_from_reference(ev.bytes())
        assert type(port_ev).__name__ == "DuplicateVoteEvidence"
        assert port_ev.bytes() == ev.bytes() and port_ev.hash() == ev.hash(), label
        assert [m.encode() for m in port_ev.abci()] == [m.encode() for m in ev.abci()], label
        assert str(port_ev) == str(ev), label
        assert tc.outcome(port_ev.validate_basic) == tc.outcome(ev.validate_basic), label
        want = tc.outcome(lambda: ref_verify.verify_duplicate_vote(ev, tc.CHAIN_ID, a))
        got = tc.outcome(lambda: verify.verify_duplicate_vote(port_ev, tc.CHAIN_ID, port_a))
        assert got == want, (label, got, want)
        assert (want is None) == (label == "valid"), (label, want)
    evs = list(cases.values())[:3]
    port_evs = [convert.evidence_from_reference(e.bytes()) for e in evs]
    assert evidence.evidence_list_hash(port_evs) == ref_evidence.evidence_list_hash(evs)
    assert evidence.encode_evidence_list(port_evs) == ref_evidence.encode_evidence_list(evs)


def _attack_cases():
    a, a_pvs = tc.make_set([f"a{i}" for i in range(6)], seed=1)
    b, b_pvs = tc.make_set([f"a{i}" for i in range(4)] + ["x0", "x1"], seed=4)
    c, c_pvs = tc.make_set(["a5", "y0", "y1", "y2", "y3", "y4"], seed=5)
    sh10 = tc.sign(tc.header(10, a, a), a, a_pvs)
    sh12 = tc.sign(tc.header(12, a, a), a, a_pvs)

    def attack(vals, pvs, common_height=10, app=b"lunatic", next_vals=None):
        sh = tc.sign(tc.header(12, vals, next_vals or vals, app=app), vals, pvs)
        return ref_evidence.LightClientAttackEvidence(
            conflicting_block=tc.light_block(sh, vals),
            common_height=common_height,
            byzantine_validators=[v.copy() for v in vals.validators[:2]],
            total_voting_power=a.total_voting_power(),
            timestamp=sh10.header.time,
        )

    lunatic = attack(b, b_pvs)
    corrupted = copy.deepcopy(lunatic)
    a_addrs = {v.address for v in a.validators}
    sigs = corrupted.conflicting_block.signed_header.commit.signatures
    i = next(i for i, cs in enumerate(sigs) if cs.validator_address in a_addrs)
    sigs[i].signature = sigs[i].signature[:9] + bytes([sigs[i].signature[9] ^ 4]) + sigs[i].signature[10:]
    wrong_power = copy.deepcopy(lunatic)
    wrong_power.total_voting_power += 1
    # (evidence, common header, trusted header)
    return a, {
        "lunatic": (lunatic, sh10, sh12),
        "corrupted signature": (corrupted, sh10, sh12),
        "total power": (wrong_power, sh10, sh12),
        "too little power kept": (attack(c, c_pvs), sh10, sh12),
        "equivocation": (attack(a, a_pvs, common_height=12, app=b"equivocation"), sh12, sh12),
        "not derived": (attack(a, a_pvs, common_height=12, app=b"equivocation", next_vals=b), sh12, sh12),
        "same header": (attack(a, a_pvs, common_height=12, app=b"app"), sh12, sh12),
    }


def check_light_client_attack():
    a, cases = _attack_cases()
    port_a = tc.port_vals(a)
    results = {}
    for label, (ev, common, trusted) in cases.items():
        port_ev = convert.evidence_from_reference(ev.bytes())
        assert type(port_ev).__name__ == "LightClientAttackEvidence"
        assert port_ev.bytes() == ev.bytes() and port_ev.hash() == ev.hash(), label
        assert [m.encode() for m in port_ev.abci()] == [m.encode() for m in ev.abci()], label
        assert tc.outcome(port_ev.validate_basic) == tc.outcome(ev.validate_basic), label
        want = tc.outcome(lambda: ref_verify.verify_light_client_attack(ev, common, trusted, a, backend="cpu"))
        for backend in BACKENDS:
            got = tc.outcome(lambda: verify.verify_light_client_attack(
                port_ev, tc.port_sh(common), tc.port_sh(trusted), port_a, backend=backend))
            assert got == want, (label, backend, got, want)
        results[label] = want
    assert results["lunatic"] is None and results["equivocation"] is None
    assert "wrong signature" in results["corrupted signature"][1]
    assert "total voting power" in results["total power"][1]
    assert results["too little power kept"][0] == "ErrNotEnoughVotingPowerSigned"
    assert "correctly derived" in results["not derived"][1]
    assert results["same header"] is not None


def test_evidence_matches_reference():
    check_duplicate_vote()
    check_light_client_attack()
