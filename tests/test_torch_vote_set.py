"""The port's VoteSet and Vote (cometbft_tpu_torch/types/vote_set.py,
types/vote.py) against the JAX package's, on the CPU.

A six-validator set with seeded powers; its precommits for one block,
signed by the reference's MockPV and carried across as protobuf bytes
(cometbft_tpu_torch/convert.py), are added one by one to a reference
VoteSet and to the port's, with ``verify=True``: after each vote the
(added, error) pair or the exception (type name and message, and
ErrVoteConflictingVotes' ``added``), the +2/3 state, the sum and the bit
array must be equal. Then the cases that do not add: a corrupted
signature, a wrong height, a wrong validator index, a duplicate, a second
signature for the same vote, and a conflicting vote before and after
``set_peer_maj23``; ``make_commit`` must encode to the reference's bytes,
``commit_to_vote_set`` must rebuild the set, and ``Vote.validate_basic``,
``Vote.verify`` and ``str`` must agree.

The batch preverify of consensus (reference consensus/state.py:393-442)
runs through the port's boundary: one
``new_batch_verifier(backend, subsystem="consensus")`` flush under the
plain-twin gpu verifier (``lambda: GPUBatchVerifier(device="cpu")``) and
under ``"cpu"`` marks each good vote ``sig_batch_verified``; ``add_vote``
then skips the serial check for exactly those votes (a vote whose marker
names another key is checked serially and refused), and the commit it
makes verifies on the resident route. One test runs every check (see
tests/test_torch_field.py for why each of these files holds one test).
"""

import copy

import torch
import torch_chain as tc

from cometbft_tpu.proto.gogo import Timestamp as RefTimestamp
from cometbft_tpu.types import block as ref_block
from cometbft_tpu.types import test_util
from cometbft_tpu.types.vote import SIGNED_MSG_TYPE_PRECOMMIT
from cometbft_tpu.types.vote_set import VoteSet as RefVoteSet
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import batch as port_batch
from cometbft_tpu_torch.crypto.cuda import keystore
from cometbft_tpu_torch.types import block
from cometbft_tpu_torch.types import vote as port_vote
from cometbft_tpu_torch.types.block import BlockID
from cometbft_tpu_torch.types.vote_set import VoteSet

torch.set_num_threads(1)

HEIGHT = 10


def _world():
    vals, pvs = tc.make_set([f"v{i}" for i in range(6)], seed=7)
    bid = test_util.make_block_id(b"\x05" * 32)
    votes = [
        test_util.make_vote(pv, tc.CHAIN_ID, i, HEIGHT, 0, SIGNED_MSG_TYPE_PRECOMMIT, bid, RefTimestamp(tc.T0 + i, 0))
        for i, pv in enumerate(pvs)
    ]
    return vals, pvs, bid, votes


def _port_vote(v):
    return convert.vote_from_reference(v.encode())


def _add(vs, vote, verify=True):
    """(added, error) or the exception, ErrVoteConflictingVotes' added
    flag with it."""
    try:
        return ("ok",) + tuple(vs.add_vote(vote, verify=verify))
    except Exception as e:  # noqa: BLE001 - the verdict is the exception
        return (type(e).__name__, str(e), getattr(e, "added", None))


def _state(vs):
    maj, ok = vs.two_thirds_majority()
    return (
        vs.has_two_thirds_majority(), vs.has_two_thirds_any(), vs.has_all(), vs.sum_voting_power(),
        vs.bit_array().elems(), maj.encode() if ok else None, vs.is_commit(),
    )


def _both(ref_vs, port_vs, vote, label, verify=True):
    want = _add(ref_vs, vote, verify)
    got = _add(port_vs, _port_vote(vote), verify)
    assert got == want, (label, got, want)
    assert _state(port_vs) == _state(ref_vs), label
    return want


def check_add_votes(world):
    vals, pvs, bid, votes = world
    ref_vs = RefVoteSet(tc.CHAIN_ID, HEIGHT, 0, SIGNED_MSG_TYPE_PRECOMMIT, vals)
    port_vs = VoteSet(tc.CHAIN_ID, HEIGHT, 0, SIGNED_MSG_TYPE_PRECOMMIT, tc.port_vals(vals))
    other = test_util.make_block_id(b"\x06" * 32)
    bad_sig = copy.deepcopy(votes[1])
    bad_sig.signature = bad_sig.signature[:5] + bytes([bad_sig.signature[5] ^ 1]) + bad_sig.signature[6:]
    wrong_height = test_util.make_vote(pvs[1], tc.CHAIN_ID, 1, HEIGHT + 1, 0, SIGNED_MSG_TYPE_PRECOMMIT, bid)
    wrong_index = copy.deepcopy(votes[1])
    wrong_index.validator_index = 2
    out_of_range = copy.deepcopy(votes[1])
    out_of_range.validator_index = 9
    assert _both(ref_vs, port_vs, bad_sig, "corrupted signature")[1] is False
    _both(ref_vs, port_vs, wrong_height, "wrong height")
    _both(ref_vs, port_vs, wrong_index, "wrong index")
    _both(ref_vs, port_vs, out_of_range, "index out of range")
    reached = None
    for i, v in enumerate(votes[:-1]):
        _both(ref_vs, port_vs, v, f"vote {i}")
        if reached is None and port_vs.has_two_thirds_majority():
            reached = i
    assert reached is not None
    _both(ref_vs, port_vs, votes[0], "duplicate")
    resigned = copy.deepcopy(votes[0])
    resigned.timestamp = RefTimestamp(tc.T0 + 100, 0)
    pvs[0].sign_vote(tc.CHAIN_ID, resigned)
    resigned.timestamp = votes[0].timestamp
    _both(ref_vs, port_vs, resigned, "second signature")
    conflicting = test_util.make_vote(pvs[5], tc.CHAIN_ID, 5, HEIGHT, 0, SIGNED_MSG_TYPE_PRECOMMIT, other)
    _both(ref_vs, port_vs, conflicting, "vote for another block")
    equivocation = test_util.make_vote(pvs[2], tc.CHAIN_ID, 2, HEIGHT, 0, SIGNED_MSG_TYPE_PRECOMMIT, other)
    assert _both(ref_vs, port_vs, equivocation, "conflicting")[0] == "ErrVoteConflictingVotes"
    ref_vs.set_peer_maj23("peer", other)
    port_vs.set_peer_maj23("peer", BlockID.decode(other.encode()))
    assert _both(ref_vs, port_vs, equivocation, "conflicting, peer maj23")[0] == "ErrVoteConflictingVotes"
    assert port_vs.bit_array_by_block_id(BlockID.decode(other.encode())).elems() == \
        ref_vs.bit_array_by_block_id(other).elems()
    _both(ref_vs, port_vs, votes[-1], "last vote")
    assert port_vs.make_commit().encode() == ref_vs.make_commit().encode()
    assert str(port_vs) == str(ref_vs)
    assert [v.encode() for v in port_vs.list_votes()] == [v.encode() for v in ref_vs.list_votes()]
    commit = ref_vs.make_commit()
    port_commit = convert.commit_from_reference(commit.encode())
    assert port_commit.hash() == commit.hash()
    rebuilt = block.commit_to_vote_set(tc.CHAIN_ID, port_commit, tc.port_vals(vals))
    assert rebuilt.make_commit().encode() == ref_block.commit_to_vote_set(tc.CHAIN_ID, commit, vals).make_commit().encode()
    for i, v in enumerate(votes):
        assert port_commit.get_vote(i).encode() == commit.get_vote(i).encode()


def check_vote_methods(world):
    vals, pvs, bid, votes = world
    v = votes[0]
    pv = _port_vote(v)
    assert pv.encode() == v.encode() and str(pv) == str(v)
    assert pv.sign_bytes(tc.CHAIN_ID) == v.sign_bytes(tc.CHAIN_ID)
    assert pv.to_commit_sig().encode() == v.to_commit_sig().encode()
    port_vals = tc.port_vals(vals)
    variants = {"ok": v}
    for field, value in (("type", 7), ("height", -1), ("round", -1), ("validator_address", b"\x01"),
                         ("validator_index", -1), ("signature", b""), ("signature", b"\x00" * 65),
                         ("block_id", ref_block.BlockID(b"\x01" * 32))):
        bad = copy.deepcopy(v)
        setattr(bad, field, value)
        variants[f"{field}={value!r}"[:40]] = bad
    for label, rv in variants.items():
        assert tc.outcome(_port_vote(rv).validate_basic) == tc.outcome(rv.validate_basic), label
    for i in (0, 1):
        ref_key = vals.validators[i].pub_key
        port_key = port_vals.validators[i].pub_key
        assert tc.outcome(lambda: pv.verify(tc.CHAIN_ID, port_key)) == tc.outcome(lambda: v.verify(tc.CHAIN_ID, ref_key))
        assert tc.outcome(lambda: pv.verify("other", port_key)) == tc.outcome(lambda: v.verify("other", ref_key))


def check_batch_preverify(world, monkeypatch):
    """The consensus preverify through the port's boundary, then add_vote
    without the serial check, then verify_commit on the resident route."""
    vals, pvs, bid, votes = world
    port_vals = tc.port_vals(vals)
    serial = []
    real_verify = port_vote.Vote.verify
    monkeypatch.setattr(port_vote.Vote, "verify", lambda self, c, k: serial.append(self.validator_index) or real_verify(self, c, k))
    base = keystore.default_store().snapshot()["stats"]
    for backend in ("cpu", tc.gpu_on_cpu):
        keystore.default_store().invalidate()
        port_vals.verify_commit(tc.CHAIN_ID, BlockID.decode(bid.encode()), HEIGHT,
                                convert.commit_from_reference(
                                    test_util.make_commit(bid, HEIGHT, 0, vals, pvs, tc.CHAIN_ID, votes[0].timestamp).encode()),
                                backend=backend)
        pv = [_port_vote(v) for v in votes]
        pv[3].signature = pv[3].signature[:1] + bytes([pv[3].signature[1] ^ 8]) + pv[3].signature[2:]
        bv = port_batch.new_batch_verifier(backend, subsystem="consensus")
        for v in pv:
            _, val = port_vals.get_by_index(v.validator_index)
            bv.add(val.pub_key, v.sign_bytes(tc.CHAIN_ID), v.signature)
        ok, mask = bv.verify()
        assert (ok, mask) == (False, [True, True, True, False, True, True]), backend
        for v, good in zip(pv, mask):
            if good:
                v.sig_batch_verified = (tc.CHAIN_ID, port_vals.validators[v.validator_index].pub_key.bytes())
        pv[4].sig_batch_verified = (tc.CHAIN_ID, port_vals.validators[0].pub_key.bytes())  # names another key
        vs = VoteSet(tc.CHAIN_ID, HEIGHT, 0, SIGNED_MSG_TYPE_PRECOMMIT, port_vals)
        serial.clear()
        results = [vs.add_vote(v) for v in pv]
        assert serial == [3, 4], (backend, serial)
        assert [r[0] for r in results] == [True, True, True, False, True, True], results
        assert "invalid signature" in results[3][1]
        commit = vs.make_commit()
        port_vals.verify_commit(tc.CHAIN_ID, commit.block_id, HEIGHT, commit, backend=backend)
    st = keystore.default_store().snapshot()["stats"]
    # the gpu round: one upload, the indexed preverify flush, a hit
    assert st["uploads"] - base["uploads"] == 1, st
    assert st["indexed_dispatches"] - base["indexed_dispatches"] == 1 and st["hits"] - base["hits"] >= 1, st


def test_vote_set_matches_reference(monkeypatch):
    world = _world()
    check_add_votes(world)
    check_vote_methods(world)
    check_batch_preverify(world, monkeypatch)
