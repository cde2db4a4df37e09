"""The port's ValidatorSet against the JAX package's, on the CPU.

Validator sets and commits are built with the reference
(cometbft_tpu/types/test_util.py), carried across as bytes by
cometbft_tpu_torch/convert.py, and verified by both. The port's
verify_commit, verify_commit_light and verify_commit_light_trusting under
the "cpu" backend (the port's default is the card) must give the reference's verdict under backend="cpu":
the same exception type and message, or none. ``hash()`` must give the
same root, and encoding the carried objects must give the same bytes.
The "gpu" verifier runs here on its plain torch version (device="cpu").
Everything is compared with exact equality. One test runs every
check (see tests/test_torch_field.py for why each of these files holds
one test).
"""

import copy

import torch

from cometbft_tpu.proto.gogo import Timestamp as RefTimestamp
from cometbft_tpu.types import test_util
from cometbft_tpu.types.block import CommitSig as RefCommitSig
from cometbft_tpu.types.validator import Validator as RefValidator
from cometbft_tpu.types.validator_set import Fraction as RefFraction
from cometbft_tpu.types.validator_set import ValidatorSet as RefValidatorSet
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import PubKey
from cometbft_tpu_torch.crypto import batch as port_batch
from cometbft_tpu_torch.crypto import secp256k1 as secp
from cometbft_tpu_torch.crypto.cuda import ed25519_batch, merkle, secp256k1_batch
from cometbft_tpu_torch.crypto.ed25519 import PubKeyEd25519
from cometbft_tpu_torch.types.block import BlockID
from cometbft_tpu_torch.types.validator import Validator
from cometbft_tpu_torch.types.validator_set import Fraction, ValidatorSet

torch.set_num_threads(1)

CHAIN_ID = "test-chain"
HEIGHT = 7
N = 16
_METHODS = ["verify_commit", "verify_commit_light", "verify_commit_light_trusting"]


def _gpu_on_cpu():
    return port_batch.GPUBatchVerifier(device="cpu")


def _world():
    """A 16-validator set with unequal powers (so the light variants stop
    at different prefixes) and a commit that all of them sign."""
    vs, privs = test_util.deterministic_validator_set(N, 10)
    vals = [v.copy() for v in vs.validators]
    for i, v in enumerate(vals):
        v.voting_power = 10 + 7 * i
    vs = RefValidatorSet(vals)
    by_addr = {pv.get_pub_key().address(): pv for pv in privs}
    privs = [by_addr[v.address] for v in vs.validators]
    block_id = test_util.make_block_id()
    commit = test_util.make_commit(
        block_id, HEIGHT, 0, vs, privs, CHAIN_ID, RefTimestamp(1_700_000_000, 42)
    )
    return vs, block_id, commit


def _variants(commit):
    corrupted = copy.deepcopy(commit)
    sig = bytearray(corrupted.signatures[3].signature)
    sig[10] ^= 0x04
    corrupted.signatures[3].signature = bytes(sig)
    under = copy.deepcopy(commit)
    for i in range(N // 2):
        under.signatures[i] = RefCommitSig.absent()
    nil_vote = copy.deepcopy(commit)
    nil_vote.signatures[0].block_id_flag = 3  # BLOCK_ID_FLAG_NIL
    short = copy.deepcopy(commit)
    short.signatures = short.signatures[:-1]
    return {
        "signed": commit,
        "corrupted": corrupted,
        "under_two_thirds": under,
        "nil_vote": nil_vote,
        "wrong_size": short,
    }


def _outcome(fn):
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001 - the verdict is the exception
        return (type(e).__name__, str(e))


def _run(vset, block_id, commit, method, backend, height=HEIGHT):
    """Outcome of one verify call; backend "ref" means the reference's
    "cpu" on reference objects."""
    b = "cpu" if backend == "ref" else backend
    if method == "verify_commit_light_trusting":
        frac = RefFraction(1, 3) if backend == "ref" else Fraction(1, 3)
        return _outcome(lambda: vset.verify_commit_light_trusting(CHAIN_ID, commit, frac, backend=b))
    return _outcome(lambda: getattr(vset, method)(CHAIN_ID, block_id, height, commit, backend=b))


def check_carried_state(vs, block_id, commit):
    port_vs = convert.validator_set_from_reference(vs.encode())
    port_commit = convert.commit_from_reference(commit.encode())
    assert port_vs.encode() == vs.encode()
    assert port_commit.encode() == commit.encode()
    assert BlockID.decode(block_id.encode()).encode() == block_id.encode()
    assert port_vs.total_voting_power() == vs.total_voting_power()
    for i in range(N):
        assert port_commit.vote_sign_bytes(CHAIN_ID, i) == commit.vote_sign_bytes(CHAIN_ID, i), i


def check_hash(vs, block_id, commit):
    port_vs = convert.validator_set_from_reference(vs.encode())
    assert port_vs.hash(device="cpu") == vs.hash()
    leaves = [v.bytes() for v in port_vs.validators]
    assert merkle.hash_from_byte_slices(leaves, device="cpu") == vs.hash()


def check_constructor(vs, block_id, commit):
    """A set built in the port from the same validators picks the same
    order, priorities and proposer as the reference."""
    vals = [Validator.new(PubKeyEd25519(v.pub_key.bytes()), v.voting_power) for v in vs.validators]
    ref = RefValidatorSet([RefValidator.new(v.pub_key, v.voting_power) for v in vs.validators])
    assert ValidatorSet(vals).encode() == ref.encode()


def check_cpu_backend_verdicts(vs, block_id, commit):
    port_vs = convert.validator_set_from_reference(vs.encode())
    port_bid = BlockID.decode(block_id.encode())
    for variant, c in _variants(commit).items():
        port_commit = convert.commit_from_reference(c.encode())
        for method in _METHODS:
            want = _run(vs, block_id, c, method, "ref")
            got = _run(port_vs, port_bid, port_commit, method, "cpu")
            assert got == want, (variant, method, got, want)
    # wrong height and wrong block id
    port_commit = convert.commit_from_reference(commit.encode())
    other = test_util.make_block_id(b"\x09" * 32)
    for method in ("verify_commit", "verify_commit_light"):
        want = _run(vs, block_id, commit, method, "ref", height=HEIGHT + 1)
        assert want is not None
        assert _run(port_vs, port_bid, port_commit, method, "cpu", height=HEIGHT + 1) == want
        want = _run(vs, other, commit, method, "ref")
        assert want is not None
        assert _run(port_vs, BlockID.decode(other.encode()), port_commit, method, "cpu") == want


def check_trusting_a_different_set(vs, block_id, commit):
    """The trusting variant looks validators up by address in a set that
    only partly overlaps the commit's signers."""
    trusted = RefValidatorSet([v.copy() for v in vs.validators[: N // 2]])
    port_trusted = convert.validator_set_from_reference(trusted.encode())
    port_commit = convert.commit_from_reference(commit.encode())
    want = _run(trusted, None, commit, "verify_commit_light_trusting", "ref")
    assert _run(port_trusted, None, port_commit, "verify_commit_light_trusting", "cpu") == want


def check_gpu_verifier_plain_version(vs, block_id, commit):
    port_vs = convert.validator_set_from_reference(vs.encode())
    port_bid = BlockID.decode(block_id.encode())
    variants = _variants(commit)
    for variant in ("signed", "corrupted", "under_two_thirds"):
        c = variants[variant]
        want = _run(vs, block_id, c, "verify_commit", "ref")
        got = _run(port_vs, port_bid, convert.commit_from_reference(c.encode()), "verify_commit", _gpu_on_cpu)
        assert got == want, (variant, got, want)


class _OtherKey(PubKey):
    def bytes(self) -> bytes:
        return b"\x02" * 32

    def type(self) -> str:
        return "bls12_381"  # a key type with no kernel in the port


def check_gpu_verifier_rules(vs, block_id, commit):
    """A key type the port cannot verify raises NotImplementedError before
    any launch, even beside keys it can; a secp256k1 key verifies."""
    launched = []
    real = secp256k1_batch.verify_kernel, ed25519_batch.verify_kernel_compact
    secp256k1_batch.verify_kernel = lambda *a: launched.append("secp256k1") or real[0](*a)
    ed25519_batch.verify_kernel_compact = lambda *a: launched.append("ed25519") or real[1](*a)
    try:
        bv = _gpu_on_cpu()
        k = secp.gen_priv_key_from_secret(b"rules")
        bv.add(k.pub_key(), b"m", k.sign(b"m"))
        bv.add(PubKeyEd25519(vs.validators[0].pub_key.bytes()), b"m", b"\x00" * 64)
        bv.add(_OtherKey(), b"m", b"\x00" * 64)
        try:
            bv.verify()
        except NotImplementedError as e:
            assert "bls12_381" in str(e)
        else:
            raise AssertionError("a bls12_381 key under gpu did not raise NotImplementedError")
        assert launched == []
        bv.add(k.pub_key(), b"m", k.sign(b"m"))
        assert bv.verify() == (True, [True]) and launched == ["secp256k1"]
    finally:
        secp256k1_batch.verify_kernel, ed25519_batch.verify_kernel_compact = real
    assert _gpu_on_cpu().verify() == (False, [])
    assert port_batch.new_batch_verifier("cpu").verify() == (False, [])
    try:
        port_batch.new_batch_verifier("tpu")
    except ValueError:
        pass
    else:
        raise AssertionError("an unknown backend name did not raise ValueError")


def test_validator_set_matches_reference():
    world = _world()
    check_carried_state(*world)
    check_hash(*world)
    check_constructor(*world)
    check_cpu_backend_verdicts(*world)
    check_trusting_a_different_set(*world)
    check_gpu_verifier_plain_version(*world)
    check_gpu_verifier_rules(*world)
