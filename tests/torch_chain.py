"""A small chain built with the JAX package's own types, for the port's
light-client, evidence and vote-set tests: validator sets with seeded
powers, signed headers over them, and carrying each object across to the
port as its protobuf bytes (cometbft_tpu_torch/convert.py).

Not a test module: tests/test_torch_light.py, test_torch_evidence.py and
test_torch_vote_set.py import it.
"""

import hashlib

import numpy as np

from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.proto.gogo import Timestamp as RefTimestamp
from cometbft_tpu.proto.version import ConsensusVersion as RefConsensusVersion
from cometbft_tpu.types import test_util
from cometbft_tpu.types.block import BlockID as RefBlockID
from cometbft_tpu.types.block import Header as RefHeader
from cometbft_tpu.types.block import PartSetHeader as RefPartSetHeader
from cometbft_tpu.types.light_block import LightBlock as RefLightBlock
from cometbft_tpu.types.light_block import SignedHeader as RefSignedHeader
from cometbft_tpu.types.priv_validator import MockPV
from cometbft_tpu.types.validator import Validator as RefValidator
from cometbft_tpu.types.validator_set import ValidatorSet as RefValidatorSet
from cometbft_tpu.version import BLOCK_PROTOCOL
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import batch as port_batch

CHAIN_ID = "light-chain"
T0 = 1_700_000_000  # seconds
HOUR_NS = 3600 * 10**9


def gpu_on_cpu():
    """The "gpu" verifier on its plain torch twins."""
    return port_batch.GPUBatchVerifier(device="cpu")


def outcome(fn):
    """None, or the exception's type name and message."""
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001 - the verdict is the exception
        return (type(e).__name__, str(e))


def signers(tags):
    return [MockPV(ref_ed.gen_priv_key_from_secret(t.encode())) for t in tags]


def make_set(tags, seed):
    """A reference ValidatorSet over the keys named by ``tags`` with
    seeded powers, and its signers in the set's order."""
    pvs = signers(tags)
    powers = np.random.default_rng(seed).integers(10, 100, len(tags))
    vs = RefValidatorSet([RefValidator.new(pv.get_pub_key(), int(p)) for pv, p in zip(pvs, powers)])
    by_addr = {pv.get_pub_key().address(): pv for pv in pvs}
    return vs, [by_addr[v.address] for v in vs.validators]


def _h(tag: str) -> bytes:
    return hashlib.sha256(tag.encode()).digest()


def header(height, vals, next_vals, time_s=None, chain_id=CHAIN_ID, app=b"app", last_block_id=None):
    return RefHeader(
        version=RefConsensusVersion(block=BLOCK_PROTOCOL, app=1),
        chain_id=chain_id,
        height=height,
        time=RefTimestamp(T0 + 5 * height if time_s is None else time_s, 1000 * height),
        last_block_id=last_block_id or RefBlockID(_h(f"last-{height}"), RefPartSetHeader(1, _h(f"lastp-{height}"))),
        last_commit_hash=_h(f"lc-{height}"),
        data_hash=_h(f"data-{height}"),
        validators_hash=vals.hash(),
        next_validators_hash=next_vals.hash(),
        consensus_hash=_h("consensus-params"),
        app_hash=app,
        last_results_hash=_h(f"results-{height}"),
        evidence_hash=_h(""),
        proposer_address=vals.validators[0].address,
    )


def sign(hdr, vals, pvs, chain_id=CHAIN_ID):
    """The SignedHeader of ``hdr`` with a commit every validator signs."""
    block_id = RefBlockID(hdr.hash(), RefPartSetHeader(1, _h(f"parts-{hdr.height}")))
    commit = test_util.make_commit(block_id, hdr.height, 0, vals, pvs, chain_id, hdr.time)
    return RefSignedHeader(hdr, commit)


def light_block(sh, vals):
    return RefLightBlock(sh, vals)


def port_sh(sh):
    return convert.signed_header_from_reference(sh.encode())


def port_vals(vs):
    return convert.validator_set_from_reference(vs.encode())
