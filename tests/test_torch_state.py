"""The port's block-execution stack (cometbft_tpu_torch/state/,
store/, abci/kvstore.py, proxy/) against the JAX package's, on the CPU.

One genesis of 4 seeded Ed25519 validators is applied for 6 heights
through the reference's ``BlockExecutor`` under ``"cpu"`` and the port's,
each side building its own blocks and commits from the same seeds
(tests/torch_state_chain.py): kvstore txs at every height and, at height
3, a ``val:`` tx that changes one validator's power and one that adds a
new key. At every height the proposal block, the ``State`` encoding (as
returned and as stored), the app hash, the ABCI responses, both
validator-set hashes, and the block store's block, meta, seen commit and
block commit must be byte-equal. The genesis document crosses as the
reference's JSON (``convert.genesis_doc_from_reference``), and the State,
ABCI responses and meta as bytes.

Then a LastCommit with one corrupted signature: ``apply_block`` must raise
the same error (type and message) in both packages, and leave every
store (state, blocks, app) as it was.

The port runs under ``"cpu"`` (the CPU ladder) and under the gpu routes
on their plain torch twins (``lambda: GPUBatchVerifier(device="cpu")``:
the resident commit route with its key store, which uploads the signing
set at height 2 and again at height 6, the first LastCommit of the
changed set, and the validator-set hashes through ``merkle_tree``'s
twin); both must give the reference's bytes. One test, a case each.
"""

import pytest
import torch
import torch_state_chain as sc

from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import batch as port_batch
from cometbft_tpu_torch.crypto.cuda import keystore

torch.set_num_threads(1)

N_VALS = 4
HEIGHTS = 6
VAL_HEIGHT = 3
SEED = 16


def gpu_on_cpu():
    return port_batch.GPUBatchVerifier(device="cpu")


def txs_at(ref: sc.Chain, height: int):
    txs = sc.kv_txs(height, 12, 100, SEED)
    if height == VAL_HEIGHT:
        changed = ref.signers[1].get_pub_key().bytes()
        added = ref.add_signer(b"state-val-new").get_pub_key().bytes()
        txs += [sc.val_tx(changed, 77), sc.val_tx(added, 31)]
    return txs


def corrupt(commit, idx: int):
    sig = bytearray(commit.signatures[idx].signature)
    sig[7] ^= 0x10
    commit.signatures[idx].signature = bytes(sig)


@pytest.mark.parametrize("backend", ["cpu", "gpu-plain"])
def test_block_execution_matches_reference(backend):
    keystore.default_store().invalidate()
    ref = sc.Chain(sc.REF, N_VALS, SEED, "cpu")
    port = sc.Chain(sc.PORT, N_VALS, SEED, "cpu" if backend == "cpu" else gpu_on_cpu)
    ref_json = ref.genesis.to_json()
    assert port.genesis.to_json() == ref_json
    assert convert.genesis_doc_from_reference(ref_json).to_json() == ref_json
    assert port.state.encode() == ref.state.encode()

    uploads = {}
    for h in range(1, HEIGHTS + 1):
        before = keystore.default_store().snapshot()["stats"]["uploads"]
        txs = txs_at(ref, h)
        if h == VAL_HEIGHT:
            port.add_signer(b"state-val-new")
        rb, rparts, rid = ref.propose(h, txs)
        pb, pparts, pid = port.propose(h, txs)
        assert pb.encode() == rb.encode(), h
        assert pid.encode() == rid.encode(), h
        ref.apply(rb, rparts, rid)
        port.apply(pb, pparts, pid)
        want, got = ref.snapshot(h), port.snapshot(h)
        for key in want:
            assert got[key] == want[key], (h, key)
        assert convert.state_from_reference(want["state"]).encode() == want["state"]
        assert convert.abci_responses_from_reference(want["abci_responses"]).encode() == want["abci_responses"]
        assert convert.block_meta_from_reference(want["meta"]).encode() == want["meta"]
        uploads[h] = keystore.default_store().snapshot()["stats"]["uploads"] - before
    # the gpu routes keep the signing set resident: uploaded at height 2, and
    # again at 6, whose LastCommit the set changed by the val: height signs
    want_uploads = {h: int(backend != "cpu" and h in (2, VAL_HEIGHT + 3)) for h in uploads}
    assert uploads == want_uploads
    # the val: height reached the sets: one power changed, one key added
    assert len(port.state.validators.validators) == N_VALS + 1
    assert port.state.validators.hash(device=None) != port.state_store.load_validators(1).hash(device=None)

    # a corrupted LastCommit signature: the same error, no store touched
    h = HEIGHTS + 1
    txs = sc.kv_txs(h, 12, 100, SEED)
    outcomes = []
    for chain in (ref, port):
        block, parts, block_id = chain.propose(h, txs)
        corrupt(block.last_commit, 2)
        block.last_commit._hash = None
        block.header.last_commit_hash = b""
        block.fill_header()
        block._hash = None
        before = chain.dbs()
        outcomes.append(sc.outcome(lambda: chain.apply(block, parts, block_id)))
        assert chain.dbs() == before
        assert chain.block_store.height() == HEIGHTS and chain.state.last_block_height == HEIGHTS
    assert outcomes[0] is not None and outcomes[0][1].startswith("wrong signature (#2)")
    assert outcomes[1] == outcomes[0]
    ref.stop()
    port.stop()
