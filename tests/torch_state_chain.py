"""One seeded chain, applied through either package's block-execution
stack: genesis, the kvstore app behind a local proxy, ``BlockExecutor``,
the state store and the block store, all on ``MemDB``.

``Chain(pkg, ...)`` builds the same chain from the same seeds in the JAX
package (``"cometbft_tpu"``) or the port (``"cometbft_tpu_torch"``):
validators with seeded powers, kvstore txs, ``val:`` txs, and a
LastCommit signed by every validator with its own timestamp (so the
block time is a real power-weighted median). Each side builds its own
blocks and commits; the tests compare what comes out as bytes.

Not a test module: tests/test_torch_state.py and test_torch_abci.py
import it.
"""

import base64
import importlib
from types import SimpleNamespace

import numpy as np

T0 = 1_700_000_000
CHAIN_ID = "exec-chain"
REF = "cometbft_tpu"
PORT = "cometbft_tpu_torch"


def modules(pkg: str) -> SimpleNamespace:
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return SimpleNamespace(
        name=pkg, abci=m("abci.types"), client=m("abci.client"), kvstore=m("abci.kvstore"),
        db=m("libs.db"), proxy=m("proxy"), state=m("state"), execution=m("state.execution"),
        store=m("state.store"), block_store=m("store.block_store"), gogo=m("proto.gogo"),
        keys=m("proto.keys"), block=m("types.block"), genesis=m("types.genesis"), tx=m("types.tx"),
        vote=m("types.vote"), part_set=m("types.part_set"), ed=m("crypto.ed25519"),
        pv=m("types.priv_validator"),
    )


def outcome(fn):
    """None, or the exception's type name and message."""
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001 - the verdict is the exception
        return (type(e).__name__, str(e))


def signer(pkg: SimpleNamespace, tag: bytes):
    return pkg.pv.MockPV(pkg.ed.gen_priv_key_from_secret(tag))


def val_tx(pub_key_bytes: bytes, power: int) -> bytes:
    """A kvstore validator update (abci/kvstore.py make_val_set_change_tx)."""
    return b"val:" + base64.b64encode(pub_key_bytes) + b"!%d" % power


def kv_txs(height: int, n: int, size: int, seed: int):
    """``n`` seeded ``key=value`` txs of about ``size`` bytes."""
    rng = np.random.default_rng([seed, height])
    out = []
    for i in range(n):
        value = rng.bytes(max(1, (size - 24) // 2)).hex().encode()
        out.append(b"h%d-k%d=" % (height, i) + value)
    return out


class Chain:
    """A genesis of ``n_vals`` seeded Ed25519 validators and its stores,
    app and executor in one package."""

    def __init__(self, pkg: str, n_vals: int, seed: int, backend, tag: bytes = b"state-val-%d"):
        self.pkg = p = modules(pkg)
        self.backend = backend
        self.signers = [signer(p, tag % i) for i in range(n_vals)]
        powers = np.random.default_rng(seed).integers(10, 100, n_vals)
        self.by_addr = {pv.get_pub_key().address(): pv for pv in self.signers}
        gvs = [
            p.genesis.GenesisValidator(pv.get_pub_key().address(), pv.get_pub_key(), int(w), f"v{i}")
            for i, (pv, w) in enumerate(zip(self.signers, powers))
        ]
        self.genesis = p.genesis.GenesisDoc(
            genesis_time=p.gogo.Timestamp(T0, 0), chain_id=CHAIN_ID, validators=gvs
        )
        self.state = p.state.make_genesis_state(self.genesis)
        self.state_db, self.block_db, self.app_db = p.db.MemDB(), p.db.MemDB(), p.db.MemDB()
        self.state_store = p.store.Store(self.state_db)
        self.state_store.save(self.state)
        self.block_store = p.block_store.BlockStore(self.block_db)
        self.app = p.kvstore.PersistentKVStoreApplication(self.app_db)
        self.conns = p.proxy.new_app_conns(p.client.new_local_client_creator(self.app))
        self.conns.start()
        self.conns.consensus().init_chain_sync(p.abci.RequestInitChain(
            time=self.genesis.genesis_time, chain_id=CHAIN_ID,
            validators=[
                p.abci.ValidatorUpdate(p.keys.pub_key_to_proto(v.pub_key), v.voting_power)
                for v in self.state.validators.validators
            ],
            initial_height=1,
        ))
        self.executor = p.execution.BlockExecutor(
            self.state_store, self.conns.consensus(), crypto_backend=backend
        )
        self.last_commit = p.block.Commit(0, 0, p.block.BlockID(), [])

    def add_signer(self, tag: bytes):
        pv = signer(self.pkg, tag)
        self.by_addr[pv.get_pub_key().address()] = pv
        return pv

    def sign_commit(self, block_id, height: int, vals):
        """Every validator of ``vals`` precommits ``block_id``, each at its
        own time a few seconds after the last block."""
        p = self.pkg
        sigs = []
        for i, v in enumerate(vals.validators):
            ts = p.gogo.Timestamp(T0 + 5 * height, ((height * 7919 + i * 104729) % 999_983) * 1000)
            vote = p.vote.Vote(
                type=p.vote.SIGNED_MSG_TYPE_PRECOMMIT, height=height, round=0, block_id=block_id,
                timestamp=ts, validator_address=v.address, validator_index=i,
            )
            self.by_addr[v.address].sign_vote(CHAIN_ID, vote)
            sigs.append(vote.to_commit_sig())
        return p.block.Commit(height, 0, block_id, sigs)

    def propose(self, height: int, txs):
        """The block at ``height`` over ``self.last_commit`` with ``txs``."""
        p = self.pkg
        proposer = self.state.validators.get_proposer().address
        block, _ = self.executor.create_proposal_block(height, self.state, self.last_commit, proposer)
        block.data.txs = p.tx.Txs(list(txs))
        block.header.data_hash = b""
        block.fill_header()
        block._hash = None
        parts = block.make_part_set(p.part_set.BLOCK_PART_SIZE_BYTES)
        return block, parts, p.block.BlockID(block.hash(), parts.header())

    def apply(self, block, parts, block_id):
        """apply_block, then the block and its commit into the block store
        (nothing is stored when apply_block raises)."""
        height = block.header.height
        self.state, _ = self.executor.apply_block(self.state, block_id, block)
        commit = self.sign_commit(block_id, height, self.state.last_validators)
        self.block_store.save_block(block, parts, commit)
        self.last_commit = commit

    def step(self, height: int, txs):
        block, parts, block_id = self.propose(height, txs)
        self.apply(block, parts, block_id)
        return block

    def snapshot(self, height: int) -> dict:
        """What a height left behind, as bytes."""
        p = self.pkg
        bs = self.block_store
        device = {} if p.name == REF else {"device": None}
        return {
            "state": self.state.encode(),
            "stored_state": self.state_store.load().encode(),
            "app_hash": self.state.app_hash,
            "abci_responses": self.state_store.load_abci_responses(height).encode(),
            "validators_hash": self.state.validators.hash(**device),
            "next_validators_hash": self.state.next_validators.hash(**device),
            "block": bs.load_block(height).encode(),
            "meta": bs.load_block_meta(height).encode(),
            "commit": bs.load_seen_commit(height).encode(),
            "last_commit": bs.load_block_commit(height - 1).encode() if height > 1 else b"",
        }

    def dbs(self):
        return tuple(list(db.iterator()) for db in (self.state_db, self.block_db, self.app_db))

    def stop(self):
        self.conns.stop()
