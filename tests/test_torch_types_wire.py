"""The port's wire types against the JAX package's, on the CPU, byte for
byte: BitArray, Merkle proofs and proof operators, PartSet, Data/Txs,
Header, Commit, Block and BlockMeta, the Timestamp arithmetic, and the
rest of ValidatorSet (change sets, proposer, copy, validate_basic).

Inputs come from numpy with a fixed seed or from the reference's own
fixtures (cometbft_tpu/types/test_util.py), are carried across as
protobuf bytes (cometbft_tpu_torch/convert.py) where they are messages,
and every encoding, hash and root must be equal; every error, type name
and message. ``BitArray.pick_random`` draws through ``secrets.randbelow``
in both, patched here to a seeded draw so the two can be compared. One
test runs every check (see tests/test_torch_field.py for why each of
these files holds one test).
"""

import copy
import secrets

import numpy as np
import torch
import torch_chain as tc

from cometbft_tpu.crypto import merkle as ref_merkle
from cometbft_tpu.libs.bits import BitArray as RefBitArray
from cometbft_tpu.proto.gogo import Timestamp as RefTimestamp
from cometbft_tpu.types import block as ref_block
from cometbft_tpu.types import evidence as ref_evidence
from cometbft_tpu.types import part_set as ref_part_set
from cometbft_tpu.types import test_util
from cometbft_tpu.types.tx import Txs as RefTxs
from cometbft_tpu.types.validator import Validator as RefValidator
from cometbft_tpu.types.validator_set import ValidatorSet as RefValidatorSet
from cometbft_tpu.types.vote import SIGNED_MSG_TYPE_PRECOMMIT
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.crypto.ed25519 import PubKeyEd25519
from cometbft_tpu_torch.libs.bits import BitArray
from cometbft_tpu_torch.proto import gogo
from cometbft_tpu_torch.proto.gogo import Timestamp
from cometbft_tpu_torch.types import block, part_set
from cometbft_tpu_torch.types.tx import Txs
from cometbft_tpu_torch.types.validator import Validator

torch.set_num_threads(1)

RNG_SEED = 20261018


def _same(port_fn, ref_fn, label):
    got, want = tc.outcome(port_fn), tc.outcome(ref_fn)
    assert got == want, (label, got, want)
    return want


def check_bit_array(monkeypatch):
    rng = np.random.default_rng(RNG_SEED)
    arrays = []
    for bits in (0, 1, 5, 63, 64, 65, 130, 200):
        on = [int(i) for i in np.flatnonzero(rng.random(bits) < 0.4)] if bits else []
        ref, port = RefBitArray(bits), BitArray(bits)
        for i in on + [-1, bits]:
            assert port.set_index(i, True) == ref.set_index(i, True)
        arrays.append((ref, port))
        assert port.elems() == ref.elems() and str(port) == str(ref)
        assert (port.is_empty(), port.is_full(), port.num_true_bits(), port.true_indices()) == \
            (ref.is_empty(), ref.is_full(), ref.num_true_bits(), ref.true_indices())
        assert [port.get_index(i) for i in range(-1, bits + 1)] == [ref.get_index(i) for i in range(-1, bits + 1)]
        full_ref, full_port = ref.not_(), port.not_()
        assert full_port.elems() == full_ref.elems() and full_port.is_full() == full_ref.is_full()
        assert BitArray.from_elems(bits, ref.elems()).elems() == RefBitArray.from_elems(bits, ref.elems()).elems()
    for (r1, p1), (r2, p2) in zip(arrays, arrays[1:] + arrays[:1]):
        for op in ("or_", "and_", "sub"):
            assert getattr(p1, op)(p2).elems() == getattr(r1, op)(r2).elems(), op
        upd_r, upd_p = r1.copy(), p1.copy()
        upd_r.update(r2)
        upd_p.update(p2)
        assert upd_p.elems() == upd_r.elems() and upd_p.size == upd_r.size
    draws = np.random.default_rng(RNG_SEED + 1).integers(0, 1 << 30, 64)
    for ref, port in arrays:
        picks = []
        for label, ba in (("ref", ref), ("port", port)):
            it = iter(draws)
            monkeypatch.setattr(secrets, "randbelow", lambda n, it=it: int(next(it)) % n)
            picks.append([ba.pick_random() for _ in range(8)])
        assert picks[0] == picks[1]


def check_proofs():
    rng = np.random.default_rng(RNG_SEED + 2)
    for n in (0, 1, 2, 3, 5, 8, 13, 33):
        items = [rng.bytes(int(rng.integers(0, 70))) for _ in range(n)]
        root, proofs = merkle.proofs_from_byte_slices(items)
        ref_root, ref_proofs = ref_merkle.proofs_from_byte_slices(items)
        assert root == ref_root == merkle.hash_from_byte_slices(items), n
        for p, rp, item in zip(proofs, ref_proofs, items):
            assert (p.total, p.index, p.leaf_hash, p.aunts) == (rp.total, rp.index, rp.leaf_hash, rp.aunts)
            assert part_set._encode_proof(p) == ref_part_set._encode_proof(rp)
            assert part_set._decode_proof(part_set._encode_proof(p)) == p
            _same(lambda: p.verify(root, item), lambda: rp.verify(ref_root, item), "proof")
            _same(lambda: p.verify(root, item + b"x"), lambda: rp.verify(ref_root, item + b"x"), "leaf")
            _same(lambda: p.verify(b"\x00" * 32, item), lambda: rp.verify(b"\x00" * 32, item), "root")
            for total, index, aunts in ((p.total + 1, p.index, p.aunts), (p.total, -1, p.aunts),
                                        (p.total, p.index, p.aunts[:-1]), (p.total, p.index, p.aunts + [b"\x01" * 32])):
                bad, rbad = merkle.Proof(total, index, p.leaf_hash, aunts), ref_merkle.Proof(total, index, rp.leaf_hash, aunts)
                assert bad.compute_root_hash() == rbad.compute_root_hash()
                _same(lambda: bad.verify(root, item), lambda: rbad.verify(ref_root, item), "bad proof")
    # proof operators: a value under a key, chained through ProofRuntime
    kv = [(b"k%d" % i, rng.bytes(12)) for i in range(5)]
    leaves = [_kv_leaf(k, v) for k, v in kv]
    root, proofs = merkle.proofs_from_byte_slices(leaves)
    for i, (k, v) in enumerate(kv):
        for path, value in ((f"/{k.decode()}", v), (f"/x:{k.hex()}", v), (f"/{k.decode()}", v + b"!"),
                            ("/other", v), ("/a/" + k.decode(), v), ("no-slash", v)):
            port_rt, ref_rt = merkle.ProofRuntime(), ref_merkle.ProofRuntime()
            port_rt.register_op_decoder(merkle.ValueOp.TYPE, lambda op, p=proofs[i]: merkle.ValueOp(op.key, p))
            rp = ref_merkle.Proof(proofs[i].total, proofs[i].index, proofs[i].leaf_hash, proofs[i].aunts)
            ref_rt.register_op_decoder(ref_merkle.ValueOp.TYPE, lambda op, p=rp: ref_merkle.ValueOp(op.key, p))
            ops = merkle.ProofOps([merkle.ProofOp(merkle.ValueOp.TYPE, k, b"")])
            ref_ops = ref_merkle.ProofOps([ref_merkle.ProofOp(ref_merkle.ValueOp.TYPE, k, b"")])
            assert ops.encode() == ref_ops.encode()
            assert merkle.ProofOps.decode(ops.encode()).encode() == ops.encode()
            _same(lambda: port_rt.verify_value(ops.ops, root, path, value),
                  lambda: ref_rt.verify_value(ref_ops.ops, root, path, value), f"value op {path}")
    _same(lambda: merkle.ProofRuntime().decode_proof([merkle.ProofOp("nope", b"", b"")]),
          lambda: ref_merkle.ProofRuntime().decode_proof([ref_merkle.ProofOp("nope", b"", b"")]), "unregistered")


def _kv_leaf(k: bytes, v: bytes) -> bytes:
    from cometbft_tpu_torch.libs import protoio

    return protoio.field_bytes(1, k) + protoio.field_bytes(2, merkle._sha(v))


def check_part_set():
    rng = np.random.default_rng(RNG_SEED + 3)
    for size, part in ((0, 64), (1, 64), (64, 64), (65, 64), (1000, 128), (5000, 4096)):
        data = rng.bytes(size)
        ps, rps = part_set.PartSet.from_data(data, part), ref_part_set.PartSet.from_data(data, part)
        assert ps.header().encode() == rps.header().encode(), size
        assert ps.bit_array().elems() == rps.bit_array().elems()
        assert (ps.count(), ps.byte_size(), ps.is_complete(), ps.get_reader()) == \
            (rps.count(), rps.byte_size(), rps.is_complete(), rps.get_reader())
        for i in range(ps.total()):
            p, rp = ps.get_part(i), rps.get_part(i)
            assert p.encode() == rp.encode()
            assert part_set.Part.decode(rp.encode()).encode() == rp.encode()
        # a receiving set: a tampered part, then the parts
        got = part_set.PartSet.from_header(block.PartSetHeader.decode(rps.header().encode()))
        want = ref_part_set.PartSet.from_header(rps.header())
        p0 = copy.deepcopy(rps.get_part(0))
        p0.bytes_ = p0.bytes_ + b"x"
        assert got.add_part(part_set.Part.decode(p0.encode())) == want.add_part(p0)
        for i in range(rps.total()):
            assert got.add_part(part_set.Part.decode(rps.get_part(i).encode())) == want.add_part(rps.get_part(i))
        assert got.add_part(part_set.Part.decode(rps.get_part(0).encode())) == want.add_part(rps.get_part(0))
        assert got.is_complete() and got.get_reader() == data


def check_header_and_block():
    vals, pvs = tc.make_set([f"h{i}" for i in range(4)], seed=11)
    hdr = tc.header(7, vals, vals)
    port_hdr = convert.header_from_reference(hdr.encode())
    assert port_hdr.encode() == hdr.encode() and port_hdr.hash() == hdr.hash()
    variants = {"ok": hdr}
    for fld, val in (("chain_id", "c" * 51), ("height", 0), ("height", -3), ("data_hash", b"\x01" * 5),
                     ("validators_hash", b""), ("proposer_address", b"\x01" * 3),
                     ("last_block_id", ref_block.BlockID(b"\x01" * 7)), ("app_hash", b"")):
        h = copy.deepcopy(hdr)
        setattr(h, fld, val)
        variants[f"{fld}={val!r}"[:30]] = h
    h = copy.deepcopy(hdr)
    h.version = type(hdr.version)(block=10, app=1)
    variants["block protocol"] = h
    for label, h in variants.items():
        ph = convert.header_from_reference(h.encode())
        assert ph.encode() == h.encode() and ph.hash() == h.hash(), label
        _same(ph.validate_basic, h.validate_basic, label)
    # a block with transactions, a last commit and evidence
    rng = np.random.default_rng(RNG_SEED + 4)
    txs = [rng.bytes(int(rng.integers(1, 300))) for _ in range(9)]
    bid = test_util.make_block_id()
    commit = test_util.make_commit(bid, 6, 0, vals, pvs, tc.CHAIN_ID, RefTimestamp(tc.T0, 0))
    v1 = test_util.make_vote(pvs[0], tc.CHAIN_ID, 0, 6, 0, SIGNED_MSG_TYPE_PRECOMMIT, bid, RefTimestamp(tc.T0, 1))
    v2 = test_util.make_vote(pvs[0], tc.CHAIN_ID, 0, 6, 0, SIGNED_MSG_TYPE_PRECOMMIT,
                             test_util.make_block_id(b"\x03" * 32), RefTimestamp(tc.T0, 2))
    ev = ref_evidence.DuplicateVoteEvidence.new(v1, v2, RefTimestamp(tc.T0, 0), vals)
    rblk = ref_block.make_block(7, txs, commit, [ev])
    rblk.header.chain_id = tc.CHAIN_ID
    rblk.header.proposer_address = vals.validators[0].address
    rblk.header.validators_hash = vals.hash()
    pblk = convert.block_from_reference(rblk.encode())
    assert pblk.encode() == rblk.encode() and pblk.hash() == rblk.hash()
    assert pblk.data.hash() == rblk.data.hash() and pblk.last_commit.hash() == rblk.last_commit.hash()
    _same(pblk.validate_basic, rblk.validate_basic, "block")
    ps, rps = pblk.make_part_set(512), rblk.make_part_set(512)
    assert ps.header().encode() == rps.header().encode()
    assert block.BlockMeta.from_block(pblk, ps).encode() == ref_block.BlockMeta.from_block(rblk, rps).encode()
    assert block.BlockMeta.decode(ref_block.BlockMeta.from_block(rblk, rps).encode()).encode() == \
        ref_block.BlockMeta.from_block(rblk, rps).encode()
    made = block.make_block(7, txs, convert.commit_from_reference(commit.encode()), [convert.evidence_from_reference(ev.bytes())])
    assert made.encode() == ref_block.make_block(7, txs, commit, [ev]).encode()
    tampered = ref_block.Block.decode(rblk.encode())  # no cached hashes
    tampered.data = ref_block.Data(RefTxs(txs + [b"extra"]))
    _same(convert.block_from_reference(tampered.encode()).validate_basic, tampered.validate_basic, "tampered block")
    tampered = ref_block.Block.decode(rblk.encode())
    tampered.last_commit.signatures[1].signature = b""
    _same(convert.block_from_reference(tampered.encode()).validate_basic, tampered.validate_basic, "commit sig")
    t, rt = Txs(txs), RefTxs(txs)
    assert t.hash() == rt.hash()
    for i in (0, 4, 8):
        (r1, p1), (r2, p2) = t.proof(i), rt.proof(i)
        assert r1 == r2 and part_set._encode_proof(p1) == ref_part_set._encode_proof(p2)
    # BlockID, CommitSig and Commit validate_basic
    for label, rb in {"ok": bid, "short hash": ref_block.BlockID(b"\x01" * 5),
                      "part hash": ref_block.BlockID(b"\x01" * 32, ref_block.PartSetHeader(1, b"\x02"))}.items():
        pb = block.BlockID.decode(rb.encode())
        _same(pb.validate_basic, rb.validate_basic, label)
        assert (pb.is_complete(), pb.key()) == (rb.is_complete(), rb.key())
    for label, change in {"flag": ("block_id_flag", 9), "address": ("validator_address", b"\x01"),
                          "no signature": ("signature", b""), "long signature": ("signature", b"\x01" * 65)}.items():
        c = ref_block.Commit.decode(commit.encode())  # no cached hash
        setattr(c.signatures[2], *change)
        pc = convert.commit_from_reference(c.encode())
        _same(pc.signatures[2].validate_basic, c.signatures[2].validate_basic, label)
        _same(pc.validate_basic, c.validate_basic, label)
        assert pc.hash() == c.hash()
    absent = ref_block.Commit.decode(commit.encode())
    absent.signatures[0] = ref_block.CommitSig(ref_block.BLOCK_ID_FLAG_ABSENT, b"\x01" * 20)
    _same(convert.commit_from_reference(absent.encode()).validate_basic, absent.validate_basic, "absent")


def check_timestamps():
    rng = np.random.default_rng(RNG_SEED + 5)
    stamps = [(int(rng.integers(-10**10, 10**10)), int(rng.integers(0, 10**9))) for _ in range(20)]
    for (s1, n1), (s2, n2) in zip(stamps, stamps[1:]):
        a, b, ra, rb = Timestamp(s1, n1), Timestamp(s2, n2), RefTimestamp(s1, n1), RefTimestamp(s2, n2)
        assert (a < b, b > a, a.to_unix_ns(), a.is_zero()) == (ra < rb, rb > ra, ra.to_unix_ns(), ra.is_zero())
        ns = int(rng.integers(-10**15, 10**15))
        assert a.add_ns(ns) == Timestamp(*_pair(ra.add_ns(ns)))
        assert Timestamp.from_unix_ns(ns) == Timestamp(*_pair(RefTimestamp.from_unix_ns(ns)))
        assert gogo.encode_timestamp(4, a) == _ref_gogo().encode_timestamp(4, ra)
        assert gogo.decode_timestamp(a.encode()) == a
    for s in ("", "cosmoshub-4"):
        assert gogo.cdc_encode_string(s) == _ref_gogo().cdc_encode_string(s)
    for n in (0, 1, -5, 2**40):
        assert gogo.cdc_encode_int64(n) == _ref_gogo().cdc_encode_int64(n)
    for b in (b"", b"\x00" * 32):
        assert gogo.cdc_encode_bytes(b) == _ref_gogo().cdc_encode_bytes(b)
    assert Timestamp().is_zero() and gogo.encode_timestamp(1, None, nullable=True) == b""


def _pair(ts):
    return ts.seconds, ts.nanos


def _ref_gogo():
    from cometbft_tpu.proto import gogo as ref_gogo

    return ref_gogo


def check_validator_set_rest():
    """Change sets (adds, updates, deletes and the errors), proposer
    rotation, copy, the lookups, validate_basic and str."""
    rng = np.random.default_rng(RNG_SEED + 6)
    keys = [tc.signers([f"cs{i}"])[0].get_pub_key() for i in range(10)]

    def both(entries):
        ref = [RefValidator.new(keys[k], p) for k, p in entries]
        port = [Validator.new(PubKeyEd25519(keys[k].bytes()), p) for k, p in entries]
        return ref, port

    built = RefValidatorSet(both([(k, int(rng.integers(1, 50))) for k in range(6)])[0])
    # both sides decoded from the same bytes, so neither proposer is an
    # alias of a validator in the list
    ref_vs = RefValidatorSet.decode(built.encode())
    port_vs = convert.validator_set_from_reference(built.encode())
    assert port_vs.encode() == ref_vs.encode()
    changes = [
        [(6, 30)], [(0, 0)], [(1, 77), (7, 5)], [(2, 0), (3, 0)], [(8, -1)], [(9, 0)],
        [(4, 10), (4, 11)], [(5, 2**62)], [(0, 9)], [(1, 0), (8, 40)],
    ]
    for step, entries in enumerate(changes):
        ref_c, port_c = both(entries)
        _same(lambda: port_vs.update_with_change_set(port_c), lambda: ref_vs.update_with_change_set(ref_c), f"step {step}")
        assert port_vs.encode() == ref_vs.encode(), step
        if not port_vs.is_nil_or_empty():
            port_vs.increment_proposer_priority(1 + step % 3)
            ref_vs.increment_proposer_priority(1 + step % 3)
            assert port_vs.get_proposer().encode() == ref_vs.get_proposer().encode(), step
            assert port_vs.encode() == ref_vs.encode(), step
    assert port_vs.copy().encode() == ref_vs.copy().encode()
    assert str(port_vs) == str(ref_vs)
    assert [v.encode() for v in port_vs] == [v.encode() for v in ref_vs]
    for i in (-1, 0, port_vs.size() - 1, port_vs.size()):
        (a, v), (ra, rv) = port_vs.get_by_index(i), ref_vs.get_by_index(i)
        assert a == ra and (v is None) == (rv is None) and (v is None or v.encode() == rv.encode())
    for k in keys:
        assert port_vs.has_address(k.address()) == ref_vs.has_address(k.address())
    bad = copy.deepcopy(ref_vs)
    bad.validators[1].address = b"\x01"
    for label, rv in {"ok": ref_vs, "address": bad, "empty": RefValidatorSet([])}.items():
        pv = convert.validator_set_from_reference(rv.encode())
        _same(pv.validate_basic, rv.validate_basic, label)
    assert RefValidatorSet([]).get_proposer() is None and convert.validator_set_from_reference(b"").get_proposer() is None


def test_wire_types_match_reference(monkeypatch):
    check_bit_array(monkeypatch)
    check_proofs()
    check_part_set()
    check_header_and_block()
    check_timestamps()
    check_validator_set_rest()
