"""The port's SHA-256 and Merkle path against hashlib and the JAX package,
on the CPU.

* plain SHA-256 (the CPU twin of the CUDA kernel ``sha256_blocks``) equals
  hashlib and the reference's XLA programs ``_sha256_blocks_xla`` and
  ``sha256_blocks_ragged``, which share the Pallas kernel's contract (the
  Pallas kernel itself is not run in interpret mode here);
* the vectorised ragged padding equals the reference's ``pad_ragged_np``
  byte for byte, empty items and both prefixes included;
* the Merkle root through the port's device route (``merkle_tree``, plain
  version on the CPU) equals the reference's host tree for n in {0, 1, 2,
  3, 5, 180}, and the reference's device tree for n in {3, 180};
* ``merkle_tree``'s plain version through its wrapper equals the
  reference's one-program device tree (``_leaves_and_tree_kernel``) and
  host tree for n in {1, 2, 3, 4, 5, 7, 8, 9, 180, 257}, with leaves on
  both sides of the one- to two-block boundary (55/56 bytes with the 0x00
  prefix);
* one ``merkle_level`` carries the odd tail, and the port's host tree
  equals the reference's.

Digests and roots are compared with exact equality; inputs come from numpy
with fixed seeds. One test runs every check (see tests/test_torch_field.py for why
each of these files holds one test).
"""

import hashlib

import numpy as np
import torch

from cometbft_tpu.crypto import merkle as ref_merkle
from cometbft_tpu.crypto.tpu import merkle as ref_tpu_merkle
from cometbft_tpu.crypto.tpu import sha256 as ref_sha
from cometbft_tpu_torch.crypto import merkle as host_merkle
from cometbft_tpu_torch.crypto.cuda import merkle, sha256

torch.set_num_threads(1)

_LENGTHS = [0, 55, 56, 64, 65, 200]


def _leaves(n: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    # variable lengths, like SimpleValidator encodings
    return [rng.bytes(int(rng.integers(1, 90))) for _ in range(n)]


def check_fixed_form():
    for msg_len in _LENGTHS:
        rng = np.random.default_rng(msg_len)
        msgs = rng.integers(0, 256, (8, msg_len), dtype=np.uint8)
        blocks = sha256.pad_messages_np(msgs, msg_len)
        assert (blocks == ref_sha.pad_messages_np(msgs, msg_len)).all(), msg_len
        got = sha256.to_u32(sha256.sha256_blocks(sha256.from_u32(blocks)))
        assert (got == np.asarray(ref_sha._sha256_blocks_xla(blocks))).all(), msg_len
        digests = sha256.digests_to_bytes_np(got)
        assert (digests == ref_sha.digests_to_bytes_np(got)).all(), msg_len
        for i in range(8):
            assert digests[i].tobytes() == hashlib.sha256(msgs[i].tobytes()).digest(), msg_len


def check_ragged_form():
    rng = np.random.default_rng(1)
    items = [rng.bytes(n) for n in _LENGTHS + _LENGTHS[::-1]]
    blocks, n_live = sha256.pad_ragged_np(items, prefix=b"\x00")
    ref_blocks, ref_live = ref_sha.pad_ragged_np(items, prefix=b"\x00")
    assert (blocks == ref_blocks).all() and (n_live == ref_live).all()
    got = sha256.to_u32(sha256.sha256_blocks(sha256.from_u32(blocks), torch.from_numpy(n_live)))
    assert (got == np.asarray(ref_sha.sha256_blocks_ragged(blocks, n_live))).all()
    for i, item in enumerate(items):
        assert sha256.digests_to_bytes_np(got[i]).tobytes() == hashlib.sha256(b"\x00" + item).digest()


def check_ragged_padding_matches_reference():
    rng = np.random.default_rng(5)
    for n in (0, 1, 7, 180):
        items = [rng.bytes(int(rng.integers(0, 130))) for _ in range(n)]
        items[: n // 3] = [b""] * (n // 3)  # empty items
        for prefix in (b"", b"\x00"):
            blocks, n_live = sha256.pad_ragged_np(items, prefix=prefix)
            ref_blocks, ref_live = ref_sha.pad_ragged_np(items, prefix=prefix)
            assert blocks.dtype == ref_blocks.dtype and n_live.dtype == ref_live.dtype, (n, prefix)
            assert blocks.shape == ref_blocks.shape and blocks.tobytes() == ref_blocks.tobytes(), (n, prefix)
            assert n_live.tobytes() == ref_live.tobytes(), (n, prefix)


def check_wrapper_on_cpu_runs_the_plain_version():
    blocks = sha256.from_u32(sha256.pad_messages_np(np.zeros((2, 3), np.uint8), 3))
    before = sha256.LAUNCHES
    assert sha256.sha256_blocks(blocks).dtype == torch.int32
    assert sha256.LAUNCHES == before


def check_roots_match_reference_host_tree():
    for n in (0, 1, 2, 3, 5, 180):
        items = _leaves(n)
        want = ref_merkle.hash_from_byte_slices(items)
        assert merkle.hash_from_byte_slices(items, device="cpu") == want, n
        assert host_merkle.hash_from_byte_slices(items) == want, n


def check_roots_match_reference_device_tree():
    for n in (3, 180):
        items = _leaves(n, seed=n)
        want = ref_tpu_merkle.hash_from_byte_slices(items, force_device=True)
        assert merkle.hash_from_byte_slices(items, device="cpu") == want, n


def _boundary_leaves(n: int):
    """Items of 53 to 56 bytes (54 and 55 put the 0x00-prefixed leaf at 55
    and 56 bytes, one block and two) and some shorter ones."""
    rng = np.random.default_rng(100 + n)
    return [rng.bytes(int(rng.choice([53, 54, 55, 56, int(rng.integers(1, 53))]))) for _ in range(n)]


def check_tree_matches_reference_device_tree():
    before = merkle.TREE_LAUNCHES
    for n in (1, 2, 3, 4, 5, 7, 8, 9, 180, 257):
        items = _boundary_leaves(n)
        blocks, n_live = sha256.pad_ragged_np(items, prefix=merkle.LEAF_PREFIX)
        root = merkle.merkle_tree(sha256.from_u32(blocks), torch.from_numpy(n_live))
        got = sha256.digests_to_bytes_np(sha256.to_u32(root)[None, :])[0].tobytes()
        assert got == ref_tpu_merkle.hash_from_byte_slices(items, force_device=True), n
        assert got == ref_merkle.hash_from_byte_slices(items), n
    assert merkle.TREE_LAUNCHES == before  # the CPU wrapper launches nothing


def check_level_carries_the_odd_tail():
    for m in (1, 2, 3, 7, 8):
        rng = np.random.default_rng(m)
        d = rng.integers(0, 2**32, (m, 8), dtype=np.uint64).astype(np.uint32)
        out = sha256.to_u32(merkle.merkle_level(sha256.from_u32(d)))
        as_bytes = sha256.digests_to_bytes_np(d)
        assert out.shape == ((m + 1) // 2, 8), m
        for t in range(m // 2):
            want = ref_merkle.inner_hash(as_bytes[2 * t].tobytes(), as_bytes[2 * t + 1].tobytes())
            assert sha256.digests_to_bytes_np(out[t]).tobytes() == want, (m, t)
        if m & 1:
            assert (out[-1] == d[-1]).all(), m


def check_split_point():
    for n in range(1, 70):
        assert host_merkle.get_split_point(n) == ref_merkle.get_split_point(n), n


def test_sha256_and_merkle_match_reference():
    check_fixed_form()
    check_ragged_form()
    check_ragged_padding_matches_reference()
    check_wrapper_on_cpu_runs_the_plain_version()
    check_roots_match_reference_host_tree()
    check_roots_match_reference_device_tree()
    check_tree_matches_reference_device_tree()
    check_level_carries_the_odd_tail()
    check_split_point()
