"""The port's SHA-512 and mod-L reduction (cometbft_tpu_torch/crypto/cuda/
sha512.py and scalar.py, the CPU twins of csrc/sha512.cuh and
csrc/sc25519.cuh) against the JAX package, hashlib and Python ints.

* the host staging helpers (``stage_ragged_np``, ``pad_ragged_np``,
  ``digests_to_bytes_np``) give the reference's bytes;
* the plain SHA-512 gives hashlib's digest and the reference's jitted
  ``sha512_blocks`` words on tests/test_tpu_sha512.py's messages (the
  shape that file already compiles), and its ``blocks_from_bytes`` the
  reference's words;
* the plain ``sc_reduce`` gives ``int % L`` and the reference's
  ``sc_reduce`` on 0, L−1, L, 2^512−1, multiples of L and seeded random
  digests: the reduction must be exact (h and h + kL verify differently on
  torsioned keys);
* the round constants written into csrc/sha512.cuh are the reference's.

Everything is compared with exact equality. One test runs every check
(see tests/test_torch_field.py for why each of these files holds one
test).
"""

import hashlib
import os
import re

import jax.numpy as jnp
import numpy as np
import torch

from cometbft_tpu.crypto.tpu import scalar as ref_scalar
from cometbft_tpu.crypto.tpu import sha512 as ref_sha512
from cometbft_tpu_torch.crypto.cuda import scalar, sha512

torch.set_num_threads(1)

L = scalar.L
# tests/test_tpu_sha512.py::test_ragged_parity_with_hashlib's messages
_REF_MSGS = [
    b"",
    b"abc",
    b"x" * 111,
    b"y" * 112,
    b"z" * 127,
    b"w" * 128,
    b"q" * 200,
    bytes(range(256)) * 2,
]


def _words_from_hilo(hi, lo):
    """The reference's u32 hi and lo planes → the port's int64 words."""
    return (torch.from_numpy(hi.astype(np.int64)) << 32) | torch.from_numpy(lo.astype(np.int64))


def _hilo_from_words(words):
    """The port's int64 words → the reference's (hi, lo) uint32 planes."""
    w = words.numpy().view(np.uint64)
    return (w >> np.uint64(32)).astype(np.uint32), (w & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _random_msgs(seed: int, n: int, top: int):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(rng.integers(0, top))) for _ in range(n)]


def check_staging_matches_reference():
    for msgs in (_REF_MSGS, _random_msgs(23, 32, 400), [], [b""], [b"a" * 47, b"b" * 48, b"c" * 175, b"d" * 176]):
        for prefix_len in (64, 0, 32):
            got, got_len = sha512.stage_ragged_np(msgs, prefix_len=prefix_len)
            want, want_len = ref_sha512.stage_ragged_np(msgs, prefix_len=prefix_len)
            assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
            assert got.tobytes() == want.tobytes()
            assert got_len.dtype == want_len.dtype and got_len.tolist() == want_len.tolist()
        if msgs:
            got = sha512.pad_ragged_np(msgs)
            want = ref_sha512.pad_ragged_np(msgs)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()
    rng = np.random.default_rng(5)
    hi = rng.integers(0, 2**32, (8, 6), dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, (8, 6), dtype=np.uint64).astype(np.uint32)
    assert sha512.digests_to_bytes_np(hi, lo).tobytes() == ref_sha512.digests_to_bytes_np(hi, lo).tobytes()


def check_plain_sha512_matches_hashlib_and_reference():
    hi, lo, nb = sha512.pad_ragged_np(_REF_MSGS)
    words = _words_from_hilo(hi, lo)
    state = sha512.sha512_blocks_plain(words, torch.from_numpy(nb))
    got_hi, got_lo = _hilo_from_words(state)
    ref_hi, ref_lo = ref_sha512.sha512_blocks(hi, lo, nb)
    assert got_hi.tolist() == np.asarray(ref_hi).tolist()
    assert got_lo.tolist() == np.asarray(ref_lo).tolist()
    digests = sha512.digests_to_bytes_np(got_hi, got_lo)
    assert [d.tobytes() for d in digests] == [hashlib.sha512(m).digest() for m in _REF_MSGS]
    direct = sha512.digest_bytes(state).numpy().astype(np.uint8).T
    assert direct.tobytes() == digests.tobytes()


def check_blocks_from_bytes_matches_reference():
    rng = np.random.default_rng(29)
    msgs = [rng.bytes(n) for n in (0, 47, 48, 175, 176, 111, 112, 9)]
    msg, mlen = sha512.stage_ragged_np(msgs, prefix_len=64)
    prefix = rng.integers(0, 256, (64, len(msgs)), dtype=np.uint8)
    max_blocks = (64 + msg.shape[0]) // 128
    words, n_live = sha512.blocks_from_bytes(
        torch.from_numpy(prefix), torch.from_numpy(msg), torch.from_numpy(mlen), max_blocks
    )
    ref_hi, ref_lo, ref_live = ref_sha512.blocks_from_bytes(
        jnp.asarray(prefix), jnp.asarray(msg), jnp.asarray(mlen), max_blocks
    )
    got_hi, got_lo = _hilo_from_words(words)
    assert got_hi.tolist() == np.asarray(ref_hi).tolist()
    assert got_lo.tolist() == np.asarray(ref_lo).tolist()
    assert n_live.tolist() == np.asarray(ref_live).tolist()
    state = sha512.sha512_blocks_plain(words, n_live)
    digests = sha512.digest_bytes(state).numpy().astype(np.uint8).T
    want = [hashlib.sha512(prefix[:, i].tobytes() + m).digest() for i, m in enumerate(msgs)]
    assert [d.tobytes() for d in digests] == want


def _reduce_port(values):
    raw = np.frombuffer(b"".join(v.to_bytes(64, "little") for v in values), np.uint8)
    digest = torch.from_numpy(raw.reshape(len(values), 64).T.astype(np.int64))
    red = scalar.sc_reduce(scalar.digest_to_limbs(digest))
    out = scalar.words_to_bytes(scalar.to_words(red)).numpy().T
    return [int.from_bytes(out[i].tobytes(), "little") for i in range(len(values))]


def _reduce_reference(values):
    cols = [jnp.array([(v >> (15 * k)) & 0x7FFF for v in values], jnp.int32) for k in range(35)]
    red = np.asarray(ref_scalar.sc_reduce(cols))
    return [sum(int(red[j, i]) << (15 * j) for j in range(17)) for i in range(len(values))]


def check_sc_reduce_is_exact():
    rng = np.random.default_rng(31)
    edges = [0, 1, L - 1, L, L + 1, 2 * L, 8 * L, 7 * L - 3, 2**252, 2**252 - 1, 2**253,
             2**255, 2**256 - 1, (L << 259) + 12345, 2**512 - 1, ((2**512 - 1) // L) * L,
             ((2**512 - 1) // L) * L - 1]
    randoms = [int.from_bytes(rng.bytes(64), "little") for _ in range(47)]
    values = edges + randoms
    want = [v % L for v in values]
    assert _reduce_port(values) == want
    assert _reduce_reference(values) == want
    # many more against Python alone: random widths and values next to kL
    many = [int.from_bytes(rng.bytes(64), "little") >> int(rng.integers(0, 512)) for _ in range(4000)]
    many += [(int.from_bytes(rng.bytes(32), "little") >> int(rng.integers(0, 250))) * L + int(d)
             for d in rng.integers(-2, 3, 4000)]
    many = [v % 2**512 for v in many]
    assert _reduce_port(many) == [v % L for v in many]


def check_digits():
    rng = np.random.default_rng(37)
    raw = rng.integers(0, 256, (32, 9), dtype=np.uint8)
    raw[31] &= 0x1F  # below 2^253, as a reduced scalar is
    words = torch.from_numpy(raw.astype(np.int64))
    words = words[0::4] | (words[1::4] << 8) | (words[2::4] << 16) | (words[3::4] << 24)
    digits = scalar.digits_msb_first(words).numpy()
    for b in range(9):
        v = int.from_bytes(raw[:, b].tobytes(), "little")
        assert [(v >> (2 * k)) & 3 for k in range(126, -1, -1)] == digits[:, b].tolist()


def check_cuda_constants():
    src = os.path.join(os.path.dirname(sha512.__file__), "csrc", "sha512.cuh")
    with open(src, encoding="utf-8") as f:
        text = f.read()
    body = re.search(r"K_SHA512\[80\] = \{([^}]*)\}", text).group(1)
    consts = [int(v.strip().rstrip("ull"), 16) for v in body.split(",")]
    want = [(int(h) << 32) | int(lo) for h, lo in zip(ref_sha512._K_HI, ref_sha512._K_LO)]
    assert consts == want == sha512._K64
    ivs = [int(v, 16) for v in re.findall(r"st\[\d\] = (0x[0-9A-F]+)ull;", text)]
    assert ivs == sha512.IV64 == [(int(h) << 32) | int(lo) for h, lo in zip(ref_sha512._IV_HI, ref_sha512._IV_LO)]


def test_sha512_and_scalar_match_reference():
    check_staging_matches_reference()
    check_plain_sha512_matches_hashlib_and_reference()
    check_blocks_from_bytes_matches_reference()
    check_sc_reduce_is_exact()
    check_digits()
    check_cuda_constants()
