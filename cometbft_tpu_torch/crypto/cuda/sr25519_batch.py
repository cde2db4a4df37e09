"""Batched sr25519 (schnorrkel) verification on the card: host packing, the
plain torch verifier, and the wrapper around the hand-written CUDA kernel.

Reference: cometbft_tpu/crypto/tpu/sr25519_batch.py. Its device program
``_verify_core`` (``verify_kernel`` :140) maps u32[32, B] little-endian
words of A, R, s and the merlin challenge k to bool[B]. The port ships the
same 128 bytes a lane as u8[128, B], byte-major like the Ed25519 compact
wire (row k of lane b is byte k of its record: rows 0:32 A, 32:64 R,
64:96 s, 96:128 k); viewed as little-endian u32 rows it is the reference's
wire word for word. The host packing below is the reference's
``prepare_batch`` (:151): the structural checks of the CPU verifier (a
32-byte key, a 64-byte signature with the schnorrkel format bit, s < L
after unmasking, A and R canonical (< p) and even) and the merlin
challenge k per lane, pure Python on the host as in the reference (the
transcript binds A and R, so it cannot be batched).

The CUDA kernel (``csrc/sr25519_verify.cu``) replaces that jitted XLA
program, ``core_group`` threads a signature: decode A and R as ristretto255
encodings (RFC 9496 §4.3.1: SQRT_RATIO_M1 over ``pow_p58``, ok when the
ratio was a square, t = x·y is non-negative and y ≠ 0), compute
P = s·B + k·(−A) by the Straus core of the Ed25519 wire-key kernels
(``csrc/ge25519_group.cuh``), and accept iff both decodes are
ok and P equals R under ristretto equality, X·y_R == Y·x_R or
Y·y_R == X·x_R (RFC 9496 §4.5, a = −1): a cross-multiplication, no
inversion. ``verify_plain`` below is the same algorithm in torch ops over
the batch: what a CPU tensor runs, and what the kernel is held against on
the card.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from cometbft_tpu_torch.crypto import sr25519 as host
from cometbft_tpu_torch.crypto.cuda import build, field as fe, mesh
from cometbft_tpu_torch.crypto.cuda.ed25519_batch import Point, _words, core_base, joint_straus, unpack_fe
from cometbft_tpu_torch.crypto.cuda.field import L, P

WIRE_ROWS = 128
MAX_CHUNK = 8192  # the reference's _MAX_CHUNK; CBFT_TPU_MAX_CHUNK overrides
GROUP_THREADS_PER_SM = 256  # sr25519_verify's budget for build.group_size, G 4 or 1

LAUNCHES = 0  # sr25519_verify launches (the plain version does not count)


# --- host packing (reference :151) -------------------------------------------


def prepare_batch(
    pub_keys: Sequence[bytes], msgs: Sequence[bytes], sigs: Sequence[bytes]
) -> Tuple[np.ndarray, np.ndarray]:
    """→ (wire u8[128, B], valid bool[B]). A lane that fails a structural
    check is zero-filled and invalid, as the reference's is."""
    n = len(pub_keys)
    valid = np.ones(n, bool)
    rows = []
    blank = bytes(WIRE_ROWS)
    for i in range(n):
        pk, sig = bytes(pub_keys[i]), bytes(sigs[i])
        if len(pk) != 32 or len(sig) != 64 or not sig[63] & 0x80:
            valid[i] = False
            rows.append(blank)
            continue
        s = int.from_bytes(sig[32:], "little") & ((1 << 255) - 1)
        a_int = int.from_bytes(pk, "little")
        r_int = int.from_bytes(sig[:32], "little")
        if s >= L or a_int >= P or r_int >= P or a_int & 1 or r_int & 1:
            valid[i] = False
            rows.append(blank)
            continue
        t = host._signing_transcript(bytes(msgs[i]))
        t.append_message(b"proto-name", b"Schnorr-sig")
        t.append_message(b"sign:pk", pk)
        t.append_message(b"sign:R", sig[:32])
        k = host._challenge_scalar(t, b"sign:c")
        rows.append(pk + sig[:32] + s.to_bytes(32, "little") + k.to_bytes(32, "little"))
    wire = np.frombuffer(b"".join(rows), np.uint8).reshape(n, WIRE_ROWS).T.copy()
    return wire, valid


# --- ristretto255 decode (reference :43-85) ------------------------------------


def _is_neg(x: torch.Tensor) -> torch.Tensor:
    """Ristretto's "negative": the canonical representative is odd."""
    return (fe.to_canonical(x)[0] & 1) == 1


def sqrt_ratio_m1(u: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """RFC 9496 SQRT_RATIO_M1 → (was_square, the non-negative root of u/v,
    or of i·u/v when u/v is not a square)."""
    dev = u.device
    sqrt_m1 = fe.const(fe.SQRT_M1, dev)
    v3 = fe.mul(fe.sq(v), v)
    v7 = fe.mul(fe.sq(v3), v)
    r = fe.mul(fe.mul(u, v3), fe.pow_p58(fe.mul(u, v7)))
    check = fe.mul(v, fe.sq(r))
    neg_u = fe.neg(u)
    correct = fe.eq(check, u)
    flipped = fe.eq(check, neg_u)
    flipped_i = fe.eq(check, fe.mul(neg_u, sqrt_m1))
    r = fe.select(flipped | flipped_i, fe.mul(r, sqrt_m1), r)
    r = fe.select(_is_neg(r), fe.neg(r), r)
    return correct | flipped, r


def ristretto_decode(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """s fe[10, B] (an encoding the host found canonical and even) →
    (x, y, ok) on the Edwards curve (RFC 9496 §4.3.1)."""
    dev = s.device
    one = fe.const(1, dev).expand_as(s)
    ss = fe.sq(s)
    u1 = fe.sub(one, ss)
    u2 = fe.add(one, ss)
    u2_sqr = fe.sq(u2)
    v = fe.sub(fe.neg(fe.mul(fe.mul(fe.const(fe.D, dev), u1), u1)), u2_sqr)
    was_square, invsqrt = sqrt_ratio_m1(one, fe.mul(v, u2_sqr))
    den_x = fe.mul(invsqrt, u2)
    den_y = fe.mul(fe.mul(invsqrt, den_x), v)
    x = fe.mul(fe.add(s, s), den_x)
    x = fe.select(_is_neg(x), fe.neg(x), x)
    y = fe.mul(u1, den_y)
    t = fe.mul(x, y)
    y_zero = (fe.to_canonical(y) == 0).all(dim=0)
    return x, y, was_square & ~_is_neg(t) & ~y_zero


# --- the verifier ---------------------------------------------------------------


def verify_plain(wire: torch.Tensor) -> torch.Tensor:
    """bool[B] from the wire u8[128, B]: s·B + k·(−A) equals R under
    ristretto equality and both decode. The torch twin of
    ``sr25519_verify`` in csrc/sr25519_verify.cu."""
    w = _words(wire)  # int64[32, B]
    ax, ay, ok_a = ristretto_decode(unpack_fe(w[0:8]))
    rx, ry, ok_r = ristretto_decode(unpack_fe(w[8:16]))
    nx = fe.neg(ax)
    one = fe.const(1, wire.device).expand_as(ax)
    neg_a: Point = (nx, ay, one, fe.mul(nx, ay))
    px, py, _, _ = joint_straus(neg_a, w[16:24], w[24:32])
    eq1 = fe.eq(fe.mul(px, ry), fe.mul(py, rx))
    eq2 = fe.eq(fe.mul(py, ry), fe.mul(px, rx))
    return (eq1 | eq2) & ok_a & ok_r


# --- the kernel's wrapper ---------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"cbt_sr25519_verify": [_P, _P, _P, _I, _I, _P]}  # wire, B's comb tables, out, B, group, stream


def core_group(batch: int, device) -> int:
    """Threads a lane for a launch of ``sr25519_verify``: 4 at a flush and at
    a window chunk of 8,192, else 1 (``GROUP_THREADS_PER_SM``)."""
    return build.group_size(batch, device, GROUP_THREADS_PER_SM, groups=(4,))


def verify_kernel(wire: torch.Tensor) -> torch.Tensor:
    """bool[B] from the wire u8[128, B].

    On a CUDA tensor this launches ``sr25519_verify`` (``core_group``
    threads a lane) on the current stream, or raises; a CPU tensor runs
    ``verify_plain``."""
    global LAUNCHES
    if wire.device.type == "cpu":
        return verify_plain(wire)
    build.require_cuda_tensor(wire, "sr25519 wire", torch.uint8, 2)
    if wire.shape[0] != WIRE_ROWS:
        raise ValueError(f"sr25519 wire: expected {WIRE_ROWS} rows, got {wire.shape[0]}")
    batch = wire.shape[1]
    out = torch.empty(batch, dtype=torch.uint8, device=wire.device)
    if batch == 0:
        return out.bool()
    lib = build.load("sr25519_verify", _SIGNATURES)
    group = core_group(batch, wire.device)
    rc = lib.cbt_sr25519_verify(
        wire.data_ptr(), core_base(group, wire.device), out.data_ptr(), batch, group, build.stream_ptr(wire.device)
    )
    build.check(rc, "sr25519_verify")
    LAUNCHES += 1
    return out.bool()


# --- entry point -------------------------------------------------------------------


def verify_batch(
    pub_keys: Sequence[bytes], msgs: Sequence[bytes], sigs: Sequence[bytes], device="cuda"
) -> List[bool]:
    """Per-signature verdicts on ``device`` (reference :212): chunks of at
    most ``mesh.chunk_cap(MAX_CHUNK)`` lanes through ``mesh.dispatch_batch``,
    the merlin challenges of chunk i+1 computed while the card verifies
    chunk i, the result ANDed with the packing's validity mask."""
    n = len(pub_keys)
    if n == 0:
        return []
    valid_full = np.ones(n, bool)

    def chunk(start: int, end: int):
        wire, valid = prepare_batch(pub_keys[start:end], msgs[start:end], sigs[start:end])
        valid_full[start:end] = valid
        return [wire]

    out = mesh.dispatch_batch(verify_kernel, chunk, n, MAX_CHUNK, device)
    return [bool(v) for v in out & valid_full]
