"""Batched Ed25519 verification on the card: host packing, the plain torch
verifier, and the wrapper around the hand-written CUDA kernel.

Reference: cometbft_tpu/crypto/tpu/ed25519_batch.py. Its device program
``_verify_core_compact`` (``verify_kernel_compact``, :338-347) maps the
compact wire u8[128, B] — rows 0:32 A, 32:64 R, 64:96 S, 96:128
h = SHA-512(R‖A‖M) mod L, raw little-endian bytes — to bool[B]. The
port keeps that wire and that contract; the host packing below is a copy
of the reference's (:444-583) in numpy and hashlib.

The CUDA kernel (``csrc/ed25519_verify.cu``) replaces that jitted XLA
program with ``core_group`` threads a lane (``csrc/ge25519_group.cuh``).
At a commit (4): the group computes [h](−A), each thread one of a
point's four coordinates, over a table of A's multiples in shared
memory, while the thread beside it decompresses R and computes [s]B from
B's comb tables (``base_tables``); the sum is compared with R in
projective form, so there is no inversion. At a full window (1): one
thread a lane runs the 16-entry table ds·B + dh·(−A) and the 127-step
radix-4 Straus loop, then R's decompression. ``verify_compact_plain``
below computes the same verdicts in torch ops over the batch (the joint
loop; it inverts Z, encodes and byte-compares); it is what a CPU tensor
runs, and what the kernel is held against on the card.

Semantics (reference :33-42): s >= L is rejected on the host (the
``valid`` mask, ANDed with the kernel's verdict); A's y is taken mod p;
a failed decompression rejects; -0 decodes as 0; R is compared as raw
bytes, so a non-canonical R never matches.

The steady-state routes (reference :605-660, :805-1040) verify with the
same contract: ``verify_kernel_resident`` against keys resident on the
device (lane order for a commit, gathered by row index for a flush),
and ``verify_kernel_full_compact`` with h = SHA-512(R‖A‖M) mod L computed
on the card. Each has a plain torch version beside it. The key-store
routes hash on the host whatever ``CBFT_TPU_HASH`` says, as the
reference's do; only ``verify_batch`` (keys shipped) reads it.

The resident route does not rerun the core. When a validator set is
uploaded, ``key_tables_kernel`` (``csrc/ed25519_resident.cu``
``ed25519_key_tables``) decompresses each key once and stores comb
tables of −A beside the key rows: for slice t in 0..3 and j in 0..15
the point Σ_i j_i·2^(64i + 16t)·(−A) in affine Niels form, 8,320 bytes
a key with its validity flag. The base point has the same tables
(``base_tables``, built once a device from the encoding of −B). A lane
is then a 16-column comb over s and h: column c adds the entries that
bits 64i + 16t + c of s and of h select, one doubling a column, and its
group of G threads (``build.group_size``) splits the four slices and
sums them by shuffles. R is decompressed beside the loop, in another warp,
and compared in projective form, so no inversion is left.

``verify_batch`` also carries the reference's u32 word wire
(``CBFT_TPU_WIRE=words``, ``wire_format`` :662): ``verify_kernel_words``
(reference ``_verify_core`` :328, ``verify_kernel`` :335) takes
u32[32, B] little-endian words of A, R, S and h, and
``verify_kernel_full_words`` (reference ``verify_full_kernel`` :351) takes
u32[24, B] words of A, R and S with R ‖ A ‖ M padded into SHA-512 blocks
on the host, as big-endian hi and lo halves [n_blocks, 16, B] and a live
block count a lane. Both enter the same core.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from cometbft_tpu_torch.crypto.cuda import build, field as fe, keystore, mesh, scalar, sha512
from cometbft_tpu_torch.crypto.cuda.field import L, P
from cometbft_tpu_torch.crypto.cuda.scalar import NUM_DIGITS, digits_msb_first

WIRE_ROWS = 128
MAX_CHUNK = 8192  # per-curve default chunk cap; CBFT_TPU_MAX_CHUNK overrides
NATIVE_CHALLENGE_MIN_LANES = 256  # the reference's floor for the native challenges (ed25519_batch.py:490)

# launches of each CUDA kernel (the plain versions do not count)
LAUNCHES = 0  # ed25519_verify_compact
RESIDENT_LAUNCHES = 0  # ed25519_verify_resident
TABLE_LAUNCHES = 0  # ed25519_key_tables
FULL_LAUNCHES = 0  # ed25519_verify_full_compact
WORDS_LAUNCHES = 0  # ed25519_verify_words
FULL_WORDS_LAUNCHES = 0  # ed25519_verify_full_words


# --- host packing (reference ed25519_batch.py:444-583) ----------------------

_L_BYTES_LE = np.frombuffer(L.to_bytes(32, "little"), np.uint8)


def _s_below_l(s_arr: np.ndarray) -> np.ndarray:
    """bool[B]: s < L, compared from the most significant byte down
    (u8[B,32] little-endian in)."""
    n = s_arr.shape[0]
    diff = s_arr.astype(np.int16) - _L_BYTES_LE.astype(np.int16)
    nz_mask = diff != 0
    has_diff = nz_mask.any(axis=1)
    msb_idx = 31 - nz_mask[:, ::-1].argmax(axis=1)
    return has_diff & (diff[np.arange(n), msb_idx] < 0)


def _parse_inputs(pub_keys, sigs):
    """→ (pk_arr u8[B,32], sig_arr u8[B,64], valid) with wrong-length and
    s ≥ L entries masked out (zero-filled placeholders keep the shapes)."""
    n = len(pub_keys)
    valid = np.ones(n, bool)
    pk_parts, sig_parts = [], []
    for i in range(n):
        pk, sig = pub_keys[i], sigs[i]
        if len(pk) != 32 or len(sig) != 64:
            valid[i] = False
            pk_parts.append(b"\x00" * 32)
            sig_parts.append(b"\x00" * 64)
        else:
            pk_parts.append(pk)
            sig_parts.append(sig)
    pk_arr = np.frombuffer(b"".join(pk_parts), np.uint8).reshape(n, 32)
    sig_arr = np.frombuffer(b"".join(sig_parts), np.uint8).reshape(n, 64)
    valid &= _s_below_l(sig_arr[:, 32:])
    return pk_arr, sig_arr, valid


def _challenge_scalars(
    pk_arr: np.ndarray, sig_arr: np.ndarray, msgs, valid: np.ndarray
) -> np.ndarray:
    """h = SHA-512(R ‖ A ‖ M) mod L per valid lane → u8[B,32] little-endian
    (zero on invalid lanes). At 256 lanes and up on a multicore host, one
    native call splits the batch over threads
    (``native.ed25519_challenges``), as the reference's
    crypto/tpu/ed25519_batch.py:476-510 does; below that, on one core, or
    without the native rung, the hashlib loop below, which stays the
    parity oracle."""
    n = len(msgs)
    if (os.cpu_count() or 1) > 1 and n >= NATIVE_CHALLENGE_MIN_LANES:
        from cometbft_tpu_torch import native

        raw = native.ed25519_challenges(
            pk_arr.tobytes(), sig_arr[:, :32].tobytes(), msgs, [bool(v) for v in valid]
        )
        if raw is not None:
            return np.frombuffer(raw, np.uint8).reshape(n, 32).copy()
    h_arr = np.zeros((n, 32), np.uint8)
    sha = hashlib.sha512
    for i in range(n):
        if not valid[i]:
            continue
        h_int = (
            int.from_bytes(
                sha(
                    sig_arr[i, :32].tobytes() + pk_arr[i].tobytes() + bytes(msgs[i])
                ).digest(),
                "little",
            )
            % L
        )
        h_arr[i] = np.frombuffer(h_int.to_bytes(32, "little"), np.uint8)
    return h_arr


def pack_compact_rows(*row_arrs: np.ndarray) -> np.ndarray:
    """Stack u8[B,k] byte arrays into the byte-major wire u8[Σk,B]."""
    n = row_arrs[0].shape[0]
    rows = sum(a.shape[1] for a in row_arrs)
    wire = np.empty((rows, n), np.uint8)
    at = 0
    for a in row_arrs:
        wire[at : at + a.shape[1]] = a.T
        at += a.shape[1]
    return wire


def prepare_batch_compact(
    pub_keys: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
) -> Tuple[np.ndarray, np.ndarray]:
    """→ (wire u8[128,B], valid bool[B]): rows 0:32 A, 32:64 R, 64:96 S,
    96:128 h, raw little-endian bytes."""
    pk_arr, sig_arr, valid = _parse_inputs(pub_keys, sigs)
    h_arr = _challenge_scalars(pk_arr, sig_arr, msgs, valid)
    wire = pack_compact_rows(pk_arr, sig_arr[:, :32], sig_arr[:, 32:], h_arr)
    return wire, valid


def prepare_batch_device_hash_compact(
    pub_keys: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
):
    """→ (wire u8[96,B] rows 0:32 A, 32:64 R, 64:96 S; msg u8[MP,B];
    mlen int32[B]; valid bool[B]): no hashing on the host, the card pads
    and hashes R ‖ A ‖ M itself (reference :610)."""
    pk_arr, sig_arr, valid = _parse_inputs(pub_keys, sigs)
    wire = pack_compact_rows(pk_arr, sig_arr[:, :32], sig_arr[:, 32:])
    msg, mlen = sha512.stage_ragged_np(msgs, prefix_len=64)
    return wire, msg, mlen, valid


def _as_words(rows: np.ndarray) -> np.ndarray:
    """Byte-major rows u8[4k,B] → u32[k,B] little-endian words: the word
    wire carries the compact wire's bytes. A copy, with strides whole
    words even when B is 1 (a view keeps a byte stride on that axis)."""
    return np.ascontiguousarray(rows.T).view("<u4").T.copy()


def prepare_batch(
    pub_keys: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
) -> Tuple[np.ndarray, np.ndarray]:
    """The word wire (reference :521) → (wire u32[32,B], valid): rows 0:8
    A, 8:16 R, 16:24 S, 24:32 h, little-endian words."""
    wire, valid = prepare_batch_compact(pub_keys, msgs, sigs)
    return _as_words(wire), valid


def prepare_batch_device_hash(
    pub_keys: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
):
    """The word wire with h computed on the card (reference :582) →
    (wire u32[24,B] rows A, R, S; msg_hi, msg_lo u32[n_blocks,16,B], the
    big-endian halves of R ‖ A ‖ M padded into SHA-512 blocks on the host;
    nblocks int32[B]; valid)."""
    pk_arr, sig_arr, valid = _parse_inputs(pub_keys, sigs)
    hash_msgs = [
        sig_arr[i, :32].tobytes() + pk_arr[i].tobytes() + bytes(msgs[i])
        for i in range(len(pub_keys))
    ]
    msg_hi, msg_lo, nblocks = sha512.pad_ragged_np(hash_msgs)
    wire = _as_words(pack_compact_rows(pk_arr, sig_arr[:, :32], sig_arr[:, 32:]))
    return wire, msg_hi, msg_lo, nblocks, valid


def _parse_lane_sigs(msgs, sigs) -> Tuple[np.ndarray, np.ndarray]:
    """→ (sig_arr u8[B,64], valid): msgs[i] or sigs[i] None marks an
    absent lane; absent, wrong-length and s ≥ L lanes are zero and
    invalid."""
    n = len(msgs)
    valid = np.ones(n, bool)
    parts = []
    for i in range(n):
        s = sigs[i]
        if s is None or msgs[i] is None or len(s) != 64:
            valid[i] = False
            parts.append(b"\x00" * 64)
        else:
            parts.append(bytes(s))
    sig_arr = np.frombuffer(b"".join(parts), np.uint8).reshape(n, 64)
    valid &= _s_below_l(sig_arr[:, 32:])
    return sig_arr, valid


def _prepare_rsh_compact(pk_arr: np.ndarray, msgs, sigs) -> Tuple[np.ndarray, np.ndarray]:
    """Per-chunk staging for the key-store routes (reference :959):
    (rsh u8[96,B] rows 0:32 R, 32:64 S, 64:96 h, valid); pk_arr holds
    each lane's key for the hash."""
    sig_arr, valid = _parse_lane_sigs(msgs, sigs)
    h_arr = _challenge_scalars(pk_arr, sig_arr, msgs, valid)
    return pack_compact_rows(sig_arr[:, :32], sig_arr[:, 32:], h_arr), valid


def hash_mode() -> str:
    """CBFT_TPU_HASH: ``host`` or ``device`` pin where h is computed;
    ``auto`` (the default) leaves it to ``hash_route``."""
    mode = os.environ.get("CBFT_TPU_HASH", "auto")
    if mode not in ("host", "device", "auto"):
        raise ValueError(
            f"unknown CBFT_TPU_HASH={mode!r}; choose from ['auto', 'device', 'host']"
        )
    return mode


def hash_route(n: int) -> str:
    """Where h = SHA-512(R ‖ A ‖ M) mod L runs for an n-lane batch: the
    pin when set, else ``host``. The reference picks the device above a
    crossover measured at warm-up and the host while it is unmeasured;
    the port has no calibration yet (ROADMAP, "Calibration, warm-up,
    memory and the wire ledger"), so ``auto`` is the host. Either way the
    verification runs on the card."""
    mode = hash_mode()
    return "host" if mode == "auto" else mode


def wire_format() -> str:
    """CBFT_TPU_WIRE: ``compact`` (the default: raw byte rows) or ``words``
    (the u32 word wire)."""
    fmt = os.environ.get("CBFT_TPU_WIRE", "compact")
    if fmt not in ("compact", "words"):
        raise ValueError(f"unknown CBFT_TPU_WIRE={fmt!r}; choose from ['compact', 'words']")
    return fmt


# --- point layer (reference :119-213), extended coordinates, a = -1 --------

Point = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def point_dbl(p: Point) -> Point:
    """dbl-2008-hwcd; valid for every input, identity included."""
    x1, y1, z1, _ = p
    a = fe.sq(x1)
    b = fe.sq(y1)
    zz = fe.sq(z1)
    c = fe.add(zz, zz)
    d = fe.neg(a)
    e = fe.sub(fe.sub(fe.sq(fe.add(x1, y1)), a), b)
    g = fe.add(d, b)
    f = fe.sub(g, c)
    h = fe.sub(d, b)
    return (fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def cache_point(q: Point) -> Point:
    """(Y+X, Y−X, 2d·T, 2Z), ref10's cached form."""
    x2, y2, z2, t2 = q
    d2 = fe.const(fe.D2, x2.device)
    return (fe.add(y2, x2), fe.sub(y2, x2), fe.mul(t2, d2), fe.add(z2, z2))


def add_cached(p: Point, qc: Point) -> Point:
    """add-2008-hwcd-3 with q in cached form; complete on this curve."""
    x1, y1, z1, t1 = p
    yp, ym, t2d, z2 = qc
    a = fe.mul(fe.sub(y1, x1), ym)
    b = fe.mul(fe.add(y1, x1), yp)
    c = fe.mul(t1, t2d)
    d = fe.mul(z1, z2)
    e = fe.sub(b, a)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(b, a)
    return (fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def point_add(p: Point, q: Point) -> Point:
    return add_cached(p, cache_point(q))


def decompress(y: torch.Tensor, sign: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """y fe[10,B] (low 255 bits), sign int64[B] → (x, ok), ref10 semantics:
    y is taken mod p, the root x = (u/v)^((p+3)/8) is checked by
    v·x² ∈ {u, −u}, parity follows the sign bit (negating 0 keeps 0)."""
    dev = y.device
    one = fe.const(1, dev)
    yy = fe.sq(y)
    u = fe.sub(yy, one)
    v = fe.add(fe.mul(yy, fe.const(fe.D, dev)), one)
    v3 = fe.mul(fe.sq(v), v)
    v7 = fe.mul(fe.sq(v3), v)
    t = fe.pow_p58(fe.mul(u, v7))
    x = fe.mul(fe.mul(u, v3), t)
    vxx = fe.mul(v, fe.sq(x))
    ok_direct = fe.eq(vxx, u)
    ok_flip = fe.eq(vxx, fe.neg(u))
    x = fe.select(ok_flip, fe.mul(x, fe.const(fe.SQRT_M1, dev)), x)
    flip = (fe.to_canonical(x)[0] & 1) != sign
    x = fe.select(flip, fe.neg(x), x)
    return x, ok_direct | ok_flip


# --- wire unpacking ---------------------------------------------------------


def _words(rows: torch.Tensor) -> torch.Tensor:
    """u8[4k,B] little-endian bytes → int64[k,B] u32 words."""
    r = rows.to(torch.int64)
    return r[0::4] | (r[1::4] << 8) | (r[2::4] << 16) | (r[3::4] << 24)


def unpack_fe(words: torch.Tensor) -> torch.Tensor:
    """int64[8,B] u32 words → fe[10,B] limbs of the low 255 bits."""
    limbs = []
    for i in range(fe.NUM_LIMBS):
        off, w = fe.OFFSETS[i], fe.WIDTHS[i]
        j, k = off // 32, off % 32
        v = words[j] >> k
        if k + w > 32:
            v = v | (words[j + 1] << (32 - k))
        limbs.append(v & ((1 << w) - 1))
    return torch.stack(limbs, dim=0)


def encode(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Canonical affine (x, y) → int64[8,B] u32 words of the 32-byte
    encoding: y's 255 bits, x's parity at bit 255."""
    yc = fe.to_canonical(y)
    words = []
    for j in range(8):
        w = torch.zeros_like(yc[0])
        for i in range(fe.NUM_LIMBS):
            off, width = fe.OFFSETS[i], fe.WIDTHS[i]
            lo, hi = max(off, 32 * j), min(off + width, 32 * j + 32)
            if lo >= hi:
                continue
            part = (yc[i] >> (lo - off)) & ((1 << (hi - lo)) - 1)
            w = w | (part << (lo - 32 * j))
        words.append(w)
    words[7] = words[7] | ((fe.to_canonical(x)[0] & 1) << 31)
    return torch.stack(words, dim=0)


# --- the verifier -----------------------------------------------------------


def _base_points(device) -> List[Point]:
    """Identity, B, 2B and 3B as extended points with Z = 1."""
    from cometbft_tpu_torch.crypto import purepy

    pts = [purepy.IDENT, purepy.B]
    pts.append(purepy.pt_dbl(purepy.B))
    pts.append(purepy.pt_add(pts[2], purepy.B))
    out = []
    for x, y, z, _ in pts:
        zinv = pow(z, P - 2, P)
        ax, ay = x * zinv % P, y * zinv % P
        out.append(tuple(fe.const(v, device) for v in (ax, ay, 1, ax * ay % P)))
    return out




def joint_straus(neg_a: Point, s_w: torch.Tensor, h_w: torch.Tensor) -> Point:
    """[s]B + [h](−A) from −A and the int64[8,B] little-endian u32 words
    of s and h: the 16-entry table ds·B + dh·(−A) in cached form, then 127
    radix-4 steps of two doublings and one addition, digits most
    significant first. Ed25519 and sr25519 verify through it."""
    dev = neg_a[0].device
    batch = neg_a[0].shape[1]
    # entry[ds + 4·dh] = ds·B + dh·(−A), cached
    a2 = point_dbl(neg_a)
    a3 = point_add(a2, neg_a)
    s_pts = [
        tuple(c.expand(fe.NUM_LIMBS, batch) for c in pt) for pt in _base_points(dev)
    ]
    h_pts = [None, neg_a, a2, a3]
    entries = []
    for dh in range(4):
        for ds in range(4):
            if dh == 0:
                pt = s_pts[ds]
            elif ds == 0:
                pt = h_pts[dh]
            else:
                pt = point_add(s_pts[ds], h_pts[dh])
            entries.append(torch.stack(cache_point(pt), dim=0))  # [4,10,B]
    table = torch.stack(entries, dim=0)  # [16,4,10,B]

    s_dig = digits_msb_first(s_w)
    h_dig = digits_msb_first(h_w)
    lanes = torch.arange(batch, device=dev)
    acc: Point = s_pts[0]
    for i in range(NUM_DIGITS):
        acc = point_dbl(point_dbl(acc))
        idx = s_dig[i] + 4 * h_dig[i]
        sel = table[idx, :, :, lanes]  # [B,4,10]
        acc = add_cached(acc, tuple(sel[:, k].T for k in range(4)))
    return acc


def _verify_words(a_w, r_w, s_w, h_w) -> torch.Tensor:
    """bool[B]: encode([s]B + [h](−A)) == R and A decompresses, from
    int64[8,B] little-endian u32 words of A, R, s and h. The torch twin
    of ``verify_core`` in csrc/ed25519_verify.cu."""
    batch = a_w.shape[1]
    ay = unpack_fe(a_w)
    a_sign = (a_w[7] >> 31) & 1
    x, ok = decompress(ay, a_sign)
    nx = fe.neg(x)
    one = fe.const(1, a_w.device).expand(fe.NUM_LIMBS, batch)
    neg_a: Point = (nx, ay, one, fe.mul(nx, ay))
    rx, ry, rz, _ = joint_straus(neg_a, s_w, h_w)
    zinv = fe.invert(rz)
    enc = encode(fe.mul(rx, zinv), fe.mul(ry, zinv))
    return (enc == r_w).all(dim=0) & ok


def verify_compact_plain(wire: torch.Tensor) -> torch.Tensor:
    """bool[B] from the compact wire u8[128,B] (rows A, R, S, h). The
    torch twin of ``ed25519_verify_compact``."""
    words = _words(wire)  # int64[32,B]
    return _verify_words(words[0:8], words[8:16], words[16:24], words[24:32])


# --- the resident route: comb tables of each key, built once ----------------

COMB_SLICES = 4  # slice t holds columns 16t..16t+15
COMB_TEETH = 4  # column c of a scalar: its bits 64i + c, i = 0..3
COMB_COLUMNS = 16
SLICE_ENTRIES = 1 << COMB_TEETH
GROUP_THREADS_PER_SM = 256  # the resident kernel's budget for build.group_size
CORE_GROUP_THREADS_PER_SM = 256  # the wire-key core's (ed25519_verify.cu's four kernels), G 4 or 1
ENTRY_WORDS = 32  # Y+X, Y−X, 2d·X·Y as ten limbs each, two words of padding
FLAG_ROW = COMB_SLICES * SLICE_ENTRIES  # row 64: word 0 is the key's flag
TABLE_ROWS = FLAG_ROW + 1
KEY_TABLE_BYTES = TABLE_ROWS * ENTRY_WORDS * 4  # 8,320 a key

Niels = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def add_niels(p: Point, q: Niels) -> Point:
    """p + q with q in affine Niels form (y+x, y−x, 2d·x·y): ref10's
    ge_madd, add-2008-hwcd-3 with Z2 = 1; complete on this curve."""
    x1, y1, z1, t1 = p
    yp, ym, t2d = q
    a = fe.mul(fe.sub(y1, x1), ym)
    b = fe.mul(fe.add(y1, x1), yp)
    c = fe.mul(t1, t2d)
    d = fe.add(z1, z1)
    e = fe.sub(b, a)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(b, a)
    return (fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def _identity(batch: int, device) -> Point:
    zero = torch.zeros((fe.NUM_LIMBS, batch), dtype=torch.int64, device=device)
    one = fe.const(1, device).expand(fe.NUM_LIMBS, batch)
    return (zero, one, one, zero)


def key_tables_plain(keys: torch.Tensor) -> torch.Tensor:
    """Comb tables of −A for each key row u8[n,32] → int32[n, 65, 32].

    Row 16t + j holds Σ_i j_i·2^(64i + 16t)·(−A) (j_i bit i of j) as
    canonical limbs of y+x, y−x and 2d·x·y (words 0:10, 10:20, 20:30);
    row 64 word 0 is 1 when A decompresses (reference semantics: y taken
    mod p, −0 decodes as 0) and 0 otherwise, and then every entry holds
    the identity. The torch twin of ``ed25519_key_tables``."""
    dev = keys.device
    n = keys.shape[0]
    out = torch.zeros((n, TABLE_ROWS, ENTRY_WORDS), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    words = _words(keys.T)
    y = unpack_fe(words)
    x, ok = decompress(y, (words[7] >> 31) & 1)
    nx = fe.neg(x)
    p: Point = (nx, y, fe.const(1, dev).expand(fe.NUM_LIMBS, n), fe.mul(nx, y))
    bases = [p]  # 2^(16k)·(−A), k = 0..15
    for _ in range(1, 16):
        for _ in range(16):
            p = point_dbl(p)
        bases.append(p)
    entries: List[Point] = []
    for t in range(COMB_SLICES):
        row = [_identity(n, dev)]
        for j in range(1, SLICE_ENTRIES):
            low = (j & -j).bit_length() - 1
            b = bases[4 * low + t]
            row.append(b if j == 1 << low else point_add(row[j & (j - 1)], b))
        entries += row
    cat = [torch.cat([e[k] for e in entries], dim=1) for k in range(3)]  # [10, 64·n]
    zi = fe.invert(cat[2])
    ax, ay = fe.mul(cat[0], zi), fe.mul(cat[1], zi)
    niels = [fe.add(ay, ax), fe.sub(ay, ax), fe.mul(fe.mul(ax, ay), fe.const(fe.D2, dev))]
    ident = [fe.const(1, dev), fe.const(1, dev), fe.const(0, dev)]
    good = ok.repeat(FLAG_ROW)
    for k, v in enumerate(niels):
        v = fe.to_canonical(fe.select(good, v, ident[k].expand_as(v)))
        out[:, :FLAG_ROW, 10 * k:10 * k + 10] = v.reshape(fe.NUM_LIMBS, FLAG_ROW, n).permute(2, 1, 0).to(torch.int32)
    out[:, FLAG_ROW, 0] = ok.to(torch.int32)
    return out


def neg_base_encoding() -> bytes:
    """The encoding of −B (B's x is even, so −B's sign bit is set): its
    key tables are those of B."""
    from cometbft_tpu_torch.crypto import purepy

    return (purepy.BY | (1 << 255)).to_bytes(32, "little")


_BASE_TABLES = {}


def base_tables(device) -> torch.Tensor:
    """int32[1, 65, 32]: the comb tables of B on ``device``, built once a
    device by ``key_tables_kernel`` from −B's encoding (its plain version
    on the CPU)."""
    key = str(torch.device(device))
    tab = _BASE_TABLES.get(key)
    if tab is None:
        rows = torch.frombuffer(bytearray(neg_base_encoding()), dtype=torch.uint8).view(1, 32).to(device)
        tab = _BASE_TABLES[key] = _published(key_tables_kernel(rows))
    return tab


def _published(tables: torch.Tensor) -> torch.Tensor:
    """``tables`` once their build has finished on the stream that built
    them: tables are shared (the key store's entries, B's tables) and read
    from other threads, whose streams do not wait for this one (a
    supervisor dispatch runs on its fault domain's stream,
    topology.device_scope)."""
    if tables.is_cuda:
        torch.cuda.current_stream(tables.device).synchronize()
    return tables


def comb_digits(words: torch.Tensor) -> torch.Tensor:
    """int64[8,B] little-endian u32 words of a scalar → int64[4, 16, B]
    comb digits: digit [t, c] = Σ_i bit(64i + 16t + c)·2^i."""
    shifts = torch.arange(32, device=words.device)
    bits = ((words[:, None, :] >> shifts[None, :, None]) & 1).reshape(4, COMB_SLICES, COMB_COLUMNS, -1)
    weights = (1 << torch.arange(COMB_TEETH, device=words.device)).view(COMB_TEETH, 1, 1, 1)
    return (bits * weights).sum(dim=0)


def _niels_at(tables: torch.Tensor, rows: torch.Tensor, entries: torch.Tensor) -> Niels:
    """Entry entries[b] of table rows[b] (tables int32[N, 65, 32]) → Niels
    [10, B]."""
    e = tables[rows, entries].to(torch.int64)  # [B, 32]
    return (e[:, 0:10].T, e[:, 10:20].T, e[:, 20:30].T)


def _decompress_r(r_w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """R's u32 words int64[8,B] → (x, y, ok): canonical affine limbs, ok
    when R is an encoding that a point's encode() can give: y (the low 255
    bits) below p, a root exists, and not x = 0 with the sign bit set."""
    y = unpack_fe(r_w)
    sign = (r_w[7] >> 31) & 1
    yc = fe.to_canonical(y)
    x, ok = decompress(yc, sign)
    xc = fe.to_canonical(x)
    ok = ok & (yc == y).all(dim=0) & ~((xc == 0).all(dim=0) & (sign == 1))
    return xc, yc, ok


def verify_resident_plain(key_tables: torch.Tensor, idx: Optional[torch.Tensor], rsh: torch.Tensor) -> torch.Tensor:
    """bool[B] against resident keys: key_tables int32[N,65,32] (see
    ``key_tables_plain``), idx int32[B] or None (lane order), rsh
    u8[96,B] rows R, S, h. The torch twin of ``ed25519_verify_resident``:
    [s]B + [h](−A) by the 16-column comb over B's and the lane's tables,
    compared with R in projective form. An index out of range, or a key
    whose flag is 0, rejects."""
    dev = rsh.device
    batch = rsh.shape[1]
    n = key_tables.shape[0]
    rows = torch.arange(batch, device=dev) if idx is None else idx.to(torch.int64)
    have = (rows >= 0) & (rows < n)
    tables = torch.cat([key_tables, base_tables(dev)])  # row n: B's, for lanes without a key
    rows = torch.where(have, rows, n)
    base = torch.full_like(rows, n)
    flag = tables[rows, FLAG_ROW, 0] != 0
    w = _words(rsh)  # int64[24,B]
    ds, dh = comb_digits(w[8:16]), comb_digits(w[16:24])
    acc = _identity(batch, dev)
    for c in range(COMB_COLUMNS - 1, -1, -1):
        if c < COMB_COLUMNS - 1:
            acc = point_dbl(acc)
        for t in range(COMB_SLICES):
            acc = add_niels(acc, _niels_at(tables, base, SLICE_ENTRIES * t + ds[t, c]))
            acc = add_niels(acc, _niels_at(tables, rows, SLICE_ENTRIES * t + dh[t, c]))
    x, y, z, _ = acc
    rx, ry, r_ok = _decompress_r(w[0:8])
    match = fe.eq(x, fe.mul(rx, z)) & fe.eq(y, fe.mul(ry, z))
    return have & flag & r_ok & match


def _challenge_words(r_rows: torch.Tensor, a_rows: torch.Tensor, msg: torch.Tensor, mlen: torch.Tensor) -> torch.Tensor:
    """h = SHA-512(R ‖ A ‖ M) mod L as int64[8,B] u32 words, from R and A
    u8[32,B] and the staged message plane."""
    max_blocks = (64 + msg.shape[0]) // 128
    blocks, n_live = sha512.blocks_from_bytes(torch.cat([r_rows, a_rows], dim=0), msg, mlen, max_blocks)
    digest = sha512.digest_bytes(sha512.sha512_blocks_plain(blocks, n_live))
    return scalar.to_words(scalar.sc_reduce(scalar.digest_to_limbs(digest)))


def verify_full_compact_plain(wire: torch.Tensor, msg: torch.Tensor, mlen: torch.Tensor) -> torch.Tensor:
    """bool[B] from wire u8[96,B] (rows A, R, S), the message plane
    u8[MP,B] and mlen int32[B], h computed from them. The torch twin of
    ``ed25519_verify_full_compact``."""
    w = _words(wire)
    h_w = _challenge_words(wire[32:64], wire[0:32], msg, mlen)
    return _verify_words(w[0:8], w[8:16], w[16:24], h_w)


def _u32(words: torch.Tensor) -> torch.Tensor:
    """uint32 words (or int32 holding their bits) → int64 values."""
    return words.to(torch.int64) & 0xFFFFFFFF


def verify_words_plain(wire: torch.Tensor) -> torch.Tensor:
    """bool[B] from the word wire u32[32,B] (rows A, R, S, h). The torch
    twin of ``ed25519_verify_words``."""
    w = _u32(wire)
    return _verify_words(w[0:8], w[8:16], w[16:24], w[24:32])


def verify_full_words_plain(
    wire: torch.Tensor, msg_hi: torch.Tensor, msg_lo: torch.Tensor, nblocks: torch.Tensor
) -> torch.Tensor:
    """bool[B] from the word wire u32[24,B] (rows A, R, S) and R ‖ A ‖ M's
    padded SHA-512 blocks (hi and lo halves u32[n_blocks,16,B], live
    counts int32[B]), h computed from them. The torch twin of
    ``ed25519_verify_full_words``."""
    w = _u32(wire)
    blocks = (_u32(msg_hi) << 32) | _u32(msg_lo)
    digest = sha512.digest_bytes(sha512.sha512_blocks_plain(blocks, nblocks.to(torch.int64)))
    h_w = scalar.to_words(scalar.sc_reduce(scalar.digest_to_limbs(digest)))
    return _verify_words(w[0:8], w[8:16], w[16:24], h_w)


# --- the kernels' wrappers ----------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # wire, B's comb tables, out, B, group, stream
    "cbt_ed25519_verify_compact": [_P, _P, _P, _I, _I, _P],
    # wire, msg, MP, mlen, B's comb tables, out, B, group, stream
    "cbt_ed25519_verify_full_compact": [_P, _P, _I, _P, _P, _P, _I, _I, _P],
    # words, B's comb tables, out, B, group, stream
    "cbt_ed25519_verify_words": [_P, _P, _P, _I, _I, _P],
    # words, msg_hi, msg_lo, n_blocks, nblocks, B's comb tables, out, B, group, stream
    "cbt_ed25519_verify_full_words": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _P],
}


_RESIDENT_SIGNATURES = {
    # keys, n, out, stream
    "cbt_ed25519_key_tables": [_P, _I, _P, _P],
    # key tables, N, idx, rsh, base tables, out, B, group, stream
    "cbt_ed25519_verify_resident": [_P, _I, _P, _P, _P, _P, _I, _I, _P],
}


def _lib():
    return build.load("ed25519_verify", _SIGNATURES)


def core_group(batch: int, device) -> int:
    """Threads a lane for a launch of the wire-key core: 4 at a commit and
    at a window chunk of 8,192, 1 at 16,384 (``CORE_GROUP_THREADS_PER_SM``)."""
    return build.group_size(batch, device, CORE_GROUP_THREADS_PER_SM, groups=(4,))


def core_base(group: int, device) -> Optional[int]:
    """B's comb tables for a launch of a wire-key core: the threads beside
    the groups compute [s]B from them at G = 4 (and 2); G = 1 reads none."""
    return base_tables(device).data_ptr() if group > 1 else None


def _resident_lib():
    return build.load("ed25519_resident", _RESIDENT_SIGNATURES)


def _require_rows(t: torch.Tensor, what: str, rows: int, batch: int, device) -> None:
    build.require_cuda_tensor(t, what, torch.uint8, 2)
    if t.shape[0] != rows or t.shape[1] != batch:
        raise ValueError(f"{what}: expected [{rows}, {batch}], got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, the batch is on {device}")


def _require_table(table: torch.Tensor, idx: Optional[torch.Tensor], batch: int, device) -> None:
    build.require_cuda_tensor(table, "key tables", torch.int32, 3)
    if tuple(table.shape[1:]) != (TABLE_ROWS, ENTRY_WORDS) or table.device != device:
        raise ValueError(
            f"key tables: expected [N, {TABLE_ROWS}, {ENTRY_WORDS}] on {device}, got {tuple(table.shape)} on {table.device}"
        )
    if idx is not None:
        build.require_cuda_tensor(idx, "key index", torch.int32, 1)
        if idx.shape[0] != batch or idx.device != device:
            raise ValueError(f"key index: expected [{batch}] on {device}, got {tuple(idx.shape)} on {idx.device}")


def _require_msg(msg: torch.Tensor, mlen: torch.Tensor, batch: int, device) -> None:
    build.require_cuda_tensor(msg, "message plane", torch.uint8, 2)
    if msg.shape[1] != batch or (64 + msg.shape[0]) % 128 or msg.device != device:
        raise ValueError(
            f"message plane: expected [128k - 64, {batch}] on {device}, got {tuple(msg.shape)} on {msg.device}"
        )
    build.require_cuda_tensor(mlen, "message lengths", torch.int32, 1)
    if mlen.shape[0] != batch or mlen.device != device:
        raise ValueError(f"message lengths: expected [{batch}] on {device}, got {tuple(mlen.shape)}")


def _require_shape(t: torch.Tensor, what: str, dtype, shape: Tuple[int, ...], device) -> None:
    build.require_cuda_tensor(t, what, dtype, len(shape))
    if tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{what}: expected {list(shape)} on {device}, got {tuple(t.shape)} on {t.device}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def verify_kernel_compact(wire: torch.Tensor) -> torch.Tensor:
    """bool[B] from the compact wire u8[128,B].

    On a CUDA tensor this launches ``ed25519_verify_compact`` (``core_group``
    threads a lane) on the current stream, or raises; a CPU tensor runs
    ``verify_compact_plain``."""
    global LAUNCHES
    if wire.device.type == "cpu":
        return verify_compact_plain(wire)
    build.require_cuda_tensor(wire, "ed25519 wire", torch.uint8, 2)
    if wire.shape[0] != WIRE_ROWS:
        raise ValueError(f"ed25519 wire: expected {WIRE_ROWS} rows, got {wire.shape[0]}")
    batch = wire.shape[1]
    out = torch.empty(batch, dtype=torch.uint8, device=wire.device)
    if batch == 0:
        return out.bool()
    group = core_group(batch, wire.device)
    rc = _lib().cbt_ed25519_verify_compact(
        wire.data_ptr(), core_base(group, wire.device), out.data_ptr(), batch, group, build.stream_ptr(wire.device)
    )
    build.check(rc, "ed25519_verify_compact")
    LAUNCHES += 1
    return out.bool()


def key_tables_kernel(keys: torch.Tensor) -> torch.Tensor:
    """Comb tables int32[n, 65, 32] of each key row u8[n, 32] (see
    ``key_tables_plain``). On a CUDA tensor this launches
    ``ed25519_key_tables`` (a block of eight keys: one doubling chain a key
    over four threads, eight threads a key building its entries), or
    raises; a CPU tensor runs ``key_tables_plain``."""
    global TABLE_LAUNCHES
    if keys.device.type == "cpu":
        return key_tables_plain(keys)
    build.require_cuda_tensor(keys, "key rows", torch.uint8, 2)
    if keys.shape[1] != 32:
        raise ValueError(f"key rows: expected [n, 32], got {tuple(keys.shape)}")
    n = keys.shape[0]
    out = torch.empty((n, TABLE_ROWS, ENTRY_WORDS), dtype=torch.int32, device=keys.device)
    if n == 0:
        return out
    rc = _resident_lib().cbt_ed25519_key_tables(keys.data_ptr(), n, out.data_ptr(), build.stream_ptr(keys.device))
    build.check(rc, "ed25519_key_tables")
    TABLE_LAUNCHES += 1
    return out


def verify_kernel_resident(key_tables: torch.Tensor, idx: Optional[torch.Tensor], rsh: torch.Tensor) -> torch.Tensor:
    """bool[B] against resident keys (key_tables int32[N,65,32] from
    ``key_tables_kernel``; idx int32[B], or None for lane order; rsh
    u8[96,B]). On CUDA tensors this launches ``ed25519_verify_resident``
    with ``build.group_size`` threads a lane, or raises; CPU tensors run
    ``verify_resident_plain``."""
    global RESIDENT_LAUNCHES
    if rsh.device.type == "cpu":
        return verify_resident_plain(key_tables, idx, rsh)
    batch = rsh.shape[1]
    _require_rows(rsh, "R‖S‖h rows", 96, batch, rsh.device)
    _require_table(key_tables, idx, batch, rsh.device)
    out = torch.empty(batch, dtype=torch.uint8, device=rsh.device)
    if batch == 0:
        return out.bool()
    base = base_tables(rsh.device)
    rc = _resident_lib().cbt_ed25519_verify_resident(
        key_tables.data_ptr(), key_tables.shape[0], _ptr(idx), rsh.data_ptr(), base.data_ptr(), out.data_ptr(),
        batch, build.group_size(batch, rsh.device, GROUP_THREADS_PER_SM), build.stream_ptr(rsh.device),
    )
    build.check(rc, "ed25519_verify_resident")
    RESIDENT_LAUNCHES += 1
    return out.bool()


def verify_kernel_full_compact(wire: torch.Tensor, msg: torch.Tensor, mlen: torch.Tensor) -> torch.Tensor:
    """bool[B] with h computed on the card (wire u8[96,B], msg u8[MP,B],
    mlen int32[B]). On CUDA tensors this launches
    ``ed25519_verify_full_compact`` (``core_group`` threads a lane), or
    raises; CPU tensors run
    ``verify_full_compact_plain``."""
    global FULL_LAUNCHES
    if wire.device.type == "cpu":
        return verify_full_compact_plain(wire, msg, mlen)
    batch = wire.shape[1]
    _require_rows(wire, "A‖R‖S rows", 96, batch, wire.device)
    _require_msg(msg, mlen, batch, wire.device)
    out = torch.empty(batch, dtype=torch.uint8, device=wire.device)
    if batch == 0:
        return out.bool()
    group = core_group(batch, wire.device)
    rc = _lib().cbt_ed25519_verify_full_compact(
        wire.data_ptr(), msg.data_ptr(), msg.shape[0], mlen.data_ptr(), core_base(group, wire.device),
        out.data_ptr(), batch, group, build.stream_ptr(wire.device),
    )
    build.check(rc, "ed25519_verify_full_compact")
    FULL_LAUNCHES += 1
    return out.bool()


def verify_kernel_words(wire: torch.Tensor) -> torch.Tensor:
    """bool[B] from the word wire u32[32,B].

    On a CUDA tensor this launches ``ed25519_verify_words`` (``core_group``
    threads a lane) on the current stream, or raises; a CPU tensor runs
    ``verify_words_plain``."""
    global WORDS_LAUNCHES
    if wire.device.type == "cpu":
        return verify_words_plain(wire)
    batch = wire.shape[1] if wire.dim() == 2 else -1
    _require_shape(wire, "ed25519 word wire", torch.uint32, (32, batch), wire.device)
    out = torch.empty(batch, dtype=torch.uint8, device=wire.device)
    if batch == 0:
        return out.bool()
    group = core_group(batch, wire.device)
    rc = _lib().cbt_ed25519_verify_words(
        wire.data_ptr(), core_base(group, wire.device), out.data_ptr(), batch, group, build.stream_ptr(wire.device)
    )
    build.check(rc, "ed25519_verify_words")
    WORDS_LAUNCHES += 1
    return out.bool()


def verify_kernel_full_words(
    wire: torch.Tensor, msg_hi: torch.Tensor, msg_lo: torch.Tensor, nblocks: torch.Tensor
) -> torch.Tensor:
    """bool[B] with h computed on the card from pre-padded blocks (wire
    u32[24,B], msg_hi and msg_lo u32[n_blocks,16,B], nblocks int32[B]).
    On CUDA tensors this launches
    ``ed25519_verify_full_words`` (``core_group`` threads a lane), or
    raises; CPU tensors run
    ``verify_full_words_plain``."""
    global FULL_WORDS_LAUNCHES
    if wire.device.type == "cpu":
        return verify_full_words_plain(wire, msg_hi, msg_lo, nblocks)
    batch = wire.shape[1] if wire.dim() == 2 else -1
    _require_shape(wire, "A‖R‖S words", torch.uint32, (24, batch), wire.device)
    n_blocks = msg_hi.shape[0] if msg_hi.dim() == 3 else -1
    _require_shape(msg_hi, "message blocks (hi)", torch.uint32, (n_blocks, 16, batch), wire.device)
    _require_shape(msg_lo, "message blocks (lo)", torch.uint32, (n_blocks, 16, batch), wire.device)
    _require_shape(nblocks, "live block counts", torch.int32, (batch,), wire.device)
    out = torch.empty(batch, dtype=torch.uint8, device=wire.device)
    if batch == 0:
        return out.bool()
    group = core_group(batch, wire.device)
    rc = _lib().cbt_ed25519_verify_full_words(
        wire.data_ptr(), msg_hi.data_ptr(), msg_lo.data_ptr(), n_blocks, nblocks.data_ptr(),
        core_base(group, wire.device), out.data_ptr(), batch, group, build.stream_ptr(wire.device),
    )
    build.check(rc, "ed25519_verify_full_words")
    FULL_WORDS_LAUNCHES += 1
    return out.bool()


# --- entry points -----------------------------------------------------------


def verify_batch(
    pub_keys: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    device="cuda",
) -> List[bool]:
    """Per-signature verdicts on ``device``, the keys shipped with each
    lane (reference :731): ``wire_format`` picks the compact or the word
    wire and ``hash_route`` where h is computed, one of four kernels as
    the reference's :747-758 does, and ``mesh.dispatch_batch`` runs the
    batch in chunks, packing chunk i+1 while the card verifies chunk i.
    The result is ANDed with the packing's validity mask."""
    n = len(pub_keys)
    if n == 0:
        return []
    compact = wire_format() == "compact"
    if hash_route(n) == "device":
        prepare = prepare_batch_device_hash_compact if compact else prepare_batch_device_hash
        kernel = verify_kernel_full_compact if compact else verify_kernel_full_words
    else:
        prepare = prepare_batch_compact if compact else prepare_batch
        kernel = verify_kernel_compact if compact else verify_kernel_words
    valid_full = np.ones(n, bool)

    def chunk(start: int, end: int):
        *packed, valid = prepare(pub_keys[start:end], msgs[start:end], sigs[start:end])
        valid_full[start:end] = valid
        return packed

    out = mesh.dispatch_batch(kernel, chunk, n, MAX_CHUNK, device)
    return [bool(v) for v in out & valid_full]


def verify_keyed(
    key_tables: torch.Tensor,
    idx: Optional[np.ndarray],
    pk_arr: np.ndarray,
    msgs: Sequence[Optional[bytes]],
    sigs: Sequence[Optional[bytes]],
    device,
) -> np.ndarray:
    """bool[n] against keys resident on ``device`` as comb tables
    (``key_tables_kernel``): lane i reads row idx[i], or row i when idx
    is None (the resident commit).
    pk_arr u8[n,32] holds the same keys on the host, where h is computed
    (reference :959, whatever ``CBFT_TPU_HASH`` says). Chunked through
    ``mesh.dispatch_batch``."""
    n = len(msgs)
    valid_full = np.ones(n, bool)

    def chunk(start: int, end: int):
        lead = [key_tables[start:end], None] if idx is None else [key_tables, idx[start:end]]
        rsh, valid = _prepare_rsh_compact(pk_arr[start:end], msgs[start:end], sigs[start:end])
        valid_full[start:end] = valid
        return lead + [rsh]

    return mesh.dispatch_batch(verify_kernel_resident, chunk, n, MAX_CHUNK, device) & valid_full


def _build_resident(pub_keys: Sequence[bytes], device) -> keystore.KeyStoreEntry:
    """A key-store entry for a validator set: its keys as u8[n,32] rows
    copied to ``device`` once (reference :867), and their comb tables
    built there once by ``key_tables_kernel``, finished before the entry
    is published to other threads (``_published``)."""
    pk_arr, _ = keystore.key_rows(pub_keys)
    table = torch.from_numpy(pk_arr).to(device)
    return keystore.new_entry(pub_keys, table, device, _published(key_tables_kernel(table)))


def verify_valset_resident(
    valset_id: bytes,
    pub_keys: Sequence[bytes],
    msgs: Sequence[Optional[bytes]],
    sigs: Sequence[Optional[bytes]],
    device="cuda",
) -> List[bool]:
    """Full-lane commit verification against a resident validator set
    (reference :980). pub_keys: every key of the set, in set order;
    msgs/sigs: one entry per validator, None for an absent lane (False
    in the result). valset_id must be a collision-resistant digest of the
    ordered keys; the resident rows are trusted to match it. A malformed
    key rejects its lane."""
    n = len(pub_keys)
    if n == 0:
        return []
    if len(msgs) != n or len(sigs) != n:
        raise ValueError("msgs/sigs must have one entry per validator")
    store = keystore.default_store()
    entry = store.get(valset_id, pub_keys, lambda pks: _build_resident(pks, device), device)
    out = verify_keyed(entry.key_tables, None, entry.pk_arr, msgs, sigs, device)
    return [bool(v) for v in out & entry.pk_ok]
