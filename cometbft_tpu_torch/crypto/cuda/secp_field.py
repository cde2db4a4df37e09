"""GF(p), p = 2^256 - 2^32 - 977, as plain torch tensors — the CPU twin of
``csrc/fe256k1.cuh``.

Reference: cometbft_tpu/crypto/tpu/secp_field.py. The reference keeps an
element as int32[19, B] radix-2^14 limbs because the TPU's vector lanes
have no 32x32->64 multiply (``mul`` :174 scatters the outer product into
38 columns and folds twice, ``_fold_v`` :145). Hopper has one, so the
port uses ten 26-bit limbs, limb i at bit 26 i: uint32 in registers on
the card, int64 here, with 64-bit column sums. Both sides run the same
limb arithmetic step for step. A field element here is an int64 tensor of
shape [10, *batch], limb axis first.

Reduction rests on 2^256 ≡ 2^32 + 977 = 0x1000003D1 (mod p), so
2^260 ≡ 0x1000003D10 = 0x400·2^26 + 0x3D10: a carry out of limb 9
(weight 2^260) folds back as 0x3D10 into limb 0 and 0x400 into limb 1.

Invariant ("carried form"): every limb is non-negative and below 2^26,
except limb 1, which may exceed 2^26 by less than 2^15. Every operation
takes and returns carried form:

* ``_carry`` is one floor-carry pass with the fold, then one more carry
  out of limb 0; after ``add``, ``sub`` or ``mul_small`` (x21)
  a limb is below 2^32, so the card does it in uint32;
* ``sub`` adds 32p limb-wise (each limb of 32p is at least 2^26 + 2^15,
  so nothing goes negative) before subtracting;
* ``mul`` sums the 100 limb products into 19 columns, each below
  10 · (2^26 + 2^15)^2 < 2^56; carries them into 20 digits of 26 bits;
  folds digits 10..19 down (x0x3D10 into their limb, x0x400 into the next);
  and runs two carry passes (the first leaves limb 1 below 2^47).

Only ``to_canonical`` gives the unique representative in [0, p). The
arithmetic is exact: the tests hold every operation against Python ints
with equality, from the largest carried inputs.
"""

from __future__ import annotations

from typing import List

import torch

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
B3 = 21  # 3·b for the complete formulas (b = 7)

NUM_LIMBS = 10
BITS = 26
MASK = (1 << BITS) - 1
FOLD_LO = 0x3D10  # 2^260 mod p = FOLD_HI · 2^26 + FOLD_LO
FOLD_HI = 0x400
TOP_BITS = 22  # limb 9 of a canonical value: bits 234..255
P_LIMBS = [(P >> (BITS * i)) & MASK for i in range(NUM_LIMBS)]
_SUB = torch.tensor([32 * v for v in P_LIMBS], dtype=torch.int64)  # 32p, limb by limb

_COLUMNS = torch.tensor(
    [i + j for i in range(NUM_LIMBS) for j in range(NUM_LIMBS)], dtype=torch.int64
)


def int_to_limbs(n: int) -> List[int]:
    """Canonical limbs of n mod p."""
    n %= P
    return [(n >> (BITS * i)) & MASK for i in range(NUM_LIMBS)]


def limbs_to_int(limbs) -> int:
    return sum(int(v) << (BITS * i) for i, v in enumerate(limbs))


def const(n: int, device="cpu") -> torch.Tensor:
    """A constant element, int64[10, 1]: broadcasts against [10, B]."""
    return torch.tensor(int_to_limbs(n), dtype=torch.int64, device=device)[:, None]


def from_ints(values, device="cpu") -> torch.Tensor:
    """Python ints → int64[10, len(values)] canonical limbs."""
    cols = [int_to_limbs(v) for v in values]
    return torch.tensor(cols, dtype=torch.int64, device=device).T.contiguous()


def to_ints(x: torch.Tensor) -> List[int]:
    """[10, B] → the B values mod p."""
    limbs = x.cpu().tolist()
    return [limbs_to_int([limbs[i][b] for i in range(NUM_LIMBS)]) % P for b in range(x.shape[1])]


def _digits(x: torch.Tensor) -> torch.Tensor:
    """Non-negative int64[n, *batch] → the base-2^26 digits of
    Σ x[k]·2^(26k): entries 0..n-2 below 2^26, entry n-1 keeping the
    rest. These are the digits the card's sequential carry pass leaves
    (they are unique); here they come from rounds of carries in
    parallel, which ends sooner in torch."""
    x = x.clone()
    while True:
        c = x[:-1] >> BITS
        if not bool(c.any()):
            return x
        x[:-1] -= c << BITS
        x[1:] += c


def _fold(h: torch.Tensor) -> torch.Tensor:
    """Digits [11, *batch], entry 10 at weight 2^260 → ten limbs with
    entry 10 folded back (x0x3D10 into limb 0, x0x400 into limb 1)."""
    out = h[:10].clone()
    out[0] += h[10] * FOLD_LO
    out[1] += h[10] * FOLD_HI
    return out


def _carry(h: torch.Tensor) -> torch.Tensor:
    """One carry pass over ten limbs, the carry out of limb 9 folded back,
    then one more carry out of limb 0 (see the module doc)."""
    h = _fold(_digits(torch.cat([h, torch.zeros_like(h[:1])])))
    h[1] += h[0] >> BITS
    h[0] &= MASK
    return h


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _carry(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    shape = (NUM_LIMBS,) + (1,) * (max(a.dim(), b.dim()) - 1)
    return _carry(a + _SUB.to(a.device).view(shape) - b)


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """a · k for a small constant k (the curve's b3 = 21)."""
    return _carry(a * k)


def _reduce(cols: torch.Tensor) -> torch.Tensor:
    """19 product columns [19, *batch] (each below 2^56) → carried form:
    their 20 digits, digits 10..19 folded down, then two carry passes."""
    d = _digits(torch.cat([cols, torch.zeros_like(cols[:1])]))  # [20, *batch]
    zero = torch.zeros_like(d[:1])
    # digit 10 + m (weight 2^(260 + 26m)) adds LO at m and HI at m + 1
    h = torch.cat([d[:10], zero]) + torch.cat([d[10:], zero]) * FOLD_LO + torch.cat([zero, d[10:]]) * FOLD_HI
    return _carry(_fold(_digits(h)))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook 10x10 product into 19 columns, then ``_reduce``."""
    a, b = torch.broadcast_tensors(a, b)
    batch = tuple(a.shape[1:])
    prods = (a[:, None] * b[None, :]).reshape((-1,) + batch)  # [100, *batch]
    cols = torch.zeros((2 * NUM_LIMBS - 1,) + batch, dtype=torch.int64, device=a.device)
    cols.index_add_(0, _COLUMNS.to(a.device), prods)
    return _reduce(cols)


def sq(a: torch.Tensor) -> torch.Tensor:
    """The columns of mul(a, a); the card takes each pair i < j once,
    doubled, and gets the same columns."""
    return mul(a, a)


def _sq_n(x: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        x = sq(x)
    return x


def sqrt_candidate(a: torch.Tensor) -> torch.Tensor:
    """a^((p+1)/4), a square root of a when one exists (p ≡ 3 mod 4),
    by libsecp256k1's addition chain: 253 squarings and 13 products
    (the reference's ``_pow_const`` :246 walks the exponent's bits)."""
    x2 = mul(sq(a), a)
    x3 = mul(sq(x2), a)
    x6 = mul(_sq_n(x3, 3), x3)
    x9 = mul(_sq_n(x6, 3), x3)
    x11 = mul(_sq_n(x9, 2), x2)
    x22 = mul(_sq_n(x11, 11), x11)
    x44 = mul(_sq_n(x22, 22), x22)
    x88 = mul(_sq_n(x44, 44), x44)
    x176 = mul(_sq_n(x88, 88), x88)
    x220 = mul(_sq_n(x176, 44), x44)
    x223 = mul(_sq_n(x220, 3), x3)
    t = mul(_sq_n(x223, 23), x22)
    t = mul(_sq_n(t, 6), x2)
    return _sq_n(t, 2)


def to_canonical(x: torch.Tensor) -> torch.Tensor:
    """Carried form → the unique limbs of the value in [0, p).

    Two passes fold the bits above 2^256 (limb 9 keeps 22 bits) as
    0x3D1 into limb 0 and 0x40 into limb 1, each ending with a carry out
    of limb 0. A carried value is below 2^260 + 2^41; the first pass
    leaves it below 2^256 + 2^37, the second below 2^256 < 2p with every
    limb in range, so one conditional subtraction of p finishes."""
    h = list(x.unbind(0))
    for _ in range(2):
        for i in range(NUM_LIMBS - 1):
            h[i + 1] = h[i + 1] + (h[i] >> BITS)
            h[i] = h[i] & MASK
        c = h[9] >> TOP_BITS
        h[9] = h[9] & ((1 << TOP_BITS) - 1)
        h[0] = h[0] + c * 0x3D1
        h[1] = h[1] + c * 0x40 + (h[0] >> BITS)
        h[0] = h[0] & MASK
    d, borrow = [], torch.zeros_like(h[0])
    for i in range(NUM_LIMBS):
        t = h[i] - P_LIMBS[i] - borrow
        borrow = (t < 0).to(torch.int64)
        d.append(t + (borrow << (TOP_BITS if i == NUM_LIMBS - 1 else BITS)))
    keep = borrow.bool()  # borrow out: the value is below p
    return torch.stack([torch.where(keep, h[i], d[i]) for i in range(NUM_LIMBS)], dim=0)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bool[batch]: a = b in the field."""
    return (to_canonical(a) == to_canonical(b)).all(dim=0)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (to_canonical(a) == 0).all(dim=0)


def select(pred: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """pred bool[batch] → a where pred, else b."""
    return torch.where(pred[None], a, b)
