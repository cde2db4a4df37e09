"""GF(2^255-19) as plain torch tensors — the CPU twin of ``csrc/fe25519.cuh``.

Reference: cometbft_tpu/crypto/tpu/field.py. The reference keeps an
element as int32[17, B] radix-2^15 signed limbs because the TPU's vector
lanes have no 32x32->64 multiply. Hopper has one, so the port uses ref10's
layout: ten limbs of alternately 26 and 25 bits (radix 2^25.5), limb i at
bit offset ceil(25.5 i). A field element here is an int64 tensor of shape
[10, *batch] (limb axis first, as in the reference), and the CUDA kernel
holds the same ten limbs as uint32 in registers.

Invariant ("carried form"): every limb is non-negative, limb i < 2^w_i
(w = 26, 25, 26, ...) except limb 1, which may exceed 2^25 by at most
2^15. Every operation below takes and returns carried form:

* ``sub`` adds 2p limb-wise before subtracting, so no limb goes negative;
* ``mul`` sums at most ten products per column, each below
  38 * 2^26 * (2^25 + 2^15) < 2^57, so a column stays below 2^61 and
  fits in int64 (uint64 on the card) with no intermediate carry;
* ``_carry`` is one sequential floor-carry pass, the top carry folded
  back times 19 (2^255 = 19 mod p), then one more carry out of limb 0.

Only ``to_canonical`` produces the unique representative in [0, p).
The arithmetic is exact integer arithmetic: the tests hold every
operation against Python ints with equality, no tolerance.
"""

from __future__ import annotations

from typing import List

import torch

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = (2 * D) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

NUM_LIMBS = 10
WIDTHS = [26, 25] * 5
OFFSETS = [sum(WIDTHS[:i]) for i in range(NUM_LIMBS)]  # ceil(25.5 i)
_MASKS = [(1 << w) - 1 for w in WIDTHS]


def int_to_limbs(n: int) -> List[int]:
    """Canonical limbs of n mod p."""
    n %= P
    return [(n >> OFFSETS[i]) & _MASKS[i] for i in range(NUM_LIMBS)]


def limbs_to_int(limbs) -> int:
    return sum(int(v) << OFFSETS[i] for i, v in enumerate(limbs))


_P_LIMBS = [(P >> OFFSETS[i]) & _MASKS[i] for i in range(NUM_LIMBS)]
_TWO_P_LIMBS = [2 * v for v in _P_LIMBS]

# mul column multipliers: a product of two odd limbs lands one bit high
# (2x), and a product past limb 9 wraps with 2^255 = 19 (19x)
_MUL_FACTORS = torch.tensor(
    [
        [(2 if (i & 1 and j & 1) else 1) * (19 if i + j >= NUM_LIMBS else 1)
         for j in range(NUM_LIMBS)]
        for i in range(NUM_LIMBS)
    ],
    dtype=torch.int64,
)
_MUL_COLUMNS = torch.tensor(
    [(i + j) % NUM_LIMBS for i in range(NUM_LIMBS) for j in range(NUM_LIMBS)],
    dtype=torch.int64,
)


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
    return [
        limbs_to_int([limbs[i][b] for i in range(NUM_LIMBS)]) % P
        for b in range(x.shape[1])
    ]


def _carry(rows: List[torch.Tensor]) -> torch.Tensor:
    """Non-negative columns below 2^62 → carried form (see module doc)."""
    h = list(rows)
    for i in range(NUM_LIMBS):
        c = h[i] >> WIDTHS[i]
        h[i] = h[i] & _MASKS[i]
        if i + 1 < NUM_LIMBS:
            h[i + 1] = h[i + 1] + c
        else:
            h[0] = h[0] + 19 * c
    c = h[0] >> WIDTHS[0]
    h[0] = h[0] & _MASKS[0]
    h[1] = h[1] + c
    return torch.stack(h, dim=0)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _carry(list((a + b).unbind(0)))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    two_p = torch.tensor(_TWO_P_LIMBS, dtype=torch.int64, device=a.device)
    shape = (NUM_LIMBS,) + (1,) * (max(a.dim(), b.dim()) - 1)
    return _carry(list((a + two_p.view(shape) - b).unbind(0)))


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook 10x10 product, columns folded mod p, then one carry."""
    a, b = torch.broadcast_tensors(a, b)
    batch = a.shape[1:]
    factors = _MUL_FACTORS.to(a.device).view((NUM_LIMBS, NUM_LIMBS) + (1,) * len(batch))
    prods = a[:, None] * b[None, :] * factors  # [10, 10, *batch]
    cols = torch.zeros((NUM_LIMBS,) + tuple(batch), dtype=torch.int64, device=a.device)
    cols.index_add_(0, _MUL_COLUMNS.to(a.device), prods.reshape((-1,) + tuple(batch)))
    return _carry(list(cols.unbind(0)))


def sq(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def _sq_n(x: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        x = sq(x)
    return x


def invert(x: torch.Tensor) -> torch.Tensor:
    """x^(p-2) by the ref10 addition chain (254 squarings, 11 products);
    invert(0) = 0."""
    t0 = sq(x)  # 2
    t1 = mul(x, _sq_n(t0, 2))  # 9
    t2 = mul(t0, t1)  # 11
    t3 = sq(t2)  # 22
    t3 = mul(t1, t3)  # 2^5 - 1
    t4 = mul(_sq_n(t3, 5), t3)  # 2^10 - 1
    t5 = mul(_sq_n(t4, 10), t4)  # 2^20 - 1
    t6 = mul(_sq_n(t5, 20), t5)  # 2^40 - 1
    t5 = mul(_sq_n(t6, 10), t4)  # 2^50 - 1
    t6 = mul(_sq_n(t5, 50), t5)  # 2^100 - 1
    t7 = mul(_sq_n(t6, 100), t6)  # 2^200 - 1
    t6 = mul(_sq_n(t7, 50), t5)  # 2^250 - 1
    return mul(_sq_n(t6, 5), t2)  # 2^255 - 21


def pow_p58(x: torch.Tensor) -> torch.Tensor:
    """x^((p-5)/8) = x^(2^252-3), ref10's fe_pow22523 chain."""
    t0 = sq(x)  # 2
    t1 = mul(x, _sq_n(t0, 2))  # 9
    t0 = mul(t0, t1)  # 11
    t0 = sq(t0)  # 22
    t0 = mul(t1, t0)  # 2^5 - 1
    t1 = mul(_sq_n(t0, 5), t0)  # 2^10 - 1
    t2 = mul(_sq_n(t1, 10), t1)  # 2^20 - 1
    t3 = mul(_sq_n(t2, 20), t2)  # 2^40 - 1
    t2 = mul(_sq_n(t3, 10), t1)  # 2^50 - 1
    t3 = mul(_sq_n(t2, 50), t2)  # 2^100 - 1
    t4 = mul(_sq_n(t3, 100), t3)  # 2^200 - 1
    t3 = mul(_sq_n(t4, 50), t2)  # 2^250 - 1
    return mul(_sq_n(t3, 2), x)  # 2^252 - 3


def to_canonical(x: torch.Tensor) -> torch.Tensor:
    """Carried form → the unique limbs of the value in [0, p).

    A carried value is below 2^255 + 2^41. One full pass (top carry folded
    times 19) leaves it below 2^255 + 19; a second leaves every limb in
    range and the value below 2^255 < 2p, so one conditional subtraction
    of p finishes."""
    h = list(x.unbind(0))
    for _ in range(2):
        for i in range(NUM_LIMBS):
            c = h[i] >> WIDTHS[i]
            h[i] = h[i] & _MASKS[i]
            if i + 1 < NUM_LIMBS:
                h[i + 1] = h[i + 1] + c
            else:
                h[0] = h[0] + 19 * c
    d, borrow = [], torch.zeros_like(h[0])
    for i in range(NUM_LIMBS):
        t = h[i] - _P_LIMBS[i] - borrow
        borrow = (t < 0).to(torch.int64)
        d.append(t + (borrow << WIDTHS[i]))
    keep = borrow.bool()  # borrow out: value < p, keep it
    return torch.stack(
        [torch.where(keep, h[i], d[i]) for i in range(NUM_LIMBS)], dim=0
    )


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bool[batch]: a = b in the field."""
    return (to_canonical(a) == to_canonical(b)).all(dim=0)


def select(pred: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """pred bool[batch] → a where pred, else b."""
    return torch.where(pred[None], a, b)
