"""The port's GF(2^255-19) arithmetic (cometbft_tpu_torch/crypto/cuda/field.py,
the CPU twin of csrc/fe25519.cuh) against Python ints.

Every value is an integer: equality is exact, no tolerance. Inputs come
from numpy with a fixed seed and include the edges of the limb layout:
0, 1, p-1, p, p+1, 2^255-1 and limbs at the top of their carried range.

The file holds one test, which runs every check in turn: pytest-xdist's
``--dist loadfile`` deals files out largest first, so a one-test file
goes out after the rest of the suite and does not change which worker
runs the JAX package's files first (its executable store makes that
order matter; ROADMAP C-ref 5).
"""

import numpy as np
import torch

from cometbft_tpu_torch.crypto.cuda import field as fe

torch.set_num_threads(1)

P = fe.P


def _values(seed: int, n: int = 24):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    return vals + [0, 1, 2, P - 1, P - 2, 19, 2**255 - 20, 2**254]


def _raw(values) -> torch.Tensor:
    """Limbs of each value as given (not reduced mod p), [10, B]."""
    cols = [[(v >> off) & ((1 << w) - 1) for off, w in zip(fe.OFFSETS, fe.WIDTHS)] for v in values]
    return torch.tensor(cols, dtype=torch.int64).T.contiguous()


def _max_carried(n: int) -> torch.Tensor:
    """n copies of the largest carried form: every limb at its top, limb 1
    2^15 over (a value above 2^255, so not reduced)."""
    limbs = [(1 << w) - 1 for w in fe.WIDTHS]
    limbs[1] += 1 << 15
    return torch.tensor(limbs, dtype=torch.int64)[:, None].repeat(1, n)


def check_binary_ops():
    a_vals, b_vals = _values(1), _values(2)[::-1]
    a, b = fe.from_ints(a_vals), fe.from_ints(b_vals)
    pairs = list(zip(a_vals, b_vals))
    assert fe.to_ints(fe.add(a, b)) == [(x + y) % P for x, y in pairs]
    assert fe.to_ints(fe.sub(a, b)) == [(x - y) % P for x, y in pairs]
    assert fe.to_ints(fe.mul(a, b)) == [x * y % P for x, y in pairs]


def check_unary_ops():
    vals = _values(3)
    x = fe.from_ints(vals)
    assert fe.to_ints(fe.neg(x)) == [(-v) % P for v in vals]
    assert fe.to_ints(fe.sq(x)) == [v * v % P for v in vals]
    assert fe.to_ints(fe.invert(x)) == [pow(v, P - 2, P) for v in vals]
    assert fe.to_ints(fe.pow_p58(x)) == [pow(v, (P - 5) // 8, P) for v in vals]


def check_ops_keep_the_carried_form():
    """Outputs stay inside the bounds the CUDA kernel's uint64 column sums
    rely on, even from the largest carried inputs."""
    top = _max_carried(4)
    v = fe.limbs_to_int(top[:, 0].tolist())
    for out, want in (
        (fe.mul(top, top), v * v % P),
        (fe.add(top, top), 2 * v % P),
        (fe.sub(fe.from_ints([0] * 4), top), (-v) % P),
    ):
        assert fe.to_ints(out) == [want] * 4
        limbs = out.tolist()
        for i, w in enumerate(fe.WIDTHS):
            cap = (1 << w) + ((1 << 15) if i == 1 else 0)
            assert all(0 <= x < cap for x in limbs[i]), (i, limbs[i])


def check_chained_squarings():
    start = (P - 2, 3, 2**255 - 20)
    x = fe.from_ints(start)
    for _ in range(12):
        x = fe.sq(x)
    assert fe.to_ints(x) == [pow(v, 2**12, P) for v in start]


def check_to_canonical_edges():
    """Unreduced carried values: p, p + 1, p + 18, 2^255 - 1 and the
    largest carried form."""
    raw = [P, P + 1, P + 18, 2**255 - 1]
    top = _max_carried(1)
    x = torch.cat([_raw(raw), top], dim=1)
    want = [v % P for v in raw] + [fe.limbs_to_int(top[:, 0].tolist()) % P]
    canon = fe.to_canonical(x)
    assert [fe.limbs_to_int(canon[:, b].tolist()) for b in range(canon.shape[1])] == want


def check_eq_select_and_constants():
    a = fe.from_ints([5, 7, 0])
    b = _raw([P + 5, 8, P])
    assert fe.eq(a, b).tolist() == [True, False, True]
    assert fe.to_ints(fe.select(torch.tensor([True, False, True]), a, b)) == [5, 8, 0]
    x = fe.from_ints([3, 4])
    assert fe.to_ints(fe.mul(x, fe.const(fe.D))) == [3 * fe.D % P, 4 * fe.D % P]
    assert fe.SQRT_M1 * fe.SQRT_M1 % P == P - 1


def test_field_matches_int_oracle():
    check_binary_ops()
    check_unary_ops()
    check_ops_keep_the_carried_form()
    check_chained_squarings()
    check_to_canonical_edges()
    check_eq_select_and_constants()
