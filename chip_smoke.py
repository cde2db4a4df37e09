"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no last line) if it
goes wrong:

1. build   — compile every kernel of the path from csrc/ (one nvcc per
             source, started together) and print the seconds it took;
2. kernels — hold each kernel against its plain torch version on the card:
             Ed25519 on the contract's edge cases and a mixed batch (and
             against the CPU verifier), SHA-256 at message lengths 0, 55,
             56, 64, 65 and 200 in fixed and ragged form (and against
             hashlib), Merkle roots for n in {1, 2, 3, 5, 180, 4097} (and
             against the host tree);
3. main    — a 180-validator set (the Cosmos Hub's active set) with seeded
             keys and powers and a commit that all of them sign:
             verify_commit, verify_commit_light and
             verify_commit_light_trusting under the default backend (the
             card, "gpu") and under "cpu" must agree,
             as must the errors for one corrupted signature and for a
             commit under 2/3; ValidatorSet.hash on the card must equal the
             host tree; every kernel's launch count must be above 0;
4. times   — host wall medians of verify_commit ("gpu" and "cpu") and
             ValidatorSet.hash; CUDA-event medians of each kernel beside its
             plain version and its bound (the larger of bytes over 3.35 TB/s
             and 32-bit integer operations over the card's integer rate),
             at the main path's shapes, where each kernel's output must
             again equal its plain version's exactly.

The last two lines of standard output are the kernels' JSON record and
{"ok": true, "device": {...}}. Needs one CUDA card; exits non-zero
without one.
"""

from __future__ import annotations

import copy
import hashlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from cometbft_tpu_torch.crypto import ed25519 as ed
from cometbft_tpu_torch.crypto import merkle as host_merkle
from cometbft_tpu_torch.crypto import purepy
from cometbft_tpu_torch.crypto.cuda import build, ed25519_batch, merkle, sha256, vectors
from cometbft_tpu_torch.proto.gogo import Timestamp
from cometbft_tpu_torch.types.block import (
    BLOCK_ID_FLAG_COMMIT,
    BlockID,
    Commit,
    CommitSig,
    PartSetHeader,
)
from cometbft_tpu_torch.types.validator import Validator
from cometbft_tpu_torch.types.validator_set import Fraction, ValidatorSet

SEED = 20261017
N_VALIDATORS = 180  # Cosmos Hub x/staking max_validators
BIG_BATCH = 16384  # ~91 commits of 180, as in blocksync
CHAIN_ID = "cosmoshub-4"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# 32-bit integer lanes per SM per clock: 4 sub-partitions of 16 INT32 units
# (NVIDIA's H100 architecture whitepaper); times SMs and the max SM clock,
# both read from the card (132 and 1,980 MHz on an H100 SXM: 16.7e12 /s).
INT32_LANES_PER_SM_CLOCK = 64

# Operation model for the bounds, in 32-bit integer instructions per lane.
# A 32x32->64 multiply-add (IMAD.WIDE.U32) writes two registers and counts 2;
# a carry pass is 11 steps of shift, add and mask on 64-bit (fe_mul, fe_sq)
# or 32-bit (fe_add) column sums.
CARRY64_OPS = 11 * 4
FE_MUL_OPS = 2 * 100 + 15 + CARRY64_OPS  # 100 products, the x19/x2 prep
FE_SQ_OPS = 2 * 55 + 21 + CARRY64_OPS  # 55 products, 21 distinct multipliers m * f[j]
FE_ADD_OPS = 10 + 11 * 3
FE_CANONICAL_OPS = 2 * 11 * 3 + 10 * 5
SHA_BLOCK_OPS = 64 * 25 + 48 * 13 + 8  # rounds, schedule, feed-forward

KERNELS = {
    "ed25519_verify_compact": (
        "cometbft_tpu_torch/crypto/cuda/csrc/ed25519_verify.cu",
        "cometbft_tpu/crypto/tpu/ed25519_batch.py:338",
    ),
    "sha256_blocks": (
        "cometbft_tpu_torch/crypto/cuda/csrc/sha256.cu",
        "cometbft_tpu/crypto/tpu/sha256_pallas.py:30",
    ),
    "merkle_level": (
        "cometbft_tpu_torch/crypto/cuda/csrc/merkle.cu",
        "cometbft_tpu/crypto/tpu/merkle.py:103",
    ),
}


class Failed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def reset_counts() -> None:
    ed25519_batch.LAUNCHES = 0
    sha256.LAUNCHES = 0
    merkle.LAUNCHES = 0


def counts() -> dict:
    return {
        "ed25519_verify_compact": ed25519_batch.LAUNCHES,
        "sha256_blocks": sha256.LAUNCHES,
        "merkle_level": merkle.LAUNCHES,
    }


def cuda_ms(fn, runs: int, warmup: int = 3) -> float:
    """Median over ``runs`` of the CUDA-event time of one call of fn."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def int32_ops_per_s() -> float:
    """The card's 32-bit integer instruction rate: SMs x 64 lanes x the
    max SM clock."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM_CLOCK * float(mhz) * 1e6


def bound(nbytes: float, ops: float, int_rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int_rate * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ed25519_ops_per_lane() -> int:
    """32-bit integer instructions that one lane of the kernel needs at
    least, whatever its data (the loop has no early exit), from the field
    operations it runs (ed25519_verify.cu, fe25519.cuh)."""
    dbl = (4, 4, 8)  # squarings, products, sums of ge_dbl
    add_cached = (0, 8, 6)
    to_cached = (0, 1, 3)
    ge_add = tuple(a + b for a, b in zip(to_cached, add_cached))
    decompress = (4 + 251, 7 + 11, 4)  # with fe_pow_p58
    setup = tuple(2 * d + 2 * a for d, a in zip(dbl, ge_add))  # 2B, 3B, -2A, -3A
    setup = (setup[0], setup[1] + 2, setup[2] + 1)  # the T of B and -A, -A's X
    table = tuple(9 * a + 16 * c for a, c in zip(ge_add, to_cached))
    loop = tuple(127 * (2 * d + a) for d, a in zip(dbl, add_cached))
    final = (254, 11 + 2, 0)  # fe_invert, then x and y
    sq, mul, add = (sum(p[k] for p in (decompress, setup, table, loop, final)) for k in range(3))
    canonical = 5 + 2
    digits = 127 * 8
    return sq * FE_SQ_OPS + mul * FE_MUL_OPS + add * FE_ADD_OPS + canonical * FE_CANONICAL_OPS + digits


# --- phase 2: kernels against their plain versions --------------------------


def check_ed25519(dev) -> int:
    cases = vectors.edge_cases(SEED) + vectors.mixed_batch(33, SEED)
    wire, valid = ed25519_batch.prepare_batch_compact(
        [c[1] for c in cases], [c[2] for c in cases], [c[3] for c in cases]
    )
    wire_t = torch.from_numpy(wire).to(dev)
    got = ed25519_batch.verify_kernel_compact(wire_t)
    torch.cuda.synchronize()
    plain = ed25519_batch.verify_compact_plain(wire_t)
    err = int((got.to(torch.int64) - plain.to(torch.int64)).abs().max())
    check(err == 0, "ed25519 kernel disagrees with its plain version")
    cpu = [purepy.ed25519_verify(c[1], c[2], c[3]) for c in cases]
    check(list(got.cpu().numpy() & valid) == cpu, "ed25519 kernel disagrees with the CPU verifier")
    accepted = sum(cpu)
    print(f"kernels: ed25519 {len(cases)} lanes ({accepted} accepted) == plain == cpu, max_abs_err {err}")
    return err


def check_sha256(dev) -> int:
    rng = np.random.default_rng(SEED)
    err = 0
    for msg_len in (0, 55, 56, 64, 65, 200):
        msgs = rng.integers(0, 256, (64, msg_len), dtype=np.uint8)
        blocks = sha256.from_u32(sha256.pad_messages_np(msgs, msg_len), dev)
        got = sha256.sha256_blocks(blocks)
        plain = sha256.sha256_blocks_plain(blocks)
        err = max(err, int((got.to(torch.int64) - plain.to(torch.int64)).abs().max()))
        digests = sha256.digests_to_bytes_np(sha256.to_u32(got))
        want = [hashlib.sha256(m.tobytes()).digest() for m in msgs]
        check([d.tobytes() for d in digests] == want, f"sha256 fixed form != hashlib at {msg_len}")
    items = [rng.bytes(n) for n in [0, 55, 56, 64, 65, 200] * 11]
    blocks_np, n_live_np = sha256.pad_ragged_np(items)
    blocks = sha256.from_u32(blocks_np, dev)
    n_live = torch.from_numpy(n_live_np).to(dev)
    got = sha256.sha256_blocks(blocks, n_live)
    plain = sha256.sha256_blocks_plain(blocks, n_live)
    err = max(err, int((got.to(torch.int64) - plain.to(torch.int64)).abs().max()))
    digests = sha256.digests_to_bytes_np(sha256.to_u32(got))
    check(
        [d.tobytes() for d in digests] == [hashlib.sha256(m).digest() for m in items],
        "sha256 ragged form != hashlib",
    )
    check(err == 0, "sha256 kernel disagrees with its plain version")
    print(f"kernels: sha256 fixed (6 lengths x 64) and ragged ({len(items)}) == plain == hashlib, max_abs_err {err}")
    return err


def check_merkle(dev) -> int:
    rng = np.random.default_rng(SEED + 1)
    err = 0
    for n in (1, 2, 3, 5, 180, 4097):
        items = [rng.bytes(int(rng.integers(1, 90))) for _ in range(n)]
        want = host_merkle.hash_from_byte_slices(items)
        got = merkle.hash_from_byte_slices(items, device=dev)
        plain = merkle.hash_from_byte_slices(items, device="cpu")
        check(got == want == plain, f"merkle root differs at n={n}")
        digests = sha256.from_u32(
            rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32), dev
        )
        lvl = merkle.merkle_level(digests)
        lvl_plain = merkle.merkle_level_plain(digests)
        err = max(err, int((lvl.to(torch.int64) - lvl_plain.to(torch.int64)).abs().max()))
    check(err == 0, "merkle_level kernel disagrees with its plain version")
    print(f"kernels: merkle roots n in (1, 2, 3, 5, 180, 4097) == plain == host tree, max_abs_err {err}")
    return err


# --- phase 3: the main path --------------------------------------------------


def make_valset_and_commit():
    rng = np.random.default_rng(SEED)
    privs = [ed.gen_priv_key_from_secret(b"cosmoshub-val-%d" % i) for i in range(N_VALIDATORS)]
    powers = rng.integers(1_000, 5_000_000, N_VALIDATORS)
    vals = ValidatorSet([Validator.new(k.pub_key(), int(p)) for k, p in zip(privs, powers)])
    by_addr = {k.pub_key().address(): k for k in privs}
    signers = [by_addr[v.address] for v in vals.validators]
    block_id = BlockID(rng.bytes(32), PartSetHeader(3, rng.bytes(32)))
    ts = Timestamp(1_760_000_000, 123_456_789)
    commit = Commit(height=20_000_000, round=0, block_id=block_id)
    for v, k in zip(vals.validators, signers):
        cs = CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, ts, b"")
        commit.signatures.append(cs)
    for i, k in enumerate(signers):
        commit.signatures[i].signature = k.sign(commit.vote_sign_bytes(CHAIN_ID, i))
    return vals, block_id, commit


def outcome(fn):
    try:
        fn()
        return ("ok",)
    except Exception as e:  # noqa: BLE001 - the verdict is the exception
        return (type(e).__name__, str(e))


def run_main_path(vals, block_id, commit):
    height = commit.height
    corrupted = copy.deepcopy(commit)
    sig = bytearray(corrupted.signatures[17].signature)
    sig[5] ^= 0x10
    corrupted.signatures[17].signature = bytes(sig)
    under = copy.deepcopy(commit)
    total, absent = vals.total_voting_power(), 0
    for i, v in enumerate(vals.validators):  # absent until at most 2/3 remain
        under.signatures[i] = CommitSig.absent()
        absent += v.voting_power
        if (total - absent) * 3 <= total * 2:
            break
    trust = Fraction(1, 3)

    def calls(c):
        return {
            "verify_commit": lambda b: vals.verify_commit(CHAIN_ID, block_id, height, c, backend=b),
            "verify_commit_light": lambda b: vals.verify_commit_light(CHAIN_ID, block_id, height, c, backend=b),
            "verify_commit_light_trusting": lambda b: vals.verify_commit_light_trusting(CHAIN_ID, c, trust, backend=b),
        }

    per_call = {}
    results = {}
    for label, c in (("signed", commit), ("corrupted", corrupted), ("under_2/3", under)):
        for name, fn in calls(c).items():
            before = counts()
            t0 = time.perf_counter()
            gpu = outcome(lambda: fn(None))  # the default backend: the card
            gpu_s = time.perf_counter() - t0
            after = counts()
            t0 = time.perf_counter()
            cpu = outcome(lambda: fn("cpu"))
            cpu_s = time.perf_counter() - t0
            check(gpu == cpu, f"{label} {name}: gpu {gpu} != cpu {cpu}")
            results[(label, name)] = gpu
            per_call[f"{label} {name}"] = {k: after[k] - before[k] for k in after}
            print(f"main: {label:9s} {name:29s} gpu == cpu: {gpu[0]:35s} host wall gpu {gpu_s * 1e3:.1f} ms, cpu {cpu_s * 1e3:.1f} ms")
    check(results[("signed", "verify_commit")] == ("ok",), "the signed commit did not verify")
    check(results[("corrupted", "verify_commit")][0] == "ValueError", "the corrupted commit verified")
    check(
        results[("under_2/3", "verify_commit")][0] == "ErrNotEnoughVotingPowerSigned",
        "the under-2/3 commit verified",
    )
    before = counts()
    dev_hash = vals.hash()  # the default device: the card
    per_call["ValidatorSet.hash"] = {k: v - before[k] for k, v in counts().items()}
    check(dev_hash == vals.hash(device="cpu"), "ValidatorSet.hash on the card != host tree")
    print(f"main: ValidatorSet.hash on the card == host tree ({dev_hash.hex()[:16]}...)")
    return per_call


# --- phase 4: times ------------------------------------------------------------


def max_abs_err(got: torch.Tensor, plain: torch.Tensor) -> int:
    check(got.shape == plain.shape, f"shapes differ: {tuple(got.shape)} vs {tuple(plain.shape)}")
    return int((got.to(torch.int64) - plain.to(torch.int64)).abs().max())


def time_kernels(vals, commit, card: str, errs: dict) -> dict:
    """Times each kernel at the main path's shapes, and holds its output
    there against its plain version (exactly), folding the difference
    into ``errs``."""
    dev = torch.device("cuda")
    int_rate = int32_ops_per_s()
    print(f"time: bound rates {HBM_BYTES_PER_S:.4g} B/s, {int_rate:.4g} int32 ops/s [{card}]")
    pks = [v.pub_key.bytes() for v in vals.validators]
    msgs = [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(len(pks))]
    sigs = [cs.signature for cs in commit.signatures]
    wire_np, valid = ed25519_batch.prepare_batch_compact(pks, msgs, sigs)
    check(bool(valid.all()), "the signed commit packed with an invalid lane")
    out = {}

    def ed_row(batch, plain_runs):
        w = torch.from_numpy(np.ascontiguousarray(np.tile(wire_np, (1, -(-batch // N_VALIDATORS)))[:, :batch])).to(dev)
        got = ed25519_batch.verify_kernel_compact(w)
        plain = ed25519_batch.verify_compact_plain(w)
        err = max_abs_err(got, plain)
        check(err == 0, f"ed25519 kernel disagrees with its plain version at B={batch}")
        check(bool(got.all()), f"ed25519 kernel rejected a signed lane at B={batch}")
        errs["ed25519_verify_compact"] = max(errs["ed25519_verify_compact"], err)
        print(f"kernels: ed25519 B={batch} == plain, all {batch} accepted, max_abs_err {err}")
        ms = cuda_ms(lambda: ed25519_batch.verify_kernel_compact(w), runs=20)
        plain_ms = cuda_ms(lambda: ed25519_batch.verify_compact_plain(w), runs=plain_runs, warmup=1)
        b_ms, b_by = bound(batch * (128 + 1), batch * ed25519_ops_per_lane(), int_rate)
        return ms, plain_ms, b_ms, b_by

    ms, plain_ms, b_ms, b_by = ed_row(N_VALIDATORS, 5)
    ms_big, plain_big, b_big, b_by_big = ed_row(BIG_BATCH, 3)
    out["ed25519_verify_compact"] = {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"u8[128,{N_VALIDATORS}]",
        "ms_16384": ms_big, "plain_ms_16384": plain_big,
        "bound_ms_16384": b_big, "bound_by_16384": b_by_big,
    }
    print(f"time: ed25519_verify_compact B={N_VALIDATORS}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {b_ms:.6f} ms ({b_by}) [{card}]")
    print(f"time: ed25519_verify_compact B={BIG_BATCH}: kernel {ms_big:.4f} ms, plain {plain_big:.2f} ms, bound {b_big:.6f} ms ({b_by_big}) [{card}]")

    leaves = [v.bytes() for v in vals.validators]
    blocks_np, n_live_np = sha256.pad_ragged_np(leaves, prefix=merkle.LEAF_PREFIX)
    blocks = sha256.from_u32(blocks_np, dev)
    n_live = torch.from_numpy(n_live_np).to(dev)
    leaf_digests = sha256.sha256_blocks(blocks, n_live)
    err = max_abs_err(leaf_digests, sha256.sha256_blocks_plain(blocks, n_live))
    check(err == 0, "sha256 kernel disagrees with its plain version on the validator leaves")
    want = [hashlib.sha256(merkle.LEAF_PREFIX + leaf).digest() for leaf in leaves]
    got = [d.tobytes() for d in sha256.digests_to_bytes_np(sha256.to_u32(leaf_digests))]
    check(got == want, "sha256 kernel != hashlib on the validator leaves")
    errs["sha256_blocks"] = max(errs["sha256_blocks"], err)
    print(f"kernels: sha256 u32{list(blocks_np.shape)} ragged == plain == hashlib, max_abs_err {err}")
    ms = cuda_ms(lambda: sha256.sha256_blocks(blocks, n_live), runs=50)
    plain_ms = cuda_ms(lambda: sha256.sha256_blocks_plain(blocks, n_live), runs=20)
    b_ms, b_by = bound(blocks_np.nbytes + n_live_np.nbytes + 32 * len(leaves), int(n_live_np.sum()) * SHA_BLOCK_OPS, int_rate)
    out["sha256_blocks"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "shape": f"u32[{blocks_np.shape[0]},{blocks_np.shape[1]},16] ragged"}
    print(f"time: sha256_blocks {out['sha256_blocks']['shape']}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {b_ms:.6f} ms ({b_by}) [{card}]")

    def tree(level_fn):
        level = leaf_digests
        while level.shape[0] > 1:
            level = level_fn(level)
        return level

    root = tree(merkle.merkle_level)
    err = max_abs_err(root, tree(merkle.merkle_level_plain))
    check(err == 0, "merkle_level kernel disagrees with its plain version on the validator tree")
    check(
        sha256.digests_to_bytes_np(sha256.to_u32(root))[0].tobytes() == vals.hash(device="cpu"),
        "merkle_level tree of the validator leaves != host tree",
    )
    errs["merkle_level"] = max(errs["merkle_level"], err)
    print(f"kernels: merkle_level tree of {len(leaves)} leaves == plain == host tree, max_abs_err {err}")
    ms = cuda_ms(lambda: tree(merkle.merkle_level), runs=50)
    plain_ms = cuda_ms(lambda: tree(merkle.merkle_level_plain), runs=20)
    inner = len(leaves) - 1
    b_ms, b_by = bound(32 * len(leaves) + 32, inner * 2 * SHA_BLOCK_OPS, int_rate)
    out["merkle_level"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                           "shape": f"{len(leaves)} leaf digests -> root, 8 levels"}
    print(f"time: merkle_level tree of {len(leaves)}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {b_ms:.6f} ms ({b_by}) [{card}]")
    return out


def wall_ms(fn, runs: int, warmup: int = 1) -> float:
    """Median host wall time of fn() in ms; fn must end in a sync."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def time_end_to_end(vals, block_id, commit, card: str) -> None:
    """Host wall medians of the entry points a node calls per commit."""
    height = commit.height

    def verify(backend):
        return lambda: vals.verify_commit(CHAIN_ID, block_id, height, commit, backend=backend)

    pks = [v.pub_key.bytes() for v in vals.validators]
    msgs = [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(len(pks))]
    sigs = [cs.signature for cs in commit.signatures]
    rows = [
        ("verify_commit gpu", wall_ms(verify("gpu"), runs=20)),
        ("verify_commit cpu", wall_ms(verify("cpu"), runs=3, warmup=0)),
        ("  of which sign bytes", wall_ms(lambda: [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(len(pks))], runs=20)),
        ("  of which host packing", wall_ms(lambda: ed25519_batch.prepare_batch_compact(pks, msgs, sigs), runs=20)),
        ("ValidatorSet.hash cuda", wall_ms(lambda: vals.hash(device="cuda"), runs=20)),
        ("ValidatorSet.hash host", wall_ms(lambda: vals.hash(device="cpu"), runs=20)),
    ]
    for label, ms in rows:
        print(f"e2e: {label:25s} p50 {ms:.3f} ms host wall, {N_VALIDATORS} validators [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card)
    dev = torch.device("cuda")
    torch.manual_seed(SEED)

    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(built)}")
    for name in build.SOURCES:
        with open(build.log_path(name), encoding="utf-8") as f:
            for line in f:
                if "registers" in line or "spill" in line or "stack frame" in line:
                    print(f"build: {name}: {line.strip()}")

    errs = {
        "ed25519_verify_compact": check_ed25519(dev),
        "sha256_blocks": check_sha256(dev),
        "merkle_level": check_merkle(dev),
    }

    t0 = time.perf_counter()
    vals, block_id, commit = make_valset_and_commit()
    print(f"main: {N_VALIDATORS} validators signed in {time.perf_counter() - t0:.1f} s, total power {vals.total_voting_power()}")
    reset_counts()
    per_call = run_main_path(vals, block_id, commit)
    launches = counts()
    torch.cuda.synchronize()
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    print(f"main: launches {json.dumps(launches)}")
    print(f"main: launches per call {json.dumps(per_call)}")

    time_end_to_end(vals, block_id, commit, card)
    times = time_kernels(vals, commit, card, errs)
    record = []
    for name, (source, replaces) in KERNELS.items():
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name],
            "library_ms": None,
        }
        row.update(times[name])
        record.append(row)
    print(json.dumps({"kernels": record, "card": card}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
