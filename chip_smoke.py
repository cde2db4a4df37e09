"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no last line) if it
goes wrong:

1. build   — compile every kernel of the path from csrc/ (one nvcc per
             source, started together) and print the seconds it took,
             each library's own, and the compiler's register, stack and
             spill report;
2. kernels — hold each kernel against its plain torch version on the card:
             Ed25519 (compact wire) on the contract's edge cases, a mixed
             batch and every way R can fail the projective compare
             (vectors.resident_r_cases as wire lanes with their keys, and
             as signatures), and against the CPU verifier, then the same
             lanes tiled to 6,000 at 2 threads a lane; the key table
             kernel on the 180 keys and the edge keys (y >= p, -0, one
             that does not decompress, torsioned), table for table; the
             resident kernel over the kernel's tables at B=180 in lane
             order and by a shuffled index with repeats and one row out
             of range, on the edge cases and every way R can fail the
             projective compare, and at 6,000 lanes by index; the
             device-hash kernel on the edge, device-hash, mixed and R
             cases (and against the CPU verifier), which holds the card's
             SHA-512 and reduction mod L to exactness (torsioned keys whose
             verdict changes with h + L); SHA-256
             at message lengths 0, 55, 56, 64, 65 and 200 in fixed and
             ragged form (and against hashlib); merkle_tree's roots for n
             in {1, 2, 3, 5, 180, 1025, 4097} (the last two past its
             shared memory, through its scratch buffer) against its plain
             version and the host tree, and merkle_level's levels;
             secp256k1_verify on the secp256k1 contract's cases, 40 mixed
             lanes (and against the CPU verifier) and the wire-level
             r + n, point-at-infinity and equal, opposite and zero
             partial-sum lanes, and at 6,000 lanes (2 threads a lane;
             phase 4's group sweep runs both kernels at 1, 2 and 4);
             sr25519_verify on the
             sr25519 contract's cases (every way a ristretto decode
             fails) and 40 mixed lanes (and against the CPU verifier),
             and at 6,000 lanes at 2 threads a lane;
             ed25519_verify_words and ed25519_verify_full_words on the
             edge, device-hash, mixed and R cases (the word kernel on the
             R wire lanes too; and against the CPU verifier);
3. main    — a 180-validator set (the Cosmos Hub's active set) with seeded
             keys and powers and a commit that all of them sign, driven
             through the entry points a node calls, path by path, each
             with the launch counts set to 0 just before it and read just
             after (every kernel of the path must have launched):
             commit        — verify_commit, verify_commit_light and
                             verify_commit_light_trusting under the default
                             backend (the card, "gpu") and under "cpu" must
                             agree, verdicts and errors, for the signed
                             commit, one corrupted signature and a commit
                             under 2/3; they take the resident route (the
                             first call uploads the set's keys and builds
                             their comb tables, the rest hit); a set with
                             one validator replaced misses and uploads
                             again; ValidatorSet.hash on the card (one
                             merkle_tree launch) equals the host tree;
             indexed flush — the 180 precommits flushed through
                             new_batch_verifier("gpu") while the set is
                             resident take the indexed route;
             device hash   — under CBFT_TPU_HASH=device, verify_commit and
                             the indexed flush still hash on the host (the
                             key-store routes ignore the knob, as the
                             reference's do), and with the key store
                             emptied the flush takes
                             ed25519_verify_full_compact;
             window        — a 16,384-lane blocksync window (~91 commits,
                             16 signatures corrupted) flushed with the key
                             store empty runs as two pipelined 8,192-lane
                             chunks and gives the expected mask;
             and the same for a second 180-validator set whose keys are
             secp256k1 (signed in pure Python):
             secp commit   — verify_commit* under "gpu" and "cpu" agree as
                             above, through add()/verify() (no key-store
                             upload); ValidatorSet.hash on the card (one
                             merkle_tree launch) equals the host tree;
             mixed flush   — the 180 Ed25519 precommits (the set resident:
                             indexed) and the 180 secp256k1 precommits,
                             interleaved, one of each corrupted, in one
                             new_batch_verifier("gpu") flush == "cpu";
             secp window   — 16,384 secp256k1 lanes (16 corrupted) in four
                             4,096-lane chunks give the expected mask;
             and with 180 seeded sr25519 keys, key i signing precommit
             i's sign bytes:
             sr flush      — the 180 sr25519 lanes (one corrupted) through
                             new_batch_verifier("gpu") == "cpu";
             three-curve flush — the 180 Ed25519 (indexed), 180 secp256k1
                             and 180 sr25519 lanes, interleaved, one of
                             each corrupted, in one flush == "cpu";
             sr window     — 8,192 sr25519 lanes (8 corrupted), one chunk,
                             give the expected mask; run once (host merlin
                             costs seconds), and that pass is timed;
             words         — with the key store emptied, the precommits
                             under CBFT_TPU_WIRE=words take
                             ed25519_verify_words, and with
                             CBFT_TPU_HASH=device ed25519_verify_full_words,
                             == "cpu";
             the indexed flush also checks that a
             GPUBatchVerifier(device="cuda:0") finds the set uploaded
             under "cuda" (no second upload);
             then the call sites (light, vote set, evidence: see their
             functions), and last the verify plane:
             verify plane  — one VerifyScheduler over one
                             BackendSupervisor over "gpu" (100%
                             synchronous audit, warm-up canary first);
                             four threads released together: consensus's
                             preverify and add_vote of the 180 precommits,
                             blocksync's window, the light client's two
                             steps, the lunatic attack; then one flush of
                             180 Ed25519, 180 secp256k1 and 180 sr25519
                             lanes. Every verdict and error == "cpu"; the
                             supervisor healthy with no trip, kill,
                             mismatch, CPU verdict, shed or drop; fewer
                             flushes than requests, consensus first in
                             its flush;
             verify plane faults — a supervisor over a fault plan in front
                             of "gpu" for each phase: three exceptions
                             walk the breaker to broken and the canary
                             re-admits the card; one corrupted dispatch is
                             caught by the synchronous audit; one OOM
                             halves the chunk cap and two clean dispatches
                             recover it; one hang is killed by the
                             watchdog and its zombie leaves; verdicts ==
                             "cpu" throughout;
             block execution — a genesis of the 180 validators (the
                             commit path's keys and powers), the kvstore
                             app behind a local proxy, MemDB state and
                             block stores: 8 heights of 200 kvstore txs of
                             about 100 bytes through
                             BlockExecutor(crypto_backend="gpu").apply_block,
                             each LastCommit of 180 precommits verified on
                             the card (resident route) and every
                             validator-set hash one merkle_tree launch; a
                             val: height (4) changes one power and adds a
                             key, so the set that signs height 6 uploads
                             and builds its key tables again at height 7
                             and hits at 8 (the key store's counters are
                             checked); then the same chain over "cpu" (the
                             native rung): every block, the final State,
                             the app hash and every store byte-equal; a
                             flipped LastCommit signature raises the same
                             error on both and leaves every store as it
                             was; each height's apply_block split
                             (validate_block and its verify_commit,
                             exec_block_on_proxy_app, the saves) printed;
4. times   — host wall medians of verify_commit (resident hit, the
             keyed compact route, "cpu"; the resident miss, upload and
             table build included, apart), the flushes and
             ValidatorSet.hash on the card and on the host in turns; signatures per second of the window in two
             chunks against one launch; the device's idle share over ten
             resident verify_commit calls (torch.profiler); the secp256k1
             set's verify_commit on "gpu" and "cpu" in turns, its packing
             alone, the secp window's signatures per second and the idle
             share over ten of its verify_commit calls; the sr flush on
             "gpu" and "cpu" in turns, its packing alone and the sr
             window's signatures per second; CUDA-event medians of each
             kernel
             beside its plain version and its bound (the larger of bytes
             over 3.35 TB/s and 32-bit integer operations over the card's
             integer rate), at the main path's shapes (B=180 and 16,384;
             4,096 too for secp256k1, 8,192 for sr25519 and for
             ed25519_verify_compact, 180 and 4,096 keys for the key
             tables, the 180 validator leaves for merkle_tree), where
             each kernel's output must again equal its plain version's
             exactly (merkle_tree and the key tables also back to
             back, run_ms); and the grouped kernels at each group size (1, 2
             and 4 threads a lane) through their C entry points, each
             output equal to the wrapper's: the resident and secp256k1
             kernels at B=180, 4,096 and 16,384, the two wire-key cores
             (ed25519_verify_compact at 180, 8,192 and 16,384,
             sr25519_verify at 180 and 8,192); the verify plane's
             preverify flush of the 180 precommits against bare "gpu"
             and "cpu", and the four call sites' round from four threads
             through the plane against one after another on bare "gpu",
             in turns; the CPU ladder's live rung and, on it, the
             synchronous audit's CPU check of the healthy round's 16,564
             lanes, the 180-lane preverify flush on "cpu" and
             _challenge_scalars at 16,384 lanes (native and the Python
             loop in turns); the block-execution chain on "gpu" and
             "cpu" in turns, and the card's idle share over its 8
             heights (torch.profiler).

Each phase prints its seconds ("phase:" lines).

The last two lines of standard output are the kernels' JSON record and
{"ok": true, "device": {...}}. Needs one CUDA card; exits non-zero
without one.
"""

from __future__ import annotations

import base64
import copy
import gc
import hashlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from cometbft_tpu_torch import native
from cometbft_tpu_torch.abci import types as abci_types
from cometbft_tpu_torch.abci.client import new_local_client_creator
from cometbft_tpu_torch.abci.kvstore import PersistentKVStoreApplication
from cometbft_tpu_torch.crypto import batch as cryptobatch
from cometbft_tpu_torch.crypto import ed25519 as ed
from cometbft_tpu_torch.crypto import faults
from cometbft_tpu_torch.crypto import merkle as host_merkle
from cometbft_tpu_torch.crypto import purepy, scheduler, supervisor
from cometbft_tpu_torch.crypto import secp256k1 as secp
from cometbft_tpu_torch.crypto import sr25519 as sr
from cometbft_tpu_torch.crypto.cuda import (
    build,
    ed25519_batch,
    keystore,
    merkle,
    mesh,
    secp256k1_batch,
    sha256,
    sr25519_batch,
    topology,
    vectors,
)
from cometbft_tpu_torch.evidence import verify as evidence_verify
from cometbft_tpu_torch.libs.db import MemDB
from cometbft_tpu_torch.light import verifier as light_verifier
from cometbft_tpu_torch.proto.gogo import Timestamp
from cometbft_tpu_torch.proto.keys import pub_key_to_proto
from cometbft_tpu_torch.proxy import new_app_conns
from cometbft_tpu_torch.state import execution as state_execution
from cometbft_tpu_torch.state import make_genesis_state
from cometbft_tpu_torch.state.store import Store as StateStore
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.proto.version import BLOCK_PROTOCOL, ConsensusVersion
from cometbft_tpu_torch.types.block import (
    BLOCK_ID_FLAG_COMMIT,
    BlockID,
    Commit,
    CommitSig,
    Header,
    PartSetHeader,
)
from cometbft_tpu_torch.types.evidence import DuplicateVoteEvidence, LightClientAttackEvidence
from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from cometbft_tpu_torch.types.light_block import LightBlock, SignedHeader
from cometbft_tpu_torch.types.part_set import BLOCK_PART_SIZE_BYTES
from cometbft_tpu_torch.types.tx import Txs
from cometbft_tpu_torch.types.validator import Validator
from cometbft_tpu_torch.types.validator_set import Fraction, ValidatorSet
from cometbft_tpu_torch.types.vote import SIGNED_MSG_TYPE_PRECOMMIT, Vote
from cometbft_tpu_torch.types.vote_set import VoteSet

SEED = 20261017
N_VALIDATORS = 180  # Cosmos Hub x/staking max_validators
BIG_BATCH = 16384  # ~91 commits of 180, as in blocksync
SR_WINDOW = 8192  # one full sr25519 chunk (the reference's _MAX_CHUNK); host merlin ~3 ms a lane
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
# SHA-512 on 64-bit words, each 64-bit add, xor, logic op or rotate two
# 32-bit instructions: a round 40 (3 rotates and 2 xors per sigma, ch,
# maj, 5 adds), a schedule word 26, the feed-forward 16, and 6 per byte to
# assemble the block from the wire and the message plane.
SHA512_BLOCK_OPS = 80 * 40 + 64 * 26 + 16 + 128 * 6
# the same block read as 16 pre-padded hi/lo word pairs (two loads, a shift
# and an or each) on the word wire
SHA512_WORDS_BLOCK_OPS = 80 * 40 + 64 * 26 + 16 + 16 * 4
# sc_reduce: 24 limb reads of 8, 14 folds of 6 64-bit multiply-adds (6
# each), 46 carries of 8, 12 limbs packed at 6.
SC_REDUCE_OPS = 24 * 8 + 14 * 6 * 6 + 46 * 8 + 12 * 6
# GF(2^256 - 2^32 - 977) in ten 26-bit limbs (fe256k1.cuh), 64-bit operations
# counted as two: fe_reduce carries 19 columns into digits (5 each), folds
# digits 10..19 down (two multiply-adds each), and runs two carry passes;
# a uint32 carry pass is 9 steps of shift, add and mask plus the fold;
# fe_canonical is two such passes and a 10-limb borrow chain with select.
K1_REDUCE_OPS = 19 * 5 + 10 * 2 * 2 + 2 * (9 * 5 + 10)
K1_MUL_OPS = 2 * 100 + K1_REDUCE_OPS  # 100 products
K1_SQ_OPS = 2 * 55 + 10 + K1_REDUCE_OPS  # 55 products, 10 doublings
K1_CARRY32_OPS = 9 * 3 + 8
K1_ADD_OPS = 10 + K1_CARRY32_OPS  # fe_add, fe_mul_small
K1_SUB_OPS = 20 + K1_CARRY32_OPS
K1_CANONICAL_OPS = 2 * K1_CARRY32_OPS + 10 * 4 + 10
SECP_FIRST_DESIGN_OPS = 1968574  # the one-thread design of secp256k1_verify (PERF.md §6)

ED_SOURCE = "cometbft_tpu_torch/crypto/cuda/csrc/ed25519_verify.cu"
RESIDENT_SOURCE = "cometbft_tpu_torch/crypto/cuda/csrc/ed25519_resident.cu"
KERNELS = {
    "ed25519_verify_compact": (ED_SOURCE, "cometbft_tpu/crypto/tpu/ed25519_batch.py:338"),
    "ed25519_verify_resident": (RESIDENT_SOURCE, "cometbft_tpu/crypto/tpu/ed25519_batch.py:805"),
    # no device program of the reference: it takes the decompression and
    # table of every resident call (:805) to the set's upload (:867)
    "ed25519_key_tables": (RESIDENT_SOURCE, "cometbft_tpu/crypto/tpu/ed25519_batch.py:867"),
    "ed25519_verify_full_compact": (ED_SOURCE, "cometbft_tpu/crypto/tpu/ed25519_batch.py:370"),
    "sha256_blocks": (
        "cometbft_tpu_torch/crypto/cuda/csrc/sha256.cu",
        "cometbft_tpu/crypto/tpu/sha256_pallas.py:30",
    ),
    "merkle_level": (
        "cometbft_tpu_torch/crypto/cuda/csrc/merkle.cu",
        "cometbft_tpu/crypto/tpu/merkle.py:103",
    ),
    "merkle_tree": (
        "cometbft_tpu_torch/crypto/cuda/csrc/merkle.cu",
        "cometbft_tpu/crypto/tpu/merkle.py:141",
    ),
    "secp256k1_verify": (
        "cometbft_tpu_torch/crypto/cuda/csrc/secp256k1_verify.cu",
        "cometbft_tpu/crypto/tpu/secp256k1_batch.py:179",
    ),
    "sr25519_verify": (
        "cometbft_tpu_torch/crypto/cuda/csrc/sr25519_verify.cu",
        "cometbft_tpu/crypto/tpu/sr25519_batch.py:88",
    ),
    "ed25519_verify_words": (ED_SOURCE, "cometbft_tpu/crypto/tpu/ed25519_batch.py:328"),
    "ed25519_verify_full_words": (ED_SOURCE, "cometbft_tpu/crypto/tpu/ed25519_batch.py:351"),
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
    ed25519_batch.RESIDENT_LAUNCHES = 0
    ed25519_batch.TABLE_LAUNCHES = 0
    ed25519_batch.FULL_LAUNCHES = 0
    sha256.LAUNCHES = 0
    merkle.LAUNCHES = 0
    merkle.TREE_LAUNCHES = 0
    secp256k1_batch.LAUNCHES = 0
    sr25519_batch.LAUNCHES = 0
    ed25519_batch.WORDS_LAUNCHES = 0
    ed25519_batch.FULL_WORDS_LAUNCHES = 0


def counts() -> dict:
    return {
        "ed25519_verify_compact": ed25519_batch.LAUNCHES,
        "ed25519_verify_resident": ed25519_batch.RESIDENT_LAUNCHES,
        "ed25519_key_tables": ed25519_batch.TABLE_LAUNCHES,
        "ed25519_verify_full_compact": ed25519_batch.FULL_LAUNCHES,
        "sha256_blocks": sha256.LAUNCHES,
        "merkle_level": merkle.LAUNCHES,
        "merkle_tree": merkle.TREE_LAUNCHES,
        "secp256k1_verify": secp256k1_batch.LAUNCHES,
        "sr25519_verify": sr25519_batch.LAUNCHES,
        "ed25519_verify_words": ed25519_batch.WORDS_LAUNCHES,
        "ed25519_verify_full_words": ed25519_batch.FULL_WORDS_LAUNCHES,
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


def run_ms(fn, runs: int = 20) -> float:
    """CUDA-event time of ``runs`` calls of fn launched back to back (no
    synchronisation between them), over ``runs``, after a warm-up: the
    card's time a call where it runs longer than the host takes to
    launch it, else the host's launch rate. cuda_ms's single call also
    counts the host's time to reach the launch."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def plain_timed(plain, runs: int):
    """(output, median CUDA-event ms) of ``runs`` calls of a plain version;
    the first call's output is the one checked, so a plain version, which
    takes seconds, is not run once more just for the check."""
    out, times = None, []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = plain()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        out = got if out is None else out
    return out, statistics.median(times)


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


def straus25519_counts():
    """(squarings, products, sums) of the joint Straus core that the
    Ed25519 and sr25519 kernels share: −A's X and T, the base points' T,
    2B, 3B, −2A, −3A, the 16-entry table and 127 steps of two doublings
    and one cached addition (fe25519.cuh)."""
    dbl = (4, 4, 8)  # squarings, products, sums of ge_dbl
    add_cached = (0, 8, 6)
    to_cached = (0, 1, 3)
    ge_add = tuple(a + b for a, b in zip(to_cached, add_cached))
    setup = tuple(2 * d + 2 * a for d, a in zip(dbl, ge_add))  # 2B, 3B, -2A, -3A
    setup = (setup[0], setup[1] + 2, setup[2] + 1)  # the T of B and -A, -A's X
    table = tuple(9 * a + 16 * c for a, c in zip(ge_add, to_cached))
    loop = tuple(127 * (2 * d + a) for d, a in zip(dbl, add_cached))
    return tuple(setup[k] + table[k] + loop[k] for k in range(3))


def curve25519_ops(extra, canonical: int) -> int:
    """32-bit integer instructions of a lane: the Straus core plus
    ``extra`` (squarings, products, sums) and ``canonical`` reductions,
    plus the 127 digit reads of each scalar."""
    sq, mul, add = (c + e for c, e in zip(straus25519_counts(), extra))
    return sq * FE_SQ_OPS + mul * FE_MUL_OPS + add * FE_ADD_OPS + canonical * FE_CANONICAL_OPS + 127 * 8


def ed25519_core_ops_per_lane() -> int:
    """32-bit integer instructions that one lane of the first design's core
    (verify_core: the compact, full-compact and two word kernels) needs at
    least, whatever its data (the loop has no early exit), from the field
    operations it runs (ed25519_verify.cu, fe25519.cuh). The least work of
    a lane: the bound counts it."""
    decompress = (4 + 251, 7 + 11, 4)  # with fe_pow_p58
    final = (254, 11 + 2, 0)  # fe_invert, then x and y
    return curve25519_ops(tuple(d + f for d, f in zip(decompress, final)), 5 + 2)


# ge25519_group.cuh: a select of one field element (10 limbs), a shuffle of
# one (10 words), a sum not carried (gaddsub), one parallel carry pass
# (carry_once) and two on 64-bit column sums (carry_wide), and the products
# and squarings carried so (gmul, gsq)
FE_SEL_OPS = 10
SHFL_FE_OPS = 10
FE_LAZY_OPS = 20
CARRY_ONCE_OPS = 10 * 3
CARRY_WIDE_OPS = 10 * 5 + 10 * 4
G_MUL_OPS = 2 * 100 + 20 + CARRY_WIDE_OPS
G_SQ_OPS = 2 * 55 + 21 + CARRY_WIDE_OPS
G_SUB2_OPS = 30 + CARRY_ONCE_OPS


def lazy_straus_ops() -> int:
    """Instructions of straus_one (ge25519_group.cuh), the loop that G = 1
    runs: the first design's table and 127 steps with the sums that feed
    only products left uncarried, and the digit reads."""
    dbl = 4 * FE_SQ_OPS + 4 * FE_MUL_OPS + 10 + CARRY_ONCE_OPS + 10 + 3 * G_SUB2_OPS + FE_LAZY_OPS
    add = 8 * FE_MUL_OPS + 6 * FE_LAZY_OPS
    to_cached = FE_MUL_OPS + 3 * FE_ADD_OPS
    table = 2 * dbl + 11 * (to_cached + add) + 16 * to_cached + 2 * FE_MUL_OPS
    return table + 127 * (2 * dbl + add + 8)


def ed25519_core_g1_ops_per_lane() -> int:
    """A lane of the four Ed25519 wire-key kernels at G = 1: A's
    decompression, straus_one, then R's decompression and checks (5
    canonical forms) and the projective compare (2 products, 2
    comparisons) in place of the inversion and the encode. The least work
    of a lane: the bound counts it (the first design's in brackets)."""
    return lazy_straus_ops() + fe25519_ops([(ED_DECOMPRESS, 2), ((0, 2, 0), 1)], 3 + 5 + 4)


def sr25519_g1_ops_per_lane() -> int:
    """A lane of sr25519_verify at G = 1: two ristretto255 decodes and the
    check (as sr25519_ops_per_lane counts them) around straus_one."""
    decode = (5 + 251, 16 + 11, 6)
    return lazy_straus_ops() + fe25519_ops([(decode, 2), ((0, 4, 0), 1)], 2 * 10 + 4) + 2 * FE_MUL_OPS


def group_dbl_ops(n: int) -> int:
    """Instructions of one thread of dbl_group (ge25519_group.cuh) holding
    n of a point's four coordinates: the shuffles of X and Y and their sum,
    n squarings, the four gathers, n products of two operands each."""
    return (2 * SHFL_FE_OPS + 10 + CARRY_ONCE_OPS + n * (FE_SEL_OPS + G_SQ_OPS + 10) + 4 * SHFL_FE_OPS
            + n * (6 * FE_SEL_OPS + 2 * G_SUB2_OPS + G_MUL_OPS))


def core_group_thread_ops(group: int) -> int:
    """32-bit integer instructions (a shuffle counted as one) of one thread
    of a lane's group at ``group`` = 2 or 4 threads a lane, each taking
    4 / group of a point's coordinates (ge25519_group.cuh): A's
    decompression, variable_base (the table of j (-A), 14 additions, then
    64 windows of four doublings and one addition) and finish_group (the
    addition of [s]B, the gathers). Every thread of the group runs as many:
    at G = 4 this is the lane's critical chain."""
    n = 4 // group
    dbl = group_dbl_ops(n)
    add = (2 * SHFL_FE_OPS + n * (FE_LAZY_OPS + FE_SEL_OPS + G_MUL_OPS) + 4 * SHFL_FE_OPS
           + n * (4 * FE_SEL_OPS + 2 * FE_LAZY_OPS + G_MUL_OPS))
    cache = 2 * SHFL_FE_OPS + n * (2 * FE_LAZY_OPS + 3 * FE_SEL_OPS + G_MUL_OPS + 10)
    load = n * 10
    table = 2 * cache + G_MUL_OPS + load + 14 * (add + cache)
    loop = 64 * (load + 4 * dbl + add + 8)
    return fe25519_ops([(ED_DECOMPRESS, 1)], 3) + table + loop + load + add + 3 * SHFL_FE_OPS


def core_fixed_base_ops() -> int:
    """Instructions of the thread beside a lane's group (the R warp's):
    R's decompression and checks, then fixed_base's [s]B by B's comb
    tables (15 doublings, 64 additions of a loaded Niels entry) and its
    cached form."""
    return (fe25519_ops([(ED_DECOMPRESS, 1), (GE_DBL, 15), (GE_MADD, 64), ((0, 1, 3), 1)], 5)
            + 64 * (8 * 4 + 4 * 3))


# (squarings, products, sums) of the point operations of ed25519_resident.cu
GE_DBL = (4, 4, 8)
GE_DBL_XYZ = (4, 3, 8)
GE_MADD = (0, 7, 7)
GE_ADD = (0, 1 + 8, 3 + 6)  # ge_to_cached, then ge_add_cached
ED_DECOMPRESS = (4 + 251, 7 + 11, 4)  # fe_pow_p58 and its checks; 3 canonical forms


def fe25519_ops(parts, canonical: int) -> int:
    """Instructions of a list of ((squarings, products, sums), times)."""
    sq, mul, add = (sum(c[k] * n for c, n in parts) for k in range(3))
    return sq * FE_SQ_OPS + mul * FE_MUL_OPS + add * FE_ADD_OPS + canonical * FE_CANONICAL_OPS


def ed25519_resident_ops_per_lane(group: int) -> int:
    """32-bit integer instructions of one lane of ed25519_verify_resident
    at ``group`` threads a lane, whatever its data: the comb's 128 table
    additions (16 columns, 4 slices, 2 scalars), 15 doublings in each of
    the G threads' chains, G·log2 G additions in the butterfly that sums
    them, R's decompression and checks (5 canonical forms), the projective
    compare (2 products, 2 comparisons), and 256 digits of 4 bit reads."""
    levels = group.bit_length() - 1
    parts = [(GE_MADD, 128), (GE_DBL, 15 * group), (GE_ADD, group * levels), (ED_DECOMPRESS, 1), ((0, 2, 0), 1)]
    return fe25519_ops(parts, 5 + 4) + 256 * 4 * 3


def ed25519_key_table_ops_per_key() -> int:
    """32-bit integer instructions of the comb tables of one key at one
    thread a key (the least work, which the bound counts): decompress A,
    negate it, 240 doublings to 2^240·(−A) (T computed only at the 15
    multiples of 2^16 kept), 44 additions for the 64 entries, one batch
    inversion (63 + 126 products and fe_invert) and, per entry, 4
    products, 2 sums and 3 canonical forms."""
    parts = [(ED_DECOMPRESS, 1), ((0, 1, 1), 1), (GE_DBL, 15), (GE_DBL_XYZ, 225), (GE_ADD, 44),
             ((254, 11 + 189, 0), 1), ((0, 4, 2), 64)]
    return fe25519_ops(parts, 3 + 3 * 64)


def ed25519_key_table_kernel_ops() -> tuple:
    """(one chain thread, one helper thread at most, the whole key) in
    32-bit integer instructions as ed25519_key_tables runs a key: four
    threads each decompress A and run the 240 doublings split by
    coordinate (ge25519_group.cuh's dbl_group<4>, storing 16 bases); eight
    helpers run the 44 additions, the prefix products of their entries'
    Z (52), the products of the other helpers' totals (7 each), helper 0
    the key's product and fe_invert, and each helper the walk back (2
    products an entry but its first) and the conversion (4 products, 2
    sums, 3 canonical forms an entry). The chain thread's count is the
    key's critical chain up to the last base."""
    chain = fe25519_ops([(ED_DECOMPRESS, 1), ((0, 1, 1), 1)], 3) + 240 * group_dbl_ops(1) + 16 * 10
    helpers = fe25519_ops([(GE_ADD, 44), ((0, 52 + 8 * 7 + 1 + 8 + 2 * 52, 0), 1), ((254, 11, 0), 1),
                           ((0, 4, 2), 60)], 3 * 60)
    worst = fe25519_ops([(GE_ADD, 8), ((0, 7 + 7 + 1 + 1 + 2 * 7, 0), 1), ((254, 11, 0), 1), ((0, 4, 2), 8)], 3 * 8)
    return chain, worst, 4 * chain + helpers


def sr25519_ops_per_lane() -> int:
    """32-bit integer instructions that one lane of sr25519_verify needs at
    least: two ristretto255 decodes (each 5 squarings and fe_pow_p58's 251,
    27 products with its 11, 6 sums, 10 canonical forms; the data-dependent
    product by sqrt(-1) and negations not counted), the Straus core, and
    the check's four products and two comparisons (sr25519_verify.cu)."""
    decode = (5 + 251, 16 + 11, 6)
    check_ = (0, 4, 0)
    return curve25519_ops(tuple(2 * d + c for d, c in zip(decode, check_)), 2 * 10 + 4)


def secp256k1_ops_per_lane(group: int) -> int:
    """32-bit integer instructions of one lane of secp256k1_verify at
    ``group`` threads a lane, whatever its data (no early exit), from the
    field operations it runs (secp256k1_verify.cu, fe256k1.cuh): the GLV
    split and recoding; Q's square root and its 0..8 table in each thread
    that holds a Q term (two, or one at G = 1); 32 windows of four
    doublings in each of the G chains; the four terms' 132 additions, the
    33 products by β and 132 negations; G·log2 G additions to combine;
    the final check."""
    dbl = {"sq": 2, "mul": 6, "small": 1, "add": 8, "sub": 1}  # pt_dbl
    add = {"sq": 0, "mul": 12, "small": 2, "add": 14, "sub": 5}  # pt_add
    q_threads = 1 if group == 1 else 2
    decompress = {"sq": 1 + 253 + 1, "mul": 1 + 13, "add": 1, "sub": 1, "canonical": 3}
    final = {"mul": 2, "add": 1, "canonical": 5}
    levels = group.bit_length() - 1
    n_dbl = q_threads * 4 + 32 * 4 * group
    n_add = q_threads * 3 + 4 * 33 + group * levels
    extra = {"mul": 33, "sub": 4 * 33}  # λQ's X times β, each entry's negated y
    cost = {"sq": K1_SQ_OPS, "mul": K1_MUL_OPS, "small": K1_ADD_OPS, "add": K1_ADD_OPS,
            "sub": K1_SUB_OPS, "canonical": K1_CANONICAL_OPS}
    total = sum(cost[k] * (n_dbl * dbl.get(k, 0) + n_add * add.get(k, 0) + q_threads * decompress.get(k, 0)
                           + final.get(k, 0) + extra.get(k, 0)) for k in cost)
    split = 2 * 64 + 16 + 20 + 16 + 16  # the split's 32x32->64 multiply-adds
    return total + split * 4 + 4 * 33 * 6  # and the recoding of four scalars


def live_sha512_blocks(mlen: np.ndarray) -> int:
    """SHA-512 blocks of R || A || M summed over the lanes: what this
    run's messages need, not the plane's capacity."""
    return int(((64 + mlen.astype(np.int64) + 17 + 127) // 128).sum())


# --- phase 2: kernels against their plain versions --------------------------


def r_wire_lanes():
    """The compact wire u8[128, n] of ``vectors.resident_r_cases`` (every
    way R can fail the projective compare, each with its key, s and h)
    and their verdicts."""
    r_cases = vectors.resident_r_cases()
    return vectors.wire_rows(r_cases), [c[5] for c in r_cases]


def as_words(wire: np.ndarray) -> np.ndarray:
    """A compact wire u8[128, B] as the word wire u32[32, B]."""
    return np.ascontiguousarray(np.ascontiguousarray(wire.T).view("<u4").T)


def launch_group(name: str, group: int, out: torch.Tensor, *args) -> None:
    """One launch of a wire-key core kernel at ``group`` threads a lane,
    through its C entry point (args: its pointers and ints before B), on
    the current stream; counts no launch."""
    libs = {"ed25519_verify_compact": (ed25519_batch._lib, "cbt_ed25519_verify_compact"),
            "sr25519_verify": (lambda: build.load("sr25519_verify", sr25519_batch._SIGNATURES), "cbt_sr25519_verify")}
    lib, fn = libs[name]
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    base = ed25519_batch.core_base(group, out.device)
    build.check(getattr(lib(), fn)(*ptrs, base, out.data_ptr(), out.shape[0], group, build.stream_ptr(out.device)), name)


def check_ed25519(dev) -> int:
    """ed25519_verify_compact == its plain version == the CPU verifier on
    the edge cases, a mixed batch, the R cases as signatures and as wire
    lanes, and the same lanes tiled to 6,000 at 2 threads a lane."""
    cases = vectors.edge_cases(SEED) + vectors.mixed_batch(33, SEED) + vectors.r_signature_cases()
    wire, valid = ed25519_batch.prepare_batch_compact(
        [c[1] for c in cases], [c[2] for c in cases], [c[3] for c in cases]
    )
    r_wire, r_want = r_wire_lanes()
    wire = np.concatenate([wire, r_wire], axis=1)
    valid = np.concatenate([valid, np.ones(len(r_want), bool)])
    wire_t = torch.from_numpy(wire).to(dev)
    got = ed25519_batch.verify_kernel_compact(wire_t)
    torch.cuda.synchronize()
    plain = ed25519_batch.verify_compact_plain(wire_t)
    err = max_abs_err(got, plain)
    check(err == 0, "ed25519 kernel disagrees with its plain version")
    cpu = [purepy.ed25519_verify(c[1], c[2], c[3]) for c in cases] + r_want
    check(list(got.cpu().numpy() & valid) == cpu, "ed25519 kernel disagrees with the CPU verifier")
    big = 6000
    lanes = np.arange(big) % wire.shape[1]
    (w_big,) = to_dev(dev, wire[:, lanes])
    out = torch.empty(big, dtype=torch.uint8, device=dev)
    launch_group("ed25519_verify_compact", 2, out, w_big)
    torch.cuda.synchronize()
    err = max(err, max_abs_err(out.bool(), ed25519_batch.verify_compact_plain(w_big)))
    check(err == 0 and out.bool().cpu().numpy().tolist() == got.cpu().numpy()[lanes].tolist(),
          "ed25519_verify_compact at 6,000 lanes, 2 threads a lane, disagrees")
    groups = [ed25519_batch.core_group(b, dev) for b in (wire.shape[1], big)]
    print(f"kernels: ed25519 {len(cases)} lanes and {len(r_want)} R wire lanes ({sum(cpu)} accepted) == plain == cpu, "
          f"B={big} at G=2 == plain; the rule's threads a lane {groups}, max_abs_err {err}")
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


def check_merkle(dev) -> dict:
    """merkle_tree (through ValidatorSet's route, hash_from_byte_slices on
    the card, and called on the same leaf tensors as its plain version)
    against its plain version and the host tree; merkle_level's levels
    against theirs. n = 1025 and 4,097 take merkle_tree's scratch buffer
    (levels of more than the 1,024 nodes of its shared memory)."""
    rng = np.random.default_rng(SEED + 1)
    errs = {"merkle_tree": 0, "merkle_level": 0}
    sizes = (1, 2, 3, 5, 180, 1025, 4097)
    for n in sizes:
        items = [rng.bytes(int(rng.choice([54, 55, int(rng.integers(1, 90))]))) for _ in range(n)]
        want = host_merkle.hash_from_byte_slices(items)
        before = merkle.TREE_LAUNCHES
        got = merkle.hash_from_byte_slices(items, device=dev)
        check(merkle.TREE_LAUNCHES == before + 1, f"the card's root at n={n} did not take one merkle_tree launch")
        plain = merkle.hash_from_byte_slices(items, device="cpu")
        check(got == want == plain, f"merkle root differs at n={n}")
        blocks_np, n_live_np = sha256.pad_ragged_np(items, prefix=merkle.LEAF_PREFIX)
        blocks, n_live = sha256.from_u32(blocks_np, dev), torch.from_numpy(n_live_np).to(dev)
        root = merkle.merkle_tree(blocks, n_live)
        torch.cuda.synchronize()
        errs["merkle_tree"] = max(errs["merkle_tree"], max_abs_err(root, merkle.merkle_tree_plain(blocks, n_live)))
        digests = sha256.from_u32(
            rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32), dev
        )
        lvl = merkle.merkle_level(digests)
        lvl_plain = merkle.merkle_level_plain(digests)
        errs["merkle_level"] = max(errs["merkle_level"], max_abs_err(lvl, lvl_plain))
    check(errs["merkle_tree"] == 0, "merkle_tree kernel disagrees with its plain version")
    check(errs["merkle_level"] == 0, "merkle_level kernel disagrees with its plain version")
    print(f"kernels: merkle_tree roots n in {sizes} == plain == host tree, one launch each; merkle_level levels "
          f"== plain; max_abs_err {errs}")
    return errs


def secp_cpu(pks, msgs, sigs):
    """The CPU verifier's verdicts; a key that is not 33 bytes rejects."""
    return [len(p) == 33 and secp.PubKeySecp256k1(p).verify_signature(m, s) for p, m, s in zip(pks, msgs, sigs)]


def check_secp(dev) -> int:
    """secp256k1_verify == its plain version on the card == the CPU
    verifier on the contract's cases and 40 mixed lanes, the wire-level
    r + n, infinity and partial-sum lanes give their verdicts, and the
    same lanes tiled to 6,000 (2 threads a lane) equal the plain version."""
    cases, wire_cases = vectors.secp256k1_cases(SEED)
    cases += vectors.secp256k1_mixed(40, SEED)
    pks, msgs, sigs = [c[1] for c in cases], [c[2] for c in cases], [c[3] for c in cases]
    wire, flags, valid = secp256k1_batch.prepare_batch(pks, msgs, sigs)
    w_wire, w_flags, w_want = vectors.secp256k1_wire(wire_cases)
    all_wire, all_flags = np.concatenate([wire, w_wire], axis=1), np.concatenate([flags, w_flags])
    w_t, f_t = to_dev(dev, all_wire, all_flags)
    got = secp256k1_batch.verify_kernel(w_t, f_t)
    torch.cuda.synchronize()
    err = max_abs_err(got, secp256k1_batch.verify_plain(w_t, f_t))
    check(err == 0, "secp256k1_verify disagrees with its plain version")
    got = got.cpu().numpy()
    cpu = secp_cpu(pks, msgs, sigs)
    check((got[:len(cases)] & valid).tolist() == cpu, "secp256k1_verify disagrees with the CPU verifier")
    check(got[len(cases):].tolist() == w_want, f"secp256k1_verify wire-level lanes: {got[len(cases):].tolist()} != {w_want}")
    big = 6000
    lanes = np.arange(big) % all_wire.shape[1]
    w_t, f_t = to_dev(dev, all_wire[:, lanes], all_flags[lanes])
    got_big = secp256k1_batch.verify_kernel(w_t, f_t)
    torch.cuda.synchronize()
    err = max(err, max_abs_err(got_big, secp256k1_batch.verify_plain(w_t, f_t)))
    check(err == 0 and got_big.cpu().numpy().tolist() == got[lanes].tolist(), "secp256k1_verify at 6,000 lanes disagrees")
    groups = [build.group_size(b, dev, secp256k1_batch.GROUP_THREADS_PER_SM) for b in (all_wire.shape[1], big)]
    print(f"kernels: secp256k1_verify {len(cases)} lanes ({sum(cpu)} accepted) == plain == cpu, "
          f"wire-level lanes {[c[0] for c in wire_cases]} {w_want}, B={big} == plain; threads a lane {groups}, "
          f"max_abs_err {err}")
    return err


def sr_cpu(pks, msgs, sigs):
    """The CPU verifier's verdicts; a key that is not 32 bytes rejects."""
    return [len(p) == 32 and sr.PubKeySr25519(p).verify_signature(m, s) for p, m, s in zip(pks, msgs, sigs)]


def check_sr25519(dev) -> int:
    """sr25519_verify == its plain version on the card == the CPU verifier
    on the sr25519 contract's cases and 40 mixed lanes."""
    cases = vectors.sr25519_cases(SEED) + vectors.sr25519_mixed(40, SEED)
    pks, msgs, sigs = [c[1] for c in cases], [c[2] for c in cases], [c[3] for c in cases]
    wire, valid = sr25519_batch.prepare_batch(pks, msgs, sigs)
    (w_t,) = to_dev(dev, wire)
    got = sr25519_batch.verify_kernel(w_t)
    torch.cuda.synchronize()
    err = max_abs_err(got, sr25519_batch.verify_plain(w_t))
    check(err == 0, "sr25519_verify disagrees with its plain version")
    cpu = sr_cpu(pks, msgs, sigs)
    check((got.cpu().numpy() & valid).tolist() == cpu, "sr25519_verify disagrees with the CPU verifier")
    big = 6000
    lanes = np.arange(big) % wire.shape[1]
    (w_big,) = to_dev(dev, wire[:, lanes])
    out = torch.empty(big, dtype=torch.uint8, device=dev)
    launch_group("sr25519_verify", 2, out, w_big)
    torch.cuda.synchronize()
    err = max(err, max_abs_err(out.bool(), sr25519_batch.verify_plain(w_big)))
    check(err == 0 and out.bool().cpu().numpy().tolist() == got.cpu().numpy()[lanes].tolist(),
          "sr25519_verify at 6,000 lanes, 2 threads a lane, disagrees")
    groups = [sr25519_batch.core_group(b, dev) for b in (wire.shape[1], big)]
    print(f"kernels: sr25519_verify {len(cases)} lanes ({sum(cpu)} accepted) == plain == cpu, B={big} at G=2 == plain; "
          f"the rule's threads a lane {groups}, max_abs_err {err}")
    return err


def check_words(dev) -> dict:
    """ed25519_verify_words and ed25519_verify_full_words == their plain
    versions == the CPU verifier on the edge, device-hash (torsioned lanes
    included) and mixed cases."""
    cases, pks, msgs, sigs = edge_columns()
    cpu = [purepy.ed25519_verify(*c[1:]) for c in cases]
    wire, valid = ed25519_batch.prepare_batch(pks, msgs, sigs)
    r_wire, r_want = r_wire_lanes()
    (w_t,) = to_dev(dev, np.concatenate([wire, as_words(r_wire)], axis=1))
    got = ed25519_batch.verify_kernel_words(w_t)
    torch.cuda.synchronize()
    err = max_abs_err(got, ed25519_batch.verify_words_plain(w_t))
    check(err == 0, "ed25519_verify_words disagrees with its plain version")
    check((got.cpu().numpy() & np.concatenate([valid, np.ones(len(r_want), bool)])).tolist() == cpu + r_want,
          "ed25519_verify_words disagrees with the CPU verifier")
    packed = ed25519_batch.prepare_batch_device_hash(pks, msgs, sigs)
    args = to_dev(dev, *packed[:4])
    got = ed25519_batch.verify_kernel_full_words(*args)
    torch.cuda.synchronize()
    err_full = max_abs_err(got, ed25519_batch.verify_full_words_plain(*args))
    check(err_full == 0, "ed25519_verify_full_words disagrees with its plain version")
    check((got.cpu().numpy() & packed[4]).tolist() == cpu, "ed25519_verify_full_words disagrees with the CPU verifier")
    print(f"kernels: ed25519_verify_words and ed25519_verify_full_words ({packed[1].shape[0]} blocks) "
          f"{len(cases)} lanes ({sum(cpu)} accepted), the words kernel {len(r_want)} R wire lanes more, "
          f"== plain == cpu, max_abs_err {err}, {err_full}")
    return {"ed25519_verify_words": err, "ed25519_verify_full_words": err_full}


def to_dev(dev, *arrays):
    return [torch.from_numpy(np.array(a, order="C")).to(dev) for a in arrays]


def edge_columns():
    cases = (vectors.device_hash_cases(SEED) + vectors.edge_cases(SEED) + vectors.mixed_batch(33, SEED)
             + vectors.r_signature_cases())
    return cases, [c[1] for c in cases], [c[2] for c in cases], [c[3] for c in cases]


def edge_keys():
    """The key table kernel's edge keys: y >= p (the identity, y taken mod
    p), -0, a y with no root (flag 0), a torsioned key, all-ones."""
    p = purepy.P
    torsioned = vectors._torsioned_signature(0x1F2E3D4C, b"torsion-", True)[1]
    return [(p + 1).to_bytes(32, "little"), (1 | 1 << 255).to_bytes(32, "little"),
            vectors._no_root_y().to_bytes(32, "little"), torsioned, b"\xff" * 32]


def check_key_tables(dev, vals) -> int:
    """ed25519_key_tables == key_tables_plain on the 180 keys and the edge
    keys, entry for entry; the flags say which keys decompress."""
    keys = [v.pub_key.bytes() for v in vals.validators] + edge_keys()
    arr, _ = keystore.key_rows(keys)
    (rows,) = to_dev(dev, arr)
    got = ed25519_batch.key_tables_kernel(rows)
    torch.cuda.synchronize()
    err = max_abs_err(got, ed25519_batch.key_tables_plain(rows))
    check(err == 0, "ed25519_key_tables disagrees with its plain version")
    flags = got[:, ed25519_batch.FLAG_ROW, 0].cpu().tolist()
    check(flags == [int(purepy.pt_decode(k) is not None) for k in keys], f"ed25519_key_tables flags wrong: {flags[-5:]}")
    (neg_b,) = to_dev(dev, np.frombuffer(ed25519_batch.neg_base_encoding(), np.uint8).reshape(1, 32))
    err = max(err, max_abs_err(ed25519_batch.base_tables(dev), ed25519_batch.key_tables_plain(neg_b)))
    check(err == 0, "the base point's tables differ from their plain version")
    print(f"kernels: ed25519_key_tables {len(keys)} keys ({len(keys) - sum(flags)} that do not decompress) "
          f"and B's tables == plain, {ed25519_batch.KEY_TABLE_BYTES} bytes a key, max_abs_err {err}")
    return err


def check_resident(dev, vals, commit) -> int:
    """The resident kernel over the table kernel's tables at B=180 in lane
    order and by a shuffled index with repeats and one row out of range,
    on the edge vectors and every R case, and at 6,000 lanes by index with
    rows out of range."""
    rng = np.random.default_rng(SEED + 3)
    pks = [v.pub_key.bytes() for v in vals.validators]
    msgs = [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(len(pks))]
    sigs = [cs.signature for cs in commit.signatures]
    pk_arr = np.frombuffer(b"".join(pks), np.uint8).reshape(-1, 32)
    (keys_t,) = to_dev(dev, pk_arr)
    tables = ed25519_batch.key_tables_kernel(keys_t)
    err = 0
    rows = rng.integers(0, len(pks), len(pks)).astype(np.int32)  # repeats
    cases = [("lane order", None, np.arange(len(pks)))]
    oob = rows.copy()
    oob[7] = len(pks) + 3
    cases.append(("shuffled index", oob, rows))
    for label, index, lane_rows in cases:
        rsh, valid = ed25519_batch._prepare_rsh_compact(pk_arr[lane_rows], [msgs[r] for r in lane_rows], [sigs[r] for r in lane_rows])
        (rsh_t,) = to_dev(dev, rsh)
        idx_t = None if index is None else to_dev(dev, index)[0]
        got = ed25519_batch.verify_kernel_resident(tables, idx_t, rsh_t)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, ed25519_batch.verify_resident_plain(tables, idx_t, rsh_t)))
        want = np.ones(len(pks), bool)
        if index is not None:
            want[7] = False
        check((got.cpu().numpy() & valid).tolist() == want.tolist(), f"resident kernel, {label}: wrong verdicts")
    # the edge vectors and the R cases, in lane order
    cases_e, e_pks, e_msgs, e_sigs = edge_columns()
    r_cases = vectors.resident_r_cases()
    e_arr, ok = keystore.key_rows(e_pks + [c[1] for c in r_cases])
    rsh, valid = ed25519_batch._prepare_rsh_compact(e_arr[:len(e_pks)], e_msgs, e_sigs)
    rsh = np.concatenate([rsh, vectors.resident_rows(r_cases)], axis=1)
    valid = np.concatenate([valid, np.ones(len(r_cases), bool)])
    e_keys, rsh_t = to_dev(dev, e_arr, rsh)
    e_tables = ed25519_batch.key_tables_kernel(e_keys)
    got = ed25519_batch.verify_kernel_resident(e_tables, None, rsh_t)
    torch.cuda.synchronize()
    err = max(err, max_abs_err(got, ed25519_batch.verify_resident_plain(e_tables, None, rsh_t)))
    want = [purepy.ed25519_verify(*c[1:]) for c in cases_e] + [c[5] for c in r_cases]
    check((got.cpu().numpy() & valid & ok).tolist() == want, "resident kernel disagrees with the CPU verifier")
    # 6,000 lanes by index into the edge set: the rule gives 2 threads a lane
    big = 6000
    lanes = np.arange(big) % len(want)
    idx = lanes.astype(np.int32)
    idx[::97] = len(e_arr) + 1  # out of range
    idx_t, rsh_big = to_dev(dev, idx, rsh[:, lanes])
    got = ed25519_batch.verify_kernel_resident(e_tables, idx_t, rsh_big)
    torch.cuda.synchronize()
    err = max(err, max_abs_err(got, ed25519_batch.verify_resident_plain(e_tables, idx_t, rsh_big)))
    want_big = np.array(want)[lanes] & (idx < len(e_arr))
    check((got.cpu().numpy() & valid[lanes] & ok[lanes]).tolist() == want_big.tolist(), "resident kernel at 6,000 lanes: wrong verdicts")
    check(err == 0, "ed25519_verify_resident disagrees with its plain version")
    groups = [build.group_size(b, dev, ed25519_batch.GROUP_THREADS_PER_SM) for b in (len(pks), len(want), big)]
    print(f"kernels: ed25519_verify_resident B={len(pks)} lane order and shuffled index (repeats, 1 out of range), "
          f"{len(cases_e)} edge lanes and {len(r_cases)} R lanes == plain == cpu, B={big} by index == plain; "
          f"threads a lane {groups}, max_abs_err {err}")
    return err


def check_full_compact(dev) -> int:
    cases, pks, msgs, sigs = edge_columns()
    wire, msg, mlen, valid = ed25519_batch.prepare_batch_device_hash_compact(pks, msgs, sigs)
    w, m, ml = to_dev(dev, wire, msg, mlen)
    got = ed25519_batch.verify_kernel_full_compact(w, m, ml)
    torch.cuda.synchronize()
    err = max_abs_err(got, ed25519_batch.verify_full_compact_plain(w, m, ml))
    check(err == 0, "ed25519_verify_full_compact disagrees with its plain version")
    cpu = [purepy.ed25519_verify(*c[1:]) for c in cases]
    check((got.cpu().numpy() & valid).tolist() == cpu, "ed25519_verify_full_compact disagrees with the CPU verifier")
    print(f"kernels: ed25519_verify_full_compact {len(cases)} lanes ({sum(cpu)} accepted) == plain == cpu, max_abs_err {err}")
    return err


# --- phase 3: the main path --------------------------------------------------


def make_valset_and_commit(curve=ed, tag=b"cosmoshub-val-%d"):
    """180 validators with keys from ``curve`` (seeded), seeded powers, and
    a commit that every one of them signs."""
    rng = np.random.default_rng(SEED)
    privs = [curve.gen_priv_key_from_secret(tag % i) for i in range(N_VALIDATORS)]
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


def variants(vals, commit):
    """The signed commit, one with a corrupted signature, one under 2/3."""
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
    return {"signed": commit, "corrupted": corrupted, "under_2/3": under}


def commit_calls(vals, block_id, c):
    trust = Fraction(1, 3)
    return {
        "verify_commit": lambda b: vals.verify_commit(CHAIN_ID, block_id, c.height, c, backend=b),
        "verify_commit_light": lambda b: vals.verify_commit_light(CHAIN_ID, block_id, c.height, c, backend=b),
        "verify_commit_light_trusting": lambda b: vals.verify_commit_light_trusting(CHAIN_ID, c, trust, backend=b),
    }


def compare_on_gpu_and_cpu(label, name, fn, per_call):
    """fn(None) (the default backend: the card) and fn("cpu") must give the
    same verdict or error."""
    before = counts()
    t0 = time.perf_counter()
    gpu = outcome(lambda: fn(None))
    gpu_s = time.perf_counter() - t0
    after = counts()
    t0 = time.perf_counter()
    cpu = outcome(lambda: fn("cpu"))
    cpu_s = time.perf_counter() - t0
    check(gpu == cpu, f"{label} {name}: gpu {gpu} != cpu {cpu}")
    per_call[f"{label} {name}"] = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    print(f"main: {label:9s} {name:29s} gpu == cpu: {gpu[0]:35s} host wall gpu {gpu_s * 1e3:.1f} ms, cpu {cpu_s * 1e3:.1f} ms")
    return gpu


def store_stats() -> dict:
    return keystore.default_store().snapshot()["stats"]


def rotated(vals, commit):
    """The set with its first validator replaced by a new key of the same
    power, and the commit with the new validator's signature (the sign
    bytes of a commit do not depend on the signer)."""
    new_key = ed.gen_priv_key_from_secret(b"cosmoshub-val-rotated")
    old = vals.validators[0]
    rot = ValidatorSet(
        [Validator.new(v.pub_key, v.voting_power) for v in vals.validators[1:]]
        + [Validator.new(new_key.pub_key(), old.voting_power)]
    )
    by_addr = {cs.validator_address: cs for cs in commit.signatures}
    c = Commit(height=commit.height, round=commit.round, block_id=commit.block_id)
    for v in rot.validators:
        cs = by_addr.get(v.address)
        c.signatures.append(copy.copy(cs) if cs is not None else CommitSig(
            BLOCK_ID_FLAG_COMMIT, v.address, commit.signatures[0].timestamp, b""))
    i_new = next(i for i, v in enumerate(rot.validators) if v.pub_key == new_key.pub_key())
    c.signatures[i_new].signature = new_key.sign(c.vote_sign_bytes(CHAIN_ID, i_new))
    return rot, c


def precommits(vals, commit):
    return [(v.pub_key, commit.vote_sign_bytes(CHAIN_ID, i), commit.signatures[i].signature)
            for i, v in enumerate(vals.validators)]


def flush(items, backend):
    bv = cryptobatch.new_batch_verifier(backend)
    for pk, msg, sig in items:
        bv.add(pk, msg, sig)
    return bv.verify()


def commit_path(vals, block_id, commit, per_call):
    """verify_commit* on the card against "cpu": the resident route, one
    upload then hits; a rotated set misses; ValidatorSet.hash."""
    keystore.default_store().invalidate()
    results = {}
    base = store_stats()
    for label, c in variants(vals, commit).items():
        for name, fn in commit_calls(vals, block_id, c).items():
            results[(label, name)] = compare_on_gpu_and_cpu(label, name, fn, per_call)
    check(results[("signed", "verify_commit")] == ("ok",), "the signed commit did not verify")
    check(results[("corrupted", "verify_commit")][0] == "ValueError", "the corrupted commit verified")
    check(
        results[("under_2/3", "verify_commit")][0] == "ErrNotEnoughVotingPowerSigned",
        "the under-2/3 commit verified",
    )
    st = store_stats()
    uploads, hits = st["uploads"] - base["uploads"], st["hits"] - base["hits"]
    check((uploads, hits) == (1, len(results) - 1), f"resident route: {uploads} uploads and {hits} hits over {len(results)} calls")
    print(f"main: resident route: {uploads} upload, then {hits} hits over {len(results)} verify_commit* calls")
    rot, rot_commit = rotated(vals, commit)
    got = compare_on_gpu_and_cpu("rotated", "verify_commit", commit_calls(rot, block_id, rot_commit)["verify_commit"], per_call)
    check(got == ("ok",), "the rotated set's commit did not verify")
    st2 = store_stats()
    check(st2["uploads"] == st["uploads"] + 1 and st2["misses"] == st["misses"] + 1, "the rotated set did not miss and upload")
    print("main: rotated set (one validator replaced): a miss and a new upload")
    before = counts()
    dev_hash = vals.hash()  # the default device: the card
    per_call["ValidatorSet.hash"] = {k: v - before[k] for k, v in counts().items() if v != before[k]}
    check(per_call["ValidatorSet.hash"] == {"merkle_tree": 1},
          f"ValidatorSet.hash launched {per_call['ValidatorSet.hash']}, not one merkle_tree")
    check(dev_hash == vals.hash(device="cpu"), "ValidatorSet.hash on the card != host tree")
    print(f"main: ValidatorSet.hash on the card == host tree ({dev_hash.hex()[:16]}...)")


def indexed_flush_path(vals, commit, per_call):
    """The 180 precommits flushed by a "gpu" verifier while the set is
    resident: the indexed route."""
    items = precommits(vals, commit)  # the set is resident since the commit path
    base = store_stats()["indexed_dispatches"]
    got = flush(items, None)
    check(got == flush(items, "cpu") == (True, [True] * len(items)), "indexed flush != cpu")
    check(store_stats()["indexed_dispatches"] == base + 1, "the flush did not take the indexed route")
    per_call["indexed flush"] = {k: v for k, v in counts().items() if v}
    print(f"main: indexed flush of {len(items)} precommits == cpu, through the resident key table")
    # the set went up under "cuda"; a verifier built for "cuda:0" finds it
    st = store_stats()
    bv = cryptobatch.GPUBatchVerifier(device="cuda:0")
    for pk, msg, sig in items:
        bv.add(pk, msg, sig)
    check(bv.verify() == (True, [True] * len(items)), "the cuda:0 flush != cpu")
    st2 = store_stats()
    check(st2["uploads"] == st["uploads"] and st2["indexed_dispatches"] == st["indexed_dispatches"] + 1,
          "a cuda:0 flush did not find the set uploaded under cuda")
    print("main: a GPUBatchVerifier(device=\"cuda:0\") flush takes the indexed route with no second upload")


def device_hash_path(vals, block_id, commit, per_call):
    """CBFT_TPU_HASH=device: verify_commit and the indexed flush keep the
    resident kernel and the host hash; with the store emptied the flush
    takes ed25519_verify_full_compact."""
    items = precommits(vals, commit)
    corrupted = variants(vals, commit)["corrupted"]
    os.environ["CBFT_TPU_HASH"] = "device"
    try:
        for label, c in (("signed", commit), ("corrupted", corrupted)):
            compare_on_gpu_and_cpu(f"dh {label}", "verify_commit", commit_calls(vals, block_id, c)["verify_commit"], per_call)
        bad = list(items)
        pk, msg, sig = bad[17]
        bad[17] = (pk, msg, sig[:40] + bytes([sig[40] ^ 1]) + sig[41:])
        want = flush(bad, "cpu")
        check(not want[0] and want[1].count(False) == 1, "the corrupted flush did not fail on cpu")
        before = counts()
        check(flush(bad, None) == want, "indexed flush under CBFT_TPU_HASH=device != cpu")
        after = counts()
        check(after["ed25519_verify_resident"] == before["ed25519_verify_resident"] + 1
              and after["ed25519_verify_full_compact"] == before["ed25519_verify_full_compact"],
              "the indexed flush left the resident kernel under CBFT_TPU_HASH=device")
        keystore.default_store().invalidate()
        before = counts()
        check(flush(bad, None) == want, "device-hash flush != cpu")
        check(counts()["ed25519_verify_full_compact"] == before["ed25519_verify_full_compact"] + 1,
              "the flush did not take ed25519_verify_full_compact")
    finally:
        del os.environ["CBFT_TPU_HASH"]
    per_call["device hash"] = {k: v for k, v in counts().items() if v}
    print(f"main: CBFT_TPU_HASH=device: verify_commit and the indexed flush (host hash) and the full-wire flush of {len(items)} == cpu")


def window_items(vals, commit):
    """BIG_BATCH lanes tiling the commit's precommits, 16 of them with a
    corrupted signature, and the expected mask."""
    base = precommits(vals, commit)
    items = [base[i % len(base)] for i in range(BIG_BATCH)]
    want = [True] * BIG_BATCH
    for lane in range(0, BIG_BATCH, BIG_BATCH // 16):
        pk, msg, sig = items[lane]
        sig = sig[:(lane % 64)] + bytes([sig[lane % 64] ^ 0x08]) + sig[lane % 64 + 1:]
        items[lane] = (pk, msg, sig)
        want[lane] = purepy.ed25519_verify(pk.bytes(), msg, sig)
        check(not want[lane], f"window lane {lane}: the corrupted signature verified on cpu")
    return items, want


def window_path(items, want, per_call):
    """The blocksync window flushed with the key store empty: two
    pipelined chunks of the compact kernel."""
    keystore.default_store().invalidate()
    ok, mask = flush(items, None)
    check(mask == want and not ok, "window mask != expected")
    launched = counts()["ed25519_verify_compact"]
    chunks = -(-BIG_BATCH // mesh.chunk_cap(ed25519_batch.MAX_CHUNK))
    check(launched == chunks == 2, f"window ran as {launched} launches, want 2 chunks")
    per_call["window"] = {k: v for k, v in counts().items() if v}
    print(f"main: window of {BIG_BATCH} lanes == expected mask ({want.count(False)} rejected) in {launched} chunks")


def secp_commit_path(svals, sblock_id, scommit, per_call):
    """verify_commit* of the secp256k1 set on the card against "cpu": the
    add()/verify() protocol, no key-store upload; ValidatorSet.hash."""
    base = store_stats()
    results = {}
    for label, c in variants(svals, scommit).items():
        for name, fn in commit_calls(svals, sblock_id, c).items():
            results[(label, name)] = compare_on_gpu_and_cpu(f"secp {label}", name, fn, per_call)
    check(results[("signed", "verify_commit")] == ("ok",), "the signed secp256k1 commit did not verify")
    check(results[("corrupted", "verify_commit")][0] == "ValueError", "the corrupted secp256k1 commit verified")
    check(results[("under_2/3", "verify_commit")][0] == "ErrNotEnoughVotingPowerSigned",
          "the under-2/3 secp256k1 commit verified")
    check(store_stats()["uploads"] == base["uploads"], "a secp256k1 set took the resident route")
    before = counts()
    dev_hash = svals.hash()
    per_call["secp ValidatorSet.hash"] = {k: v - before[k] for k, v in counts().items() if v != before[k]}
    check(per_call["secp ValidatorSet.hash"] == {"merkle_tree": 1},
          f"secp256k1 ValidatorSet.hash launched {per_call['secp ValidatorSet.hash']}, not one merkle_tree")
    check(dev_hash == svals.hash(device="cpu"), "secp256k1 ValidatorSet.hash on the card != host tree")
    print(f"main: secp256k1 set: {len(results)} verify_commit* calls == cpu with no upload; "
          f"ValidatorSet.hash on the card == host tree ({dev_hash.hex()[:16]}...)")


def mixed_flush_path(vals, block_id, commit, svals, scommit, per_call):
    """The 180 Ed25519 and 180 secp256k1 precommits, interleaved and one of
    each corrupted, in one new_batch_verifier("gpu") flush while the
    Ed25519 set is resident: verdicts in input order, equal to "cpu"."""
    vals.verify_commit(CHAIN_ID, block_id, commit.height, commit)  # the node's commit check: resident
    ed_items, secp_items = precommits(vals, commit), precommits(svals, scommit)
    for batch, lane in ((ed_items, 5), (secp_items, 7)):
        pk, msg, sig = batch[lane]
        batch[lane] = (pk, msg, sig[:9] + bytes([sig[9] ^ 0x40]) + sig[10:])
    items = [it for pair in zip(ed_items, secp_items) for it in pair]
    base = store_stats()
    got = flush(items, None)
    after = store_stats()
    want = flush(items, "cpu")
    check(got == want and want[1].count(False) == 2 and not want[1][10] and not want[1][15],
          "the mixed flush != cpu")
    check(all(type(v) is bool for v in got[1]), "the mixed flush's verdicts are not Python bools")
    check(after["indexed_dispatches"] == base["indexed_dispatches"] + 1 and after["uploads"] == base["uploads"],
          "the mixed flush's Ed25519 lanes did not take the indexed route")
    per_call["mixed flush"] = {k: v for k, v in counts().items() if v}
    print(f"main: mixed flush of {len(ed_items)} Ed25519 (indexed) and {len(secp_items)} secp256k1 "
          f"precommits, interleaved == cpu, in order")


def secp_window_items(svals, scommit):
    """BIG_BATCH secp256k1 lanes tiling the commit's precommits, 16 with a
    corrupted signature, and the expected mask."""
    base = precommits(svals, scommit)
    items = [base[i % len(base)] for i in range(BIG_BATCH)]
    want = [True] * BIG_BATCH
    for lane in range(0, BIG_BATCH, BIG_BATCH // 16):
        pk, msg, sig = items[lane]
        byte = lane % 64
        items[lane] = (pk, msg, sig[:byte] + bytes([sig[byte] ^ 0x08]) + sig[byte + 1:])
        want[lane] = pk.verify_signature(msg, items[lane][2])
        check(not want[lane], f"secp window lane {lane}: the corrupted signature verified on cpu")
    return items, want


def secp_window_path(items, want, per_call):
    """The secp256k1 blocksync window: 4,096-lane chunks (the reference's
    _MAX_CHUNK)."""
    ok, mask = flush(items, None)
    check(mask == want and not ok, "secp window mask != expected")
    launched = counts()["secp256k1_verify"]
    chunks = -(-BIG_BATCH // mesh.chunk_cap(secp256k1_batch.MAX_CHUNK))
    check(launched == chunks == 4, f"secp window ran as {launched} launches, want 4 chunks")
    per_call["secp window"] = {k: v for k, v in counts().items() if v}
    print(f"main: secp window of {BIG_BATCH} lanes == expected mask ({want.count(False)} rejected) in {launched} chunks")


def flip(sig: bytes, byte: int, mask: int) -> bytes:
    return sig[:byte] + bytes([sig[byte] ^ mask]) + sig[byte + 1:]


def lane_columns(items):
    """[(pub key, msg, sig)] → (key bytes, msgs, sigs), as the packings take them."""
    return [it[0].bytes() for it in items], [it[1] for it in items], [it[2] for it in items]


def make_sr_lanes(commit):
    """180 seeded sr25519 keys, key i signing precommit i's vote sign bytes:
    [(pub key, msg, sig)]. sr25519 is no validator key type of the v0.34
    wire, so its lanes reach the card through the batch verifier."""
    keys = [sr.gen_priv_key_from_secret(b"cosmoshub-sr-val-%d" % i) for i in range(N_VALIDATORS)]
    msgs = [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(N_VALIDATORS)]
    return [(k.pub_key(), m, k.sign(m)) for k, m in zip(keys, msgs)]


def sr_flush_path(sr_lanes, per_call):
    """The 180 sr25519 lanes, one corrupted, through new_batch_verifier("gpu")."""
    items = list(sr_lanes)
    pk, msg, sig = items[11]
    items[11] = (pk, msg, flip(sig, 20, 0x04))
    got = flush(items, None)
    want = flush(items, "cpu")
    check(got == want and want[1].count(False) == 1 and not want[1][11], "the sr flush != cpu")
    check(all(type(v) is bool for v in got[1]), "the sr flush's verdicts are not Python bools")
    per_call["sr flush"] = {k: v for k, v in counts().items() if v}
    print(f"main: sr flush of {len(items)} sr25519 lanes (1 corrupted) == cpu")


def three_curve_flush_path(vals, block_id, commit, svals, scommit, sr_lanes, per_call):
    """The 180 Ed25519 precommits (the set resident: indexed), the 180
    secp256k1 precommits and the 180 sr25519 lanes, interleaved and one of
    each corrupted, in one new_batch_verifier("gpu") flush == "cpu", in
    input order."""
    vals.verify_commit(CHAIN_ID, block_id, commit.height, commit)  # the node's commit check: resident
    batches = [precommits(vals, commit), precommits(svals, scommit), list(sr_lanes)]
    for batch, lane in zip(batches, (5, 7, 9)):
        pk, msg, sig = batch[lane]
        batch[lane] = (pk, msg, flip(sig, 9, 0x40))
    items = [it for triple in zip(*batches) for it in triple]
    base = store_stats()
    got = flush(items, None)
    after = store_stats()
    want = flush(items, "cpu")
    bad = [i for i, v in enumerate(want[1]) if not v]
    check(got == want and bad == [3 * 5, 3 * 7 + 1, 3 * 9 + 2], f"the three-curve flush != cpu (cpu rejects {bad})")
    check(all(type(v) is bool for v in got[1]), "the three-curve flush's verdicts are not Python bools")
    check(after["indexed_dispatches"] == base["indexed_dispatches"] + 1 and after["uploads"] == base["uploads"],
          "the three-curve flush's Ed25519 lanes did not take the indexed route")
    per_call["three-curve flush"] = {k: v for k, v in counts().items() if v}
    print(f"main: three-curve flush of {len(items)} lanes (Ed25519 indexed, secp256k1, sr25519), "
          f"interleaved == cpu, in order")


def sr_window_items(sr_lanes):
    """SR_WINDOW sr25519 lanes tiling the 180, 8 with a corrupted signature,
    and the expected mask."""
    items = [sr_lanes[i % len(sr_lanes)] for i in range(SR_WINDOW)]
    want = [True] * SR_WINDOW
    for lane in range(0, SR_WINDOW, SR_WINDOW // 8):
        pk, msg, sig = items[lane]
        items[lane] = (pk, msg, flip(sig, lane % 64, 0x08))
        want[lane] = pk.verify_signature(msg, items[lane][2])
        check(not want[lane], f"sr window lane {lane}: the corrupted signature verified on cpu")
    return items, want


def sr_window_path(items, want, per_call, sr_timing):
    """The sr25519 window: one full chunk. Run once, and timed as it runs
    (host merlin costs seconds a pass): the flush's host wall and its
    packing alone go into ``sr_timing``."""
    real = sr25519_batch.prepare_batch
    packing = []

    def timed_prepare(*args):
        t0 = time.perf_counter()
        out = real(*args)
        packing.append(time.perf_counter() - t0)
        return out

    sr25519_batch.prepare_batch = timed_prepare
    try:
        t0 = time.perf_counter()
        ok, mask = flush(items, None)
        wall = time.perf_counter() - t0
    finally:
        sr25519_batch.prepare_batch = real
    check(mask == want and not ok, "sr window mask != expected")
    launched = counts()["sr25519_verify"]
    check(launched == len(packing) == 1, f"sr window ran as {launched} launches, want 1 chunk")
    sr_timing["window_s"], sr_timing["packing_s"] = wall, sum(packing)
    per_call["sr window"] = {k: v for k, v in counts().items() if v}
    print(f"main: sr window of {SR_WINDOW} lanes == expected mask ({want.count(False)} rejected) in {launched} chunk; "
          f"host wall {wall:.3f} s, of which packing (merlin) {sum(packing):.3f} s")


def words_path(vals, commit, per_call):
    """With the key store emptied, the 180 precommits (one corrupted) under
    CBFT_TPU_WIRE=words take ed25519_verify_words, and with
    CBFT_TPU_HASH=device added ed25519_verify_full_words; both == "cpu"."""
    items = precommits(vals, commit)
    pk, msg, sig = items[23]
    items[23] = (pk, msg, flip(sig, 50, 0x02))
    want = flush(items, "cpu")
    check(not want[0] and want[1].count(False) == 1, "the corrupted words flush did not fail on cpu")
    keystore.default_store().invalidate()
    os.environ["CBFT_TPU_WIRE"] = "words"
    try:
        for hash_env, kernel in (("host", "ed25519_verify_words"), ("device", "ed25519_verify_full_words")):
            os.environ["CBFT_TPU_HASH"] = hash_env
            before = counts()
            got = flush(items, None)
            check(got == want, f"the {kernel} flush != cpu")
            check(all(type(v) is bool for v in got[1]), f"the {kernel} flush's verdicts are not Python bools")
            check(counts()[kernel] == before[kernel] + 1, f"the flush with CBFT_TPU_HASH={hash_env} did not take {kernel}")
    finally:
        del os.environ["CBFT_TPU_WIRE"], os.environ["CBFT_TPU_HASH"]
    per_call["words"] = {k: v for k, v in counts().items() if v}
    print(f"main: CBFT_TPU_WIRE=words flushes of {len(items)} precommits (host hash, then device hash) == cpu")


# --- phase 3: the verify call sites ------------------------------------------

TRUSTING_PERIOD_NS = 14 * 24 * 3600 * 10**9  # two thirds of the Cosmos Hub's 21-day unbonding
MAX_CLOCK_DRIFT_NS = 10 * 10**9  # the light client's default
LIGHT_HEIGHT = 19_999_990  # h; h + 1 and h + LIGHT_STEP follow
LIGHT_STEP = 10
LIGHT_T0 = 1_759_900_000  # h's time, seconds; a block every 6 s


def signers_of(vals):
    """The private key of every validator of the main set, in set order,
    from the seeded secrets of make_valset_and_commit."""
    keys = {}
    for i in range(N_VALIDATORS):
        k = ed.gen_priv_key_from_secret(b"cosmoshub-val-%d" % i)
        keys[k.pub_key().address()] = k
    return [keys[v.address] for v in vals.validators]


def rotated_set(vals, keys, keep, tag):
    """A set that keeps the validators of ``vals`` at positions ``keep``
    (set order) and gives every other seat, with its power, to a new key
    from ``tag``; returns it and its signers in its own order."""
    out, by_addr = [], {}
    for i, (v, k) in enumerate(zip(vals.validators, keys)):
        if i not in keep:
            k = ed.gen_priv_key_from_secret(tag % i)
        out.append(Validator.new(k.pub_key(), v.voting_power))
        by_addr[out[-1].address] = k
    rot = ValidatorSet(out)
    return rot, [by_addr[v.address] for v in rot.validators]


def light_header(height, vals, next_vals, time_s, app=b"cosmoshub-app"):
    return Header(
        version=ConsensusVersion(BLOCK_PROTOCOL, 1),
        chain_id=CHAIN_ID,
        height=height,
        time=Timestamp(time_s, 0),
        last_block_id=BlockID(hashlib.sha256(b"last %d" % height).digest(), PartSetHeader(1, hashlib.sha256(b"lp %d" % height).digest())),
        last_commit_hash=hashlib.sha256(b"lc %d" % height).digest(),
        data_hash=hashlib.sha256(b"data %d" % height).digest(),
        validators_hash=vals.hash(device="cpu"),
        next_validators_hash=next_vals.hash(device="cpu"),
        consensus_hash=hashlib.sha256(b"consensus params").digest(),
        app_hash=app,
        last_results_hash=hashlib.sha256(b"results %d" % height).digest(),
        evidence_hash=hashlib.sha256(b"").digest(),
        proposer_address=vals.validators[0].address,
    )


def sign_header(hdr, vals, keys):
    """The SignedHeader of ``hdr`` with a commit that all of ``vals`` sign
    (``keys`` in set order), each at the header's time."""
    block_id = BlockID(hdr.hash(), PartSetHeader(2, hashlib.sha256(b"parts %d" % hdr.height).digest()))
    commit = Commit(height=hdr.height, round=0, block_id=block_id)
    for v in vals.validators:
        commit.signatures.append(CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, hdr.time, b""))
    for i, k in enumerate(keys):
        commit.signatures[i].signature = k.sign(commit.vote_sign_bytes(CHAIN_ID, i))
    return SignedHeader(hdr, commit)


def power_share(kept, vals):
    return sum(vals.validators[i].voting_power for i in kept) / vals.total_voting_power()


def call_site_world(vals):
    """The light chain (heights h, h + 1 by the main set; h + LIGHT_STEP
    by a set in which 100 of the 180 stay and 80 are replaced; a rival
    h + LIGHT_STEP by a set that keeps too little), and a lunatic attack
    at h + LIGHT_STEP by a third rotation, all signed in pure Python."""
    n = len(vals.validators)
    keep_light = set(range(0, n, 2)) | set(range(1, n // 9, 2))  # 100 of 180 stay, spread over the powers
    keep_few = set(range(n - n // 6, n))  # the 30 smallest
    keep_lunatic = set(range(2 * n // 9, 7 * n // 9))  # 100 from the middle
    check(len(keep_light) == len(keep_lunatic) == n * 5 // 9, "the rotations do not keep 100 of 180")
    check(power_share(keep_few, vals) <= 1 / 3 < power_share(keep_light, vals), "the rotations' power shares")
    check(power_share(keep_lunatic, vals) > 1 / 3, "the lunatic set keeps too little power")
    keys = signers_of(vals)
    rot, rot_keys = rotated_set(vals, keys, keep_light, b"cosmoshub-rotated-%d")
    few, few_keys = rotated_set(vals, keys, keep_few, b"cosmoshub-few-%d")
    lunatic, lunatic_keys = rotated_set(vals, keys, keep_lunatic, b"cosmoshub-lunatic-%d")
    h, hk = LIGHT_HEIGHT, LIGHT_HEIGHT + LIGHT_STEP
    t_h, t_hk = LIGHT_T0, LIGHT_T0 + 6 * LIGHT_STEP
    w = {"vals": vals, "rot": rot, "few": few, "lunatic": lunatic, "keys": keys}
    w["sh_h"] = sign_header(light_header(h, vals, vals, t_h), vals, keys)
    w["sh_h1"] = sign_header(light_header(h + 1, vals, vals, t_h + 6), vals, keys)
    w["sh_hk"] = sign_header(light_header(hk, rot, rot, t_hk), rot, rot_keys)
    w["sh_few"] = sign_header(light_header(hk, few, few, t_hk), few, few_keys)
    sh_lunatic = sign_header(light_header(hk, lunatic, lunatic, t_hk, app=b"lunatic"), lunatic, lunatic_keys)
    w["attack"] = LightClientAttackEvidence(
        conflicting_block=LightBlock(sh_lunatic, lunatic),
        common_height=h,
        byzantine_validators=[v.copy() for v in vals.validators if lunatic.has_address(v.address)],
        total_voting_power=vals.total_voting_power(),
        timestamp=w["sh_h"].header.time,
    )
    w["now"] = Timestamp(t_hk + 30, 0)
    return w


def corrupt_commit_sig(sh, idx):
    bad = copy.deepcopy(sh)
    bad.commit.signatures[idx].signature = flip(bad.commit.signatures[idx].signature, 9, 0x40)
    return bad


def light_calls(w):
    """name -> fn(backend) for each light-client case: the three that
    verify, then the failing ones."""
    vals, rot, now = w["vals"], w["rot"], w["now"]
    adj = (w["sh_h"], w["sh_h1"], vals, TRUSTING_PERIOD_NS)
    non = (w["sh_h"], vals, w["sh_hk"], rot, TRUSTING_PERIOD_NS)
    trust = Fraction(1, 3)
    expired_now = Timestamp(LIGHT_T0 + TRUSTING_PERIOD_NS // 10**9 + 1, 0)
    return {
        "verify_adjacent": lambda b: light_verifier.verify_adjacent(*adj, now, MAX_CLOCK_DRIFT_NS, backend=b),
        "verify_non_adjacent": lambda b: light_verifier.verify_non_adjacent(*non, now, MAX_CLOCK_DRIFT_NS, trust, backend=b),
        "verify, adjacent": lambda b: light_verifier.verify(
            w["sh_h"], vals, w["sh_h1"], vals, TRUSTING_PERIOD_NS, now, MAX_CLOCK_DRIFT_NS, trust, backend=b),
        "verify, non-adjacent": lambda b: light_verifier.verify(*non, now, MAX_CLOCK_DRIFT_NS, trust, backend=b),
        "corrupted signature": lambda b: light_verifier.verify_adjacent(
            w["sh_h"], corrupt_commit_sig(w["sh_h1"], 1), vals, TRUSTING_PERIOD_NS, now, MAX_CLOCK_DRIFT_NS, backend=b),
        "expired": lambda b: light_verifier.verify_adjacent(*adj, expired_now, MAX_CLOCK_DRIFT_NS, backend=b),
        "from the future": lambda b: light_verifier.verify_adjacent(
            *adj, Timestamp(LIGHT_T0 - 5, 0), MAX_CLOCK_DRIFT_NS, backend=b),
        "validators hash": lambda b: light_verifier.verify_adjacent(
            w["sh_h"], w["sh_h1"], rot, TRUSTING_PERIOD_NS, now, MAX_CLOCK_DRIFT_NS, backend=b),
        "too little kept": lambda b: light_verifier.verify_non_adjacent(
            w["sh_h"], vals, w["sh_few"], w["few"], TRUSTING_PERIOD_NS, now, MAX_CLOCK_DRIFT_NS, trust, backend=b),
    }


def light_path(w, per_call):
    """The light client's verifier at 180 validators, under the default
    backend (the card) and "cpu": verdicts and errors equal; the main set
    and the rotated set each uploaded once."""
    base = store_stats()
    got = {name: compare_on_gpu_and_cpu("light", name, fn, per_call) for name, fn in light_calls(w).items()}
    for name in ("verify_adjacent", "verify_non_adjacent", "verify, adjacent", "verify, non-adjacent"):
        check(got[name] == ("ok",), f"light {name} did not verify: {got[name]}")
    want = {
        "corrupted signature": "ErrInvalidHeader", "expired": "ErrOldHeaderExpired",
        "from the future": "ErrInvalidHeader", "validators hash": "ErrInvalidHeader",
        "too little kept": "ErrNewValSetCantBeTrusted",
    }
    for name, err in want.items():
        check(got[name][0] == err, f"light {name}: {got[name]}, want {err}")
    st = store_stats()
    uploads, misses = st["uploads"] - base["uploads"], st["misses"] - base["misses"]
    check((uploads, misses) == (2, 2), f"light: {uploads} uploads, {misses} misses, want 2 and 2 (the main and rotated sets)")
    print(f"main: light: 4 verifications and 5 failures == cpu; 2 uploads (main and rotated sets), "
          f"{st['hits'] - base['hits']} hits")


def preverify_and_add(vals, height, votes, backend):
    """Consensus's batch preverify (reference consensus/state.py:393-442)
    and add_vote: one ``new_batch_verifier(backend, subsystem="consensus")``
    flush over ``votes``, each good one marked ``sig_batch_verified``, then
    add_vote for each into a new VoteSet. Returns (mask, add_vote results,
    the index of the vote at which +2/3 was reached, the VoteSet)."""
    bv = cryptobatch.new_batch_verifier(backend, subsystem="consensus")
    for v in votes:
        bv.add(vals.validators[v.validator_index].pub_key, v.sign_bytes(CHAIN_ID), v.signature)
    _, mask = bv.verify()
    for v, ok in zip(votes, mask):
        if ok:
            v.sig_batch_verified = (CHAIN_ID, vals.validators[v.validator_index].pub_key.bytes())
    vs = VoteSet(CHAIN_ID, height, 0, SIGNED_MSG_TYPE_PRECOMMIT, vals)
    results, reached = [], None
    for i, v in enumerate(votes):
        results.append(vs.add_vote(v))
        if reached is None and vs.has_two_thirds_majority():
            reached = i
    return mask, results, reached, vs


def vote_set_round(vals, commit, backend, conflicting):
    """The 180 precommits of ``commit`` as Votes, after a corrupted copy of
    one, through preverify_and_add; then the conflicting vote. Returns
    (mask, results, the index among the 180 at which +2/3 was reached,
    the conflicting vote's outcome, the VoteSet)."""
    bad = commit.get_vote(17)
    bad.signature = flip(bad.signature, 3, 0x01)
    votes = [bad] + [commit.get_vote(i) for i in range(len(commit.signatures))]
    mask, results, reached, vs = preverify_and_add(vals, commit.height, votes, backend)
    return mask, results, reached - 1, outcome(lambda: vs.add_vote(conflicting)), vs


def conflicting_vote(vals, commit, keys, idx=5):
    v = commit.get_vote(idx)
    v.block_id = BlockID(hashlib.sha256(b"another block").digest(), PartSetHeader(1, hashlib.sha256(b"ap").digest()))
    v.signature = keys[idx].sign(v.sign_bytes(CHAIN_ID))
    return v


def vote_set_path(vals, block_id, commit, keys, per_call):
    """The 180 precommits preverified in one "gpu" flush (the indexed
    route: the set is resident) and added to a VoteSet, against "cpu"; the
    commit it makes equals the signed one and verifies on the card."""
    conflicting = conflicting_vote(vals, commit, keys)
    base = store_stats()
    t0 = time.perf_counter()
    g_mask, g_res, g_reached, g_conf, g_vs = vote_set_round(vals, commit, "gpu", conflicting)
    gpu_s = time.perf_counter() - t0
    st = store_stats()
    check(st["indexed_dispatches"] == base["indexed_dispatches"] + 1 and st["uploads"] == base["uploads"],
          "the preverify flush did not take the indexed route")
    t0 = time.perf_counter()
    c_mask, c_res, c_reached, c_conf, c_vs = vote_set_round(vals, commit, "cpu", conflicting)
    cpu_s = time.perf_counter() - t0
    check((g_mask, g_res, g_reached, g_conf) == (c_mask, c_res, c_reached, c_conf), "vote set: gpu != cpu")
    check(g_mask == [False] + [True] * N_VALIDATORS, "the preverify mask is wrong")
    check(not g_res[0][0] and "invalid signature" in g_res[0][1], f"the corrupted vote was added: {g_res[0]}")
    check(all(r == (True, None) for r in g_res[1:]), "a preverified vote was not added")
    total, acc, want_reached = vals.total_voting_power(), 0, None
    for i, v in enumerate(vals.validators):
        acc += v.voting_power
        if want_reached is None and acc >= total * 2 // 3 + 1:
            want_reached = i
    check(g_reached == want_reached, f"+2/3 at vote {g_reached}, want {want_reached}")
    check(g_conf[0] == "ErrVoteConflictingVotes", f"the conflicting vote: {g_conf}")
    made = g_vs.make_commit()
    check(made.encode() == commit.encode() == c_vs.make_commit().encode(), "make_commit != the signed commit")
    got = compare_on_gpu_and_cpu("vote set", "verify_commit(make_commit)",
                                 lambda b: vals.verify_commit(CHAIN_ID, block_id, made.height, made, backend=b), per_call)
    check(got == ("ok",), "the vote set's commit did not verify")
    print(f"main: vote set: preverify flush of {N_VALIDATORS + 1} (indexed) and {N_VALIDATORS + 1} add_vote == cpu, "
          f"+2/3 at vote {g_reached}, conflicting vote raises, make_commit == signed commit; host wall gpu "
          f"{gpu_s * 1e3:.1f} ms, cpu {cpu_s * 1e3:.1f} ms")


def duplicate_vote_evidence(vals, keys, height):
    votes = []
    for tag in (b"block a", b"block b"):
        bid = BlockID(hashlib.sha256(tag).digest(), PartSetHeader(1, hashlib.sha256(tag + b" parts").digest()))
        v = Vote(type=SIGNED_MSG_TYPE_PRECOMMIT, height=height, round=0, block_id=bid,
                 timestamp=Timestamp(LIGHT_T0, 0), validator_address=vals.validators[3].address, validator_index=3)
        v.signature = keys[3].sign(v.sign_bytes(CHAIN_ID))
        votes.append(v)
    return DuplicateVoteEvidence.new(votes[0], votes[1], Timestamp(LIGHT_T0, 0), vals)


def evidence_path(w, per_call):
    """A lunatic light-client attack (the conflicting block signed by a
    third rotation) passes verify_light_client_attack on the card and on
    "cpu", after its conflicting block's validate_basic (the set's hash on
    the card); a tampered copy fails with the same error; a duplicate vote
    passes verify_duplicate_vote (two serial checks, as the reference's)."""
    vals, ev = w["vals"], w["attack"]
    base = store_stats()
    got = compare_on_gpu_and_cpu("evidence", "conflicting validate_basic",
                                 lambda b: ev.conflicting_block.validate_basic(CHAIN_ID, backend=b), per_call)
    check(got == ("ok",), f"the conflicting block is not well formed: {got}")
    args = (w["sh_h"], w["sh_hk"], vals)
    got = compare_on_gpu_and_cpu("evidence", "verify_light_client_attack",
                                 lambda b: evidence_verify.verify_light_client_attack(ev, *args, backend=b), per_call)
    check(got == ("ok",), f"the lunatic attack did not verify: {got}")
    tampered = copy.deepcopy(ev)
    sigs = tampered.conflicting_block.signed_header.commit.signatures
    i = next(i for i, cs in enumerate(sigs) if vals.has_address(cs.validator_address))
    sigs[i].signature = flip(sigs[i].signature, 20, 0x08)
    got = compare_on_gpu_and_cpu("evidence", "tampered attack",
                                 lambda b: evidence_verify.verify_light_client_attack(tampered, *args, backend=b), per_call)
    check(got[0] == "ValueError" and "wrong signature" in got[1], f"the tampered attack: {got}")
    st = store_stats()
    check(st["uploads"] - base["uploads"] == 1, "the lunatic set was not uploaded once")
    dup = duplicate_vote_evidence(vals, w["keys"], LIGHT_HEIGHT)
    got = outcome(lambda: evidence_verify.verify_duplicate_vote(dup, CHAIN_ID, vals))
    check(got == ("ok",), f"the duplicate vote did not verify: {got}")
    bad = copy.deepcopy(dup)
    bad.vote_b.signature = flip(bad.vote_b.signature, 1, 0x01)
    got = outcome(lambda: evidence_verify.verify_duplicate_vote(bad, CHAIN_ID, vals))
    check(got == ("ValueError", "verifying VoteB: invalid signature"), f"the tampered duplicate vote: {got}")
    print(f"main: evidence: lunatic attack ({len(ev.byzantine_validators)} byzantine) verifies == cpu, a tampered "
          f"copy fails == cpu; the duplicate vote verifies, a tampered one fails")


# --- phase 3: the verify plane -------------------------------------------------

# The healthy round's deadline: long enough for four submitters released
# together to share one flush. A node's is 500 µs, and at that deadline
# the round does not coalesce (time_verify_plane counts its flushes).
PLANE_FLUSH_US = 250_000
PLANE_LANE_BUDGET = 32_768  # the window and the consensus preverify fit one flush


def plane_stats(sched, sup) -> dict:
    """The counters the healthy round holds at zero (and the audits)."""
    m, qos = sup.metrics, sched.queue_snapshot().get("qos", {}).get("classes", {})
    return {
        "trips": faults_total(m.trips), "watchdog_kills": m.watchdog_kills.value(),
        "audit_mismatches": m.audit_mismatches.value(), "audits": m.audits.value(),
        "cpu_routed": m.cpu_routed.value(), "cpu_verdicts": m.cpu_verdicts.value(),
        "failures": m.failures.value(), "scheduler_cpu_fallbacks": sched.metrics.cpu_fallbacks.value(),
        "backpressure_cpu": sched.metrics.backpressure_timeouts.value(),
        "shed": sum(c["sheds"] for c in qos.values()), "dropped": sum(c["drops"] for c in qos.values()),
    }


def faults_total(counter) -> float:
    """A counter summed over its labelled series."""
    return sum(c.value() for c in counter._series())


def build_plane(audit_pct: int, flush_us: int = PLANE_FLUSH_US):
    """One VerifyScheduler over one BackendSupervisor over "gpu", its
    warm-up canary passed; the supervisor's verify_items records each
    flush's origins (subsystem order within the flush)."""
    sup = supervisor.BackendSupervisor(spec="gpu", audit_pct=audit_pct, audit_sync=True, hedge_pct=0)
    sup.warmup_canary()
    wait_until(lambda: faults_total(sup.metrics.probes) >= 1, 120, "the warm-up canary")
    check(sup.state() == supervisor.HEALTHY, f"the warm-up canary left the supervisor {sup.state()}")
    flushes = []
    inner = sup.verify_items

    def recording(items, reason="direct", origins=None, route=None):
        flushes.append([sub for _, sub, _ in origins or []])
        return inner(items, reason=reason, origins=origins, route=route)

    sup.verify_items = recording
    sched = scheduler.VerifyScheduler(spec="gpu", supervisor=sup, flush_us=flush_us, lane_budget=PLANE_LANE_BUDGET)
    sched.start()
    return sched, sup, flushes


def wait_until(cond, timeout_s: float, what: str) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond():
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(0.01)


def call_site_round(w, commit, window, backend, threaded: bool):
    """The four call sites (consensus's preverify and add_vote of the 180
    precommits, blocksync's window flush, the light client's two steps,
    the lunatic attack's verification) on ``backend``: from four threads
    released together, or one after another. Returns {site: outcome}."""
    vals, calls = w["vals"], light_calls(w)
    args = (w["sh_h"], w["sh_hk"], vals)
    sites = {
        "consensus": lambda: vote_set_round(vals, commit, backend, w["conflicting"])[:4],
        "blocksync": lambda: tuple(flush_tagged(window, backend, "blocksync")),
        "light": lambda: (outcome(lambda: calls["verify_adjacent"](backend)),
                          outcome(lambda: calls["verify_non_adjacent"](backend))),
        "evidence": lambda: outcome(lambda: evidence_verify.verify_light_client_attack(w["attack"], *args, backend=backend)),
    }
    if not threaded:
        return {name: fn() for name, fn in sites.items()}
    out, barrier = {}, threading.Barrier(len(sites))

    def run(name, fn):
        barrier.wait()
        try:
            out[name] = fn()
        except Exception as e:  # noqa: BLE001 - reported as the site's outcome
            out[name] = ("raised", type(e).__name__, str(e))

    threads = [threading.Thread(target=run, args=kv, name=f"call-site-{kv[0]}") for kv in sites.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def flush_tagged(items, backend, subsystem):
    bv = cryptobatch.new_batch_verifier(backend, subsystem=subsystem)
    for pk, msg, sig in items:
        bv.add(pk, msg, sig)
    return bv.verify()


def three_curve_items(vals, commit, svals, scommit, sr_lanes):
    """The 180 Ed25519, 180 secp256k1 and 180 sr25519 lanes interleaved,
    one of each corrupted (as three_curve_flush_path)."""
    batches = [precommits(vals, commit), precommits(svals, scommit), list(sr_lanes)]
    for batch, lane in zip(batches, (5, 7, 9)):
        pk, msg, sig = batch[lane]
        batch[lane] = (pk, msg, flip(sig, 9, 0x40))
    return [it for triple in zip(*batches) for it in triple]


def verify_plane_path(w, commit, window, window_want, mixed, per_call):
    """The healthy round: one scheduler over one supervisor over "gpu"
    (100% synchronous audit), the four call sites submitting at once,
    then one three-curve flush; every verdict and error equal to "cpu",
    no fallback of any kind, the consensus request first in its flush,
    fewer flushes than requests."""
    keystore.default_store().invalidate()  # the sets go up again on this path
    sched, sup, flushes = build_plane(audit_pct=100)
    try:
        t0 = time.perf_counter()
        got = call_site_round(w, commit, window, sched, threaded=True)
        round_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got_mixed = flush_tagged(mixed, sched, None)
        mixed_s = time.perf_counter() - t0
        requests = sched.metrics.requests.value()
        dispatches = sched.n_dispatches
        stats = plane_stats(sched, sup)
        state = sup.state()
        reasons = sched.queue_snapshot()["flush_reasons"]
    finally:
        sched.stop()
        sup.stop()
    want = {
        "consensus": vote_set_round(w["vals"], commit, "cpu", w["conflicting"])[:4],
        "blocksync": (all(window_want), window_want),
        "light": (outcome(lambda: light_calls(w)["verify_adjacent"]("cpu")),
                  outcome(lambda: light_calls(w)["verify_non_adjacent"]("cpu"))),
        "evidence": outcome(lambda: evidence_verify.verify_light_client_attack(
            w["attack"], w["sh_h"], w["sh_hk"], w["vals"], backend="cpu")),
    }
    for site in want:
        check(got[site] == want[site], f"verify plane {site}: {str(got[site])[:300]} != cpu {str(want[site])[:300]}")
    check(got["light"] == (("ok",), ("ok",)) and got["evidence"] == ("ok",), f"light/evidence did not verify: {got}")
    want_mixed = flush(mixed, "cpu")
    check(got_mixed == want_mixed and want_mixed[1].count(False) == 3, "verify plane three-curve flush != cpu")
    check(state == supervisor.HEALTHY, f"the supervisor ended {state}")
    check(stats["audits"] > 0 and all(v == 0 for k, v in stats.items() if k != "audits"),
          f"the healthy round fell back, tripped or shed: {stats}")
    check(dispatches < requests, f"{dispatches} flushes for {requests} requests: nothing coalesced")
    with_consensus = [f for f in flushes if "consensus" in f]
    check(with_consensus and all(f[0] == "consensus" for f in with_consensus),
          f"a flush carrying consensus did not serve it first: {flushes}")
    per_call["verify plane"] = {k: v for k, v in counts().items() if v}
    print(f"main: verify plane: consensus ({N_VALIDATORS + 1} votes), blocksync ({len(window)} lanes), light (2 steps) and "
          f"evidence (lunatic attack) from four threads at once, then a three-curve flush of {len(mixed)}, through "
          f"one scheduler over one supervisor over \"gpu\" == cpu; {int(requests)} requests in {dispatches} flushes "
          f"{json.dumps(flushes)} (reasons {json.dumps({k: v for k, v in reasons.items() if v})}); "
          f"supervisor {state}, {json.dumps(stats)}; round {round_s * 1e3:.1f} ms, three-curve flush "
          f"{mixed_s * 1e3:.1f} ms host wall (100% synchronous CPU audit included, CPU rung {native.rung()})")


class OneShotPlan(faults.FaultPlan):
    """A fault plan that injects each fault on the dispatches named:
    ``{"raise": {1, 2, 3}, "corrupt": {1}, "oom": {1}, "hang": {1}}``."""

    def __init__(self, at: dict, hang_s: float = 30.0):
        super().__init__(seed=SEED, hang_s=hang_s)
        self.at = at

    def _decide(self, device_idx=None):
        with self._lock:
            self.dispatches += 1
            no = self.dispatches
        pick = {k: no in v for k, v in self.at.items()}
        return (no, pick.get("raise", False), pick.get("hang", False), pick.get("corrupt", False), 0.0, False,
                pick.get("oom", False))


_fault_names = iter(range(1, 1_000_000))


def faulty_plane(at: dict, **kw):
    """A supervisor over a fault plan in front of "gpu", on a fault
    domain of its own (a quarantine there leaves the default topology,
    and so the key store's entries, alone)."""
    name = f"faulty-gpu-{next(_fault_names)}"
    plan = faults.install(name=name, inner="gpu", plan=OneShotPlan(at, kw.pop("hang_s", 30.0)))
    kw.setdefault("probe_base_ms", 50)
    kw.setdefault("hedge_pct", 0)
    kw.setdefault("audit_pct", 0)
    sup = supervisor.BackendSupervisor(spec=name, topology=topology.DeviceTopology.single(), **kw)
    return plan, sup


def verify_plane_faults_path(vals, commit, per_call):
    """Faults in front of the card's kernels, each phase with its own
    supervisor: exceptions walk the breaker to broken and the canary
    re-admits the card; a corrupted dispatch is caught by the synchronous
    audit; an OOM halves the chunk cap and clean dispatches recover it; a
    hang is killed by the watchdog and its zombie leaves."""
    items = precommits(vals, commit)
    items[17] = (items[17][0], items[17][1], flip(items[17][2], 5, 0x10))
    want = flush(items, "cpu")
    vals.verify_commit(CHAIN_ID, commit.block_id, commit.height, commit)  # the set resident
    lines = []

    # exceptions: degraded, degraded, broken; the canary on the card re-admits
    plan, sup = faulty_plane({"raise": {1, 2, 3}}, breaker_threshold=3)
    states = []
    for _ in range(3):
        check(sup.verify_items(items) == want[1], "a failed dispatch's verdicts != cpu")
        states.append(sup.state())
    check(states == ["degraded", "degraded", "broken"], f"the breaker walked {states}")
    before = counts()
    check(sup.probe_now() and sup.state() == supervisor.HEALTHY, "the canary did not re-admit the card")
    canary = {k: v - before[k] for k, v in counts().items() if v != before[k]}
    check(sum(canary.values()) > 0, "the canary launched no kernel")
    before = counts()
    check(sup.verify_items(items) == want[1], "the re-admitted card's verdicts != cpu")
    after = {k: v - before[k] for k, v in counts().items() if v != before[k]}
    check(sum(after.values()) > 0, "the flush after re-admission launched no kernel")
    lines.append(f"exceptions: states {states}, trips {json.dumps(labels_of(sup.metrics.trips))}, failures "
                 f"{sup.metrics.failures.value():.0f}, cpu verdicts {sup.metrics.cpu_verdicts.value():.0f}, canary "
                 f"launches {json.dumps(canary)}, then {sup.state()} and the next flush launched {json.dumps(after)}")
    sup.stop()

    # corruption: one corrupted dispatch under the synchronous 100% audit
    plan, sup = faulty_plane({"corrupt": {1}}, audit_pct=100, audit_sync=True)
    check(sup.verify_items(items) == want[1], "the corrupted dispatch's released verdicts != cpu")
    check(sup.metrics.audit_mismatches.value() == 1 and faults_total(sup.metrics.trips) >= 1
          and sup.state() == supervisor.BROKEN, "the corruption was not caught by the audit")
    lines.append(f"corruption: audit mismatches {sup.metrics.audit_mismatches.value():.0f}, trips "
                 f"{json.dumps(labels_of(sup.metrics.trips))}, triage runs {sup.metrics.triage_runs.value():.0f}, "
                 f"state {sup.state()}, released verdicts == cpu")
    sup.stop()

    # OOM: the chunk-cap gauge halves, then recovers after chunk_recover_n clean dispatches
    plan, sup = faulty_plane({"oom": {1}}, chunk_recover_n=2)
    gauges = [sup.metrics.chunk_cap.value()]
    for _ in range(2):
        check(sup.verify_items(items) == want[1], "an OOM phase flush != cpu")
        gauges.append(sup.metrics.chunk_cap.value())
    check(gauges == [8192, 4096, 8192] and sup.state() == supervisor.HEALTHY, f"the chunk cap went {gauges}")
    lines.append(f"oom: chunk cap {gauges}, retries {json.dumps(labels_of(sup.metrics.retries))}, shrinks "
                 f"{sup.metrics.chunk_shrinks.value():.0f}, recoveries {sup.metrics.chunk_recoveries.value():.0f}, "
                 f"state {sup.state()}")
    sup.stop()

    # hang: the watchdog kills the dispatch; the zombie leaves at its cancel event
    plan, sup = faulty_plane({"hang": {1}}, dispatch_timeout_ms=300)
    base = sum(1 for t in threading.enumerate() if t.name == "supervised-dispatch")
    before = counts()
    t0 = time.perf_counter()
    check(sup.verify_items(items) == want[1], "the hung dispatch's verdicts != cpu")
    hung_s = time.perf_counter() - t0
    wait_until(lambda: sum(1 for t in threading.enumerate() if t.name == "supervised-dispatch") <= base, 10,
               "the zombie dispatch thread to leave")
    zombie = {k: v - before[k] for k, v in counts().items() if v != before[k]}
    check(sup.metrics.watchdog_kills.value() == 1 and sup.state() == supervisor.BROKEN, "the watchdog did not kill")
    check(zombie == {}, f"the zombie launched kernels after the kill: {zombie}")
    lines.append(f"hang: watchdog kills {sup.metrics.watchdog_kills.value():.0f}, state {sup.state()}, the "
                 f"supervised call returned in {hung_s * 1e3:.1f} ms (300 ms watchdog + the CPU's verdicts), the "
                 f"zombie left without launching")
    sup.stop()
    per_call["verify plane faults"] = {k: v for k, v in counts().items() if v}
    for line in lines:
        print(f"main: verify plane faults: {line}")


# --- block execution ------------------------------------------------------------

BLOCK_HEIGHTS = 8
BLOCK_TXS = 200  # kvstore txs a block, about BLOCK_TX_BYTES each
BLOCK_TX_BYTES = 100
# the val: txs at this height change the set that signs height 6's commit,
# which height 7's LastCommit carries: the key tables are built again there
VAL_TX_HEIGHT = 4
BLOCK_T0 = 1_760_000_000


def block_keys():
    """The commit path's 180 keys and powers (make_valset_and_commit's
    seeds), and one new key for the val: height."""
    rng = np.random.default_rng(SEED)
    privs = [ed.gen_priv_key_from_secret(b"cosmoshub-val-%d" % i) for i in range(N_VALIDATORS)]
    powers = [int(p) for p in rng.integers(1_000, 5_000_000, N_VALIDATORS)]
    return privs, powers, ed.gen_priv_key_from_secret(b"cosmoshub-val-new")


def block_txs(height: int, privs, new_priv):
    """BLOCK_TXS seeded key=value txs of BLOCK_TX_BYTES; at VAL_TX_HEIGHT
    also a val: tx that changes the power of one validator and one that
    adds ``new_priv``."""
    rng = np.random.default_rng([SEED, height])
    txs = []
    for i in range(BLOCK_TXS):
        key = b"h%d-k%03d=" % (height, i)
        txs.append(key + rng.bytes((BLOCK_TX_BYTES - len(key)) // 2).hex().encode())
    if height == VAL_TX_HEIGHT:
        for pk, power in ((privs[3].pub_key().bytes(), 3_000_000), (new_priv.pub_key().bytes(), 2_500_000)):
            txs.append(PersistentKVStoreApplication.make_val_set_change_tx(base64.b64encode(pk).decode(), power))
    return txs


class BlockChain:
    """The genesis of ``privs``, the kvstore app behind a local proxy,
    MemDB state and block stores, and a BlockExecutor over ``backend``."""

    def __init__(self, backend, privs, powers, new_priv):
        self.on_card = backend != "cpu"
        self.by_addr = {k.pub_key().address(): k for k in privs + [new_priv]}
        gvs = [GenesisValidator(k.pub_key().address(), k.pub_key(), p, f"val-{i}")
               for i, (k, p) in enumerate(zip(privs, powers))]
        self.genesis = GenesisDoc(genesis_time=Timestamp(BLOCK_T0, 0), chain_id=CHAIN_ID, validators=gvs)
        self.state = make_genesis_state(self.genesis)
        self.state_db, self.block_db, self.app_db = MemDB(), MemDB(), MemDB()
        self.state_store = StateStore(self.state_db)
        self.state_store.save(self.state)
        self.block_store = BlockStore(self.block_db)
        self.conns = new_app_conns(new_local_client_creator(PersistentKVStoreApplication(self.app_db)))
        self.conns.start()
        self.conns.consensus().init_chain_sync(abci_types.RequestInitChain(
            time=self.genesis.genesis_time, chain_id=CHAIN_ID, initial_height=1,
            validators=[abci_types.ValidatorUpdate(pub_key_to_proto(v.pub_key), v.voting_power)
                        for v in self.state.validators.validators],
        ))
        self.executor = state_execution.BlockExecutor(self.state_store, self.conns.consensus(),
                                                      crypto_backend=backend)
        self.last_commit = Commit(0, 0, BlockID(), [])

    def sign_commit(self, block_id, height: int, vals) -> Commit:
        """Every validator precommits, each at its own time."""
        commit = Commit(height=height, round=0, block_id=block_id)
        for i, v in enumerate(vals.validators):
            ts = Timestamp(BLOCK_T0 + 6 * height, ((height * 7919 + i * 104729) % 999_983) * 1000)
            commit.signatures.append(CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, ts, b""))
        for i, v in enumerate(vals.validators):
            commit.signatures[i].signature = self.by_addr[v.address].sign(commit.vote_sign_bytes(CHAIN_ID, i))
        return commit

    def propose(self, height: int, txs):
        proposer = self.state.validators.get_proposer().address
        block, _ = self.executor.create_proposal_block(height, self.state, self.last_commit, proposer)
        block.data.txs = Txs(list(txs))
        block.header.data_hash = b""
        block.fill_header()
        block._hash = None
        parts = block.make_part_set(BLOCK_PART_SIZE_BYTES)
        return block, parts, BlockID(block.hash(), parts.header())

    def apply(self, block, parts, block_id) -> dict:
        """apply_block, then the block and its seen commit into the block
        store (nothing is stored when apply_block raises); the split of
        its host wall time, in ms."""
        split = {"validate": 0.0, "verify": 0.0, "exec": 0.0, "saves": 0.0}

        def timed(key, fn):
            def run(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    split[key] += (time.perf_counter() - t0) * 1e3
            return run

        patches = [
            (state_execution, "validate_block", timed("validate", state_execution.validate_block)),
            (state_execution, "exec_block_on_proxy_app", timed("exec", state_execution.exec_block_on_proxy_app)),
            (ValidatorSet, "verify_commit", timed("verify", ValidatorSet.verify_commit)),
            (self.state_store, "save_abci_responses", timed("saves", self.state_store.save_abci_responses)),
            (self.state_store, "save", timed("saves", self.state_store.save)),
        ]
        saved = [(obj, name, obj.__dict__.get(name)) for obj, name, _ in patches]
        for obj, name, fn in patches:
            setattr(obj, name, fn)
        try:
            t0 = time.perf_counter()
            self.state, _ = self.executor.apply_block(self.state, block_id, block)
            if self.on_card:
                torch.cuda.synchronize()
            split["apply"] = (time.perf_counter() - t0) * 1e3
        finally:
            for obj, name, old in saved:
                if old is None:
                    delattr(obj, name)
                else:
                    setattr(obj, name, old)
        commit = self.sign_commit(block_id, block.header.height, self.state.last_validators)
        t0 = time.perf_counter()
        self.block_store.save_block(block, parts, commit)
        split["save_block"] = (time.perf_counter() - t0) * 1e3
        split["other"] = split["apply"] - split["validate"] - split["exec"] - split["saves"]
        self.last_commit = commit
        return split

    def dump(self):
        return tuple(list(db.iterator()) for db in (self.state_db, self.block_db, self.app_db))

    def stop(self):
        self.conns.stop()


def run_block_chain(backend, keys, blocks=None, profile_heights=False):
    """The BLOCK_HEIGHTS heights on ``backend``: each height's block is
    proposed by this chain (validator-set hashes on the backend's device)
    and must equal ``blocks[h]`` when given. Returns (chain, {height:
    block bytes}, {height: split}, key store stats per height)."""
    privs, powers, new_priv = keys
    chain = BlockChain(backend, privs, powers, new_priv)
    out_blocks, splits, store = {}, {}, {}
    for h in range(1, BLOCK_HEIGHTS + 1):
        block, parts, block_id = chain.propose(h, block_txs(h, privs, new_priv))
        out_blocks[h] = block.encode()
        if blocks is not None:
            check(out_blocks[h] == blocks[h], f"block execution: the {backend!r} block at height {h} differs")
        before = store_stats()
        splits[h] = chain.apply(block, parts, block_id)
        after = store_stats()
        store[h] = {k: after[k] - before[k] for k in ("uploads", "hits", "misses")}
    return chain, out_blocks, splits, store


def corrupt_last_commit(chain, height: int, keys, idx: int = 11):
    """Height ``height``'s block with one LastCommit signature flipped, the
    header refilled; apply_block's outcome, and whether every store
    stayed as it was."""
    block, _, _ = chain.propose(height, block_txs(height, keys[0], keys[2]))
    cs = block.last_commit.signatures[idx]
    cs.signature = flip(cs.signature, 3, 0x20)
    block.last_commit._hash = None
    block.header.last_commit_hash = b""
    block.fill_header()
    block._hash = None
    parts = block.make_part_set(BLOCK_PART_SIZE_BYTES)
    block_id = BlockID(block.hash(), parts.header())
    before, state_before = chain.dump(), chain.state.encode()
    got = outcome(lambda: chain.apply(block, parts, block_id))
    return got, chain.dump() == before and chain.state.encode() == state_before


def print_block_splits(label: str, splits: dict, store: dict, card: str) -> None:
    for h, t in splits.items():
        ks = f"; key store uploads {store[h]['uploads']}, hits {store[h]['hits']}" if store else ""
        print(f"block: height {h} on {label}: apply_block {t['apply']:.3f} ms host wall (validate_block "
              f"{t['validate']:.3f}, of which verify_commit {t['verify']:.3f}; exec_block_on_proxy_app "
              f"{t['exec']:.3f}; state saves {t['saves']:.3f}; update_state, app commit and events "
              f"{t['other']:.3f}), then save_block {t['save_block']:.3f} ms{ks} [{card}]")


def block_execution_path(per_call):
    """Block execution: a genesis of the 180 validators, BLOCK_HEIGHTS
    heights of BLOCK_TXS kvstore txs through BlockExecutor over "gpu" (each
    LastCommit verified on the card, the validator-set hashes one
    merkle_tree launch each), a val: height that changes the signing set
    (its key tables built again, then hit), then the same chain over
    "cpu" (the native rung): every block, the final State, the app hash
    and every store byte-equal; a flipped LastCommit signature raises the
    same error on both and leaves every store as it was."""
    card = card_line()
    keys = block_keys()
    keystore.default_store().invalidate()  # the genesis set goes up on this path
    gpu, blocks, gpu_splits, store = run_block_chain("gpu", keys)
    torch.cuda.synchronize()
    launched = {k: v for k, v in counts().items() if v}
    cpu, _, cpu_splits, _ = run_block_chain("cpu", keys, blocks=blocks)
    check(gpu.state.encode() == cpu.state.encode(), "block execution: the final State differs between gpu and cpu")
    check(gpu.state.app_hash == cpu.state.app_hash and len(gpu.state.app_hash) == 8,
          "block execution: the app hash differs")
    for h in range(1, BLOCK_HEIGHTS + 1):
        for what, load in (("block", BlockStore.load_block), ("meta", BlockStore.load_block_meta),
                           ("seen commit", BlockStore.load_seen_commit), ("commit", BlockStore.load_block_commit)):
            if what == "commit" and h == BLOCK_HEIGHTS:
                continue
            check(load(gpu.block_store, h).encode() == load(cpu.block_store, h).encode(),
                  f"block execution: the stored {what} at height {h} differs")
    check(gpu.dump() == cpu.dump(), "block execution: the stores differ between gpu and cpu")
    n_vals = len(gpu.state.validators.validators)
    check(n_vals == N_VALIDATORS + 1, f"block execution: the val: height left {n_vals} validators")
    # the LastCommit at h is signed by the set of h - 1: it is uploaded at 2, hit
    # through 6, the changed set (first signing at 6) uploaded at 7 and hit at 8
    want_uploads = {h: 1 if h in (2, VAL_TX_HEIGHT + 3) else 0 for h in range(1, BLOCK_HEIGHTS + 1)}
    check({h: s["uploads"] for h, s in store.items()} == want_uploads,
          f"block execution: key store uploads per height {store}, want {want_uploads}")
    check(all(store[h]["hits"] >= 1 for h in range(3, BLOCK_HEIGHTS + 1) if not want_uploads[h]),
          f"block execution: a height after an upload missed the key store: {store}")
    reset_before = counts()
    got_gpu, kept_gpu = corrupt_last_commit(gpu, BLOCK_HEIGHTS + 1, keys)
    got_cpu, kept_cpu = corrupt_last_commit(cpu, BLOCK_HEIGHTS + 1, keys)
    check(got_gpu == got_cpu and got_gpu[0] == "ValueError" and got_gpu[1].startswith("wrong signature (#11)"),
          f"block execution: a flipped LastCommit signature gave {got_gpu} on gpu, {got_cpu} on cpu")
    check(kept_gpu and kept_cpu, "block execution: a rejected block changed a store")
    check(counts()["ed25519_verify_resident"] > reset_before["ed25519_verify_resident"],
          "block execution: the flipped commit was not verified on the card")
    per_call["block execution"] = launched
    print(f"main: block execution: {BLOCK_HEIGHTS} heights of {BLOCK_TXS} txs of about {BLOCK_TX_BYTES} bytes, "
          f"{N_VALIDATORS} validators, a val: height at {VAL_TX_HEIGHT} ({n_vals} validators after it), through "
          f"BlockExecutor over \"gpu\" == \"cpu\" (CPU rung {native.rung()}): every block, State, app hash "
          f"{gpu.state.app_hash.hex()} and store byte-equal; key store per height {json.dumps(store)}; a flipped "
          f"LastCommit signature: {got_gpu[0]} on both, stores unchanged; launches {json.dumps(launched)}")
    print_block_splits('"gpu"', gpu_splits, store, card)
    print_block_splits('"cpu"', cpu_splits, {}, card)
    gpu.stop()
    cpu.stop()


def labels_of(counter) -> dict:
    return {",".join(f"{k}={v}" for k, v in sorted(c._labels.items())): c.value()
            for c in counter._series() if c._labels}



PATHS = {  # path -> the kernels it must launch
    "commit": ("ed25519_verify_resident", "ed25519_key_tables", "merkle_tree"),
    "indexed flush": ("ed25519_verify_resident",),
    "device hash": ("ed25519_verify_resident", "ed25519_verify_full_compact"),
    "window": ("ed25519_verify_compact",),
    "secp commit": ("secp256k1_verify", "merkle_tree"),
    "mixed flush": ("secp256k1_verify", "ed25519_verify_resident"),
    "secp window": ("secp256k1_verify",),
    "sr flush": ("sr25519_verify",),
    "three-curve flush": ("ed25519_verify_resident", "secp256k1_verify", "sr25519_verify"),
    "sr window": ("sr25519_verify",),
    "words": ("ed25519_verify_words", "ed25519_verify_full_words"),
    "light": ("merkle_tree", "ed25519_key_tables", "ed25519_verify_resident"),
    "vote set": ("ed25519_verify_resident",),
    "evidence": ("merkle_tree", "ed25519_key_tables", "ed25519_verify_resident"),
    "verify plane": ("ed25519_verify_resident", "ed25519_key_tables", "merkle_tree", "secp256k1_verify",
                     "sr25519_verify"),
    "verify plane faults": ("ed25519_verify_resident", "ed25519_verify_compact"),
    "block execution": ("ed25519_verify_resident", "ed25519_key_tables", "merkle_tree"),
}


def run_main_path(vals, block_id, commit, svals, sblock_id, scommit, sr_lanes, world):
    """Each path with the counts set to 0 just before it and read just
    after; returns (launches summed over the paths, per call, the sr
    window's timing). The call sites' paths run last, so that the key
    store's uploads and hits on every earlier path stay as they were, and
    the verify plane's after them."""
    items, want = window_items(vals, commit)
    mixed = three_curve_items(vals, commit, svals, scommit, sr_lanes)
    s_items, s_want = secp_window_items(svals, scommit)
    r_items, r_want = sr_window_items(sr_lanes)
    sr_timing = {}
    steps = {
        "commit": lambda pc: commit_path(vals, block_id, commit, pc),
        "indexed flush": lambda pc: indexed_flush_path(vals, commit, pc),
        "device hash": lambda pc: device_hash_path(vals, block_id, commit, pc),
        "window": lambda pc: window_path(items, want, pc),
        "secp commit": lambda pc: secp_commit_path(svals, sblock_id, scommit, pc),
        "mixed flush": lambda pc: mixed_flush_path(vals, block_id, commit, svals, scommit, pc),
        "secp window": lambda pc: secp_window_path(s_items, s_want, pc),
        "sr flush": lambda pc: sr_flush_path(sr_lanes, pc),
        "three-curve flush": lambda pc: three_curve_flush_path(vals, block_id, commit, svals, scommit, sr_lanes, pc),
        "sr window": lambda pc: sr_window_path(r_items, r_want, pc, sr_timing),
        "words": lambda pc: words_path(vals, commit, pc),
        "light": lambda pc: light_path(world, pc),
        "vote set": lambda pc: vote_set_path(vals, block_id, commit, world["keys"], pc),
        "evidence": lambda pc: evidence_path(world, pc),
        "verify plane": lambda pc: verify_plane_path(world, commit, items, want, mixed, pc),
        "verify plane faults": lambda pc: verify_plane_faults_path(vals, commit, pc),
        "block execution": lambda pc: block_execution_path(pc),
    }
    total = {k: 0 for k in counts()}
    per_call = {}
    for name, step in steps.items():
        reset_counts()
        step(per_call)
        torch.cuda.synchronize()
        got = counts()
        for kernel in PATHS[name]:
            check(got[kernel] > 0, f"{kernel} was not launched on the {name} path")
        print(f"main: path {name!r} launches {json.dumps({k: v for k, v in got.items() if v})}")
        total = {k: total[k] + got[k] for k in total}
    keystore.default_store().invalidate()
    return total, per_call, sr_timing


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

    core_ops = ed25519_core_g1_ops_per_lane()
    for batch, plain_runs in ((N_VALIDATORS, 2), (ed25519_batch.MAX_CHUNK, 1), (BIG_BATCH, 1)):
        w = torch.from_numpy(np.ascontiguousarray(np.tile(wire_np, (1, -(-batch // N_VALIDATORS)))[:, :batch])).to(dev)
        row = kernel_row(
            "ed25519_verify_compact", f"B={batch} G={ed25519_batch.core_group(batch, dev)}",
            lambda: ed25519_batch.verify_kernel_compact(w), lambda: ed25519_batch.verify_compact_plain(w), plain_runs,
            batch * (128 + 1), batch * core_ops, int_rate, errs, card)
        check(bool(row.pop("got").all()), f"ed25519 kernel rejected a signed lane at B={batch}")
        if batch == N_VALIDATORS:
            out["ed25519_verify_compact"] = row
        else:
            out["ed25519_verify_compact"].update({f"{k}_{batch}": v for k, v in row.items()})
    print(f"time: ed25519 wire-key core model: {core_ops} int32 instructions a lane at G=1 (the least: the bound; "
          f"the first design's {ed25519_core_ops_per_lane()}); at G=4 one thread of the group "
          f"{core_group_thread_ops(4)} (the chain), the thread beside it {core_fixed_base_ops()}, "
          f"the lane {4 * core_group_thread_ops(4) + core_fixed_base_ops()}; at G=2 {core_group_thread_ops(2)} "
          f"a thread [{card}]")

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
    b_ms, b_by = bound(blocks_np.nbytes + n_live_np.nbytes + 32, (int(n_live_np.sum()) + 2 * inner) * SHA_BLOCK_OPS, int_rate)
    row = kernel_row("merkle_tree", f"{len(leaves)} validator leaves u32[{blocks_np.shape[0]},{blocks_np.shape[1]},16] -> root",
                     lambda: merkle.merkle_tree(blocks, n_live), lambda: merkle.merkle_tree_plain(blocks, n_live), 20,
                     blocks_np.nbytes + n_live_np.nbytes + 32, (int(n_live_np.sum()) + 2 * inner) * SHA_BLOCK_OPS,
                     int_rate, errs, card)
    check(sha256.digests_to_bytes_np(sha256.to_u32(row.pop("got"))[None, :])[0].tobytes() == vals.hash(device="cpu"),
          "merkle_tree root of the validator leaves != host tree")
    row["run_ms"] = run_ms(lambda: merkle.merkle_tree(blocks, n_live), runs=50)
    out["merkle_tree"] = row
    print(f"time: merkle_tree {len(leaves)} leaves: {row['run_ms']:.4f} ms a call back to back, {row['ms']:.4f} ms "
          f"for one call from the wrapper's call to the kernel's end [{card}]")
    print(f"time: merkle_tree replaces sha256_blocks and merkle_level's tree: {out['sha256_blocks']['ms']:.4f} + "
          f"{out['merkle_level']['ms']:.4f} ms in 9 launches, against {row['ms']:.4f} ms in one [{card}]")
    out.update(time_new_kernels(vals, commit, card, errs, int_rate))
    return out


def time_secp_kernel(svals, scommit, card: str, errs: dict) -> dict:
    """secp256k1_verify at B=180 (one commit), 4,096 (a window chunk) and
    16,384 (the window in one launch), equal to its plain version, beside
    its bound at the group size each launch uses."""
    dev = torch.device("cuda")
    int_rate = int32_ops_per_s()
    items = precommits(svals, scommit)
    wire, flags, valid = secp256k1_batch.prepare_batch([it[0].bytes() for it in items], [it[1] for it in items],
                                                       [it[2] for it in items])
    check(bool(valid.all()), "the signed secp256k1 commit packed with an invalid lane")
    out = {}
    for batch, plain_runs in ((N_VALIDATORS, 2), (4096, 1), (BIG_BATCH, 1)):
        lanes = np.arange(batch) % N_VALIDATORS
        w_t, f_t = to_dev(dev, wire[:, lanes], flags[lanes])
        group = build.group_size(batch, dev, secp256k1_batch.GROUP_THREADS_PER_SM)
        ops = secp256k1_ops_per_lane(1)  # the least work: one doubling chain a lane
        row = kernel_row(
            "secp256k1_verify", f"B={batch} G={group}", lambda: secp256k1_batch.verify_kernel(w_t, f_t),
            lambda: secp256k1_batch.verify_plain(w_t, f_t), plain_runs,
            (128 + 4 + 1) * batch, batch * ops, int_rate, errs, card)
        check(bool(row.pop("got").all()), f"secp256k1_verify rejected a signed lane at B={batch}")
        if batch == N_VALIDATORS:
            out = row
        else:
            out.update({f"{k}_{batch}": v for k, v in row.items()})
        print(f"time: secp256k1_verify B={batch} model: {ops} int32 instructions a lane at G=1 (the bound), "
              f"{secp256k1_ops_per_lane(group)} at the launch's G={group} (the first design's "
              f"{SECP_FIRST_DESIGN_OPS}: bound {bound(133 * batch, batch * SECP_FIRST_DESIGN_OPS, int_rate)[0]:.6f} ms) [{card}]")
    return {"secp256k1_verify": out}


def time_sr_kernel(sr_lanes, card: str, errs: dict, int_rate: float) -> dict:
    """sr25519_verify at B=180 (one flush of the 180 lanes) and SR_WINDOW
    (the window's chunk), equal to its plain version, beside its bound."""
    dev = torch.device("cuda")
    wire, valid = sr25519_batch.prepare_batch(*lane_columns(sr_lanes))
    check(bool(valid.all()), "the signed sr25519 lanes packed with an invalid lane")
    ops = min(sr25519_ops_per_lane(), sr25519_g1_ops_per_lane())
    out = {}
    for batch, plain_runs in ((N_VALIDATORS, 2), (SR_WINDOW, 1)):
        (w_t,) = to_dev(dev, wire[:, np.arange(batch) % N_VALIDATORS])
        group = sr25519_batch.core_group(batch, dev)
        row = kernel_row(
            "sr25519_verify", f"B={batch} G={group}", lambda: sr25519_batch.verify_kernel(w_t),
            lambda: sr25519_batch.verify_plain(w_t), plain_runs, (128 + 1) * batch, batch * ops, int_rate, errs, card)
        check(bool(row.pop("got").all()), f"sr25519_verify rejected a signed lane at B={batch}")
        if batch == N_VALIDATORS:
            out = row
        else:
            out.update({f"{k}_{SR_WINDOW}": v for k, v in row.items()})
    print(f"time: sr25519_verify model: {ops} int32 instructions a lane at G=1 (the least: the bound; the first "
          f"design's {sr25519_ops_per_lane()}) [{card}]")
    return {"sr25519_verify": out}


def time_words_kernels(vals, commit, card: str, errs: dict, int_rate: float) -> dict:
    """The two word-wire kernels at B=180 (one commit's precommits) and
    B=16,384 (the window's size), equal to their plain versions, beside
    their bounds."""
    dev = torch.device("cuda")
    pks = [v.pub_key.bytes() for v in vals.validators]
    msgs = [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(len(pks))]
    sigs = [cs.signature for cs in commit.signatures]
    wire, valid = ed25519_batch.prepare_batch(pks, msgs, sigs)
    wire24, hi, lo, nblocks, valid2 = ed25519_batch.prepare_batch_device_hash(pks, msgs, sigs)
    check(bool(valid.all() and valid2.all()), "the signed commit packed with an invalid lane")
    ed_ops = ed25519_core_g1_ops_per_lane()
    out = {}
    for batch, plain_runs in ((N_VALIDATORS, 2), (BIG_BATCH, 1)):
        lanes = np.arange(batch) % N_VALIDATORS
        w_t, w24_t, hi_t, lo_t, nb_t = to_dev(dev, wire[:, lanes], wire24[:, lanes], hi[:, :, lanes], lo[:, :, lanes],
                                              nblocks[lanes])
        hash_ops = int(nblocks[lanes].sum()) * SHA512_WORDS_BLOCK_OPS + batch * SC_REDUCE_OPS
        rows = {
            "ed25519_verify_words": kernel_row(
                "ed25519_verify_words", f"B={batch} G={ed25519_batch.core_group(batch, dev)}",
                lambda: ed25519_batch.verify_kernel_words(w_t),
                lambda: ed25519_batch.verify_words_plain(w_t), plain_runs,
                (128 + 1) * batch, batch * ed_ops, int_rate, errs, card),
            "ed25519_verify_full_words": kernel_row(
                "ed25519_verify_full_words", f"B={batch} G={ed25519_batch.core_group(batch, dev)} u32[{hi.shape[0]},16,B] blocks",
                lambda: ed25519_batch.verify_kernel_full_words(w24_t, hi_t, lo_t, nb_t),
                lambda: ed25519_batch.verify_full_words_plain(w24_t, hi_t, lo_t, nb_t), plain_runs,
                (96 + 2 * hi.shape[0] * 64 + 4 + 1) * batch, batch * ed_ops + hash_ops, int_rate, errs, card),
        }
        for name, row in rows.items():
            check(bool(row.pop("got").all()), f"{name} rejected a signed lane at B={batch}")
            if batch == N_VALIDATORS:
                out[name] = row
            else:
                out[name].update({f"{k}_16384": v for k, v in row.items()})
    return out


def kernel_row(name, label, kernel, plain, plain_runs, nbytes, ops, int_rate, errs, card) -> dict:
    """One kernel at one shape: exactly equal to its plain version, then
    CUDA-event medians of both beside the bound."""
    got = kernel()
    torch.cuda.synchronize()
    plain_out, plain_ms = plain_timed(plain, plain_runs)
    err = max_abs_err(got, plain_out)
    check(err == 0, f"{name} disagrees with its plain version at {label}")
    errs[name] = max(errs[name], err)
    ms = cuda_ms(kernel, runs=20)
    b_ms, b_by = bound(nbytes, ops, int_rate)
    print(f"kernels: {name} {label} == plain, max_abs_err {err}")
    print(f"time: {name} {label}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {b_ms:.6f} ms ({b_by}) [{card}]")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "shape": label, "got": got}


def time_new_kernels(vals, commit, card: str, errs: dict, int_rate: float) -> dict:
    """The key table kernel for the 180 keys, and the resident and
    device-hash kernels at B=180 (one commit) and B=16,384 (the window,
    by index into the 180 keys). The resident bound counts the key tables
    once and the operations of the group size its launch uses."""
    dev = torch.device("cuda")
    pks = [v.pub_key.bytes() for v in vals.validators]
    msgs = [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(len(pks))]
    sigs = [cs.signature for cs in commit.signatures]
    n = len(pks)
    pk_arr = np.frombuffer(b"".join(pks), np.uint8).reshape(n, 32)
    rsh, valid = ed25519_batch._prepare_rsh_compact(pk_arr, msgs, sigs)
    wire, msg, mlen, valid2 = ed25519_batch.prepare_batch_device_hash_compact(pks, msgs, sigs)
    check(bool(valid.all() and valid2.all()), "the signed commit packed with an invalid lane")
    table_ops = ed25519_key_table_ops_per_key()
    out = {}
    for keys_n, plain_runs in ((n, 2), (4096, 1)):  # a set of 4,096: the 180 keys tiled
        (keys_t,) = to_dev(dev, pk_arr[np.arange(keys_n) % n])
        row = kernel_row("ed25519_key_tables", f"{keys_n} keys", lambda: ed25519_batch.key_tables_kernel(keys_t),
                         lambda: ed25519_batch.key_tables_plain(keys_t), plain_runs,
                         keys_n * (32 + ed25519_batch.KEY_TABLE_BYTES), keys_n * table_ops, int_rate, errs, card)
        got = row.pop("got")
        row["run_ms"] = run_ms(lambda: ed25519_batch.key_tables_kernel(keys_t))
        print(f"time: ed25519_key_tables {keys_n} keys: {row['run_ms']:.4f} ms a call back to back [{card}]")
        if keys_n == n:
            tables = got
            out["ed25519_key_tables"] = row
        else:
            out["ed25519_key_tables"].update({f"{k}_{keys_n}": v for k, v in row.items()})
    chain, worst, total = ed25519_key_table_kernel_ops()
    print(f"time: ed25519_key_tables model: {table_ops} int32 instructions a key at one thread a key (the bound); "
          f"as the kernel runs a key: {total}, of which each of the four chain threads {chain} (the chain to the "
          f"last base), a helper at most {worst} [{card}]")
    full_ops = ed25519_core_g1_ops_per_lane()
    table_bytes = (n + 1) * ed25519_batch.KEY_TABLE_BYTES  # the set's tables and B's, each read once
    for batch, plain_runs in ((n, 2), (BIG_BATCH, 1)):
        lanes = np.arange(batch) % n
        idx = None if batch == n else to_dev(dev, lanes.astype(np.int32))[0]
        rsh_t, w_t, msg_t, mlen_t = to_dev(dev, rsh[:, lanes], wire[:, lanes], msg[:, lanes], mlen[lanes])
        idx_bytes = 0 if idx is None else 4 * batch
        form = "lane order" if idx is None else "by index"
        blocks = live_sha512_blocks(mlen[lanes])
        hash_ops = blocks * SHA512_BLOCK_OPS + batch * SC_REDUCE_OPS
        group = build.group_size(batch, dev, ed25519_batch.GROUP_THREADS_PER_SM)
        res_ops = ed25519_resident_ops_per_lane(1)  # the least work: one chain a lane
        rows = {
            "ed25519_verify_resident": kernel_row(
                "ed25519_verify_resident", f"B={batch} {form} G={group}",
                lambda: ed25519_batch.verify_kernel_resident(tables, idx, rsh_t),
                lambda: ed25519_batch.verify_resident_plain(tables, idx, rsh_t), plain_runs,
                table_bytes + idx_bytes + 96 * batch + batch, batch * res_ops, int_rate, errs, card),
            "ed25519_verify_full_compact": kernel_row(
                "ed25519_verify_full_compact", f"B={batch} G={ed25519_batch.core_group(batch, dev)} u8[{msg.shape[0]},B] messages",
                lambda: ed25519_batch.verify_kernel_full_compact(w_t, msg_t, mlen_t),
                lambda: ed25519_batch.verify_full_compact_plain(w_t, msg_t, mlen_t), plain_runs,
                (96 + msg.shape[0] + 4 + 1) * batch, batch * full_ops + hash_ops, int_rate, errs, card),
        }
        check(bool(rows["ed25519_verify_resident"]["got"].all()), f"resident kernel rejected a signed lane at B={batch}")
        check(bool(rows["ed25519_verify_full_compact"]["got"].all()), f"full kernel rejected a signed lane at B={batch}")
        old_model = bound(table_bytes + idx_bytes + 97 * batch, batch * full_ops, int_rate)[0]
        print(f"time: ed25519_verify_resident B={batch} model: {res_ops} int32 instructions a lane at G=1 (the bound), "
              f"{ed25519_resident_ops_per_lane(group)} at the launch's G={group} "
              f"(the wire-key core's {full_ops}: bound {old_model:.6f} ms) [{card}]")
        for name, row in rows.items():
            del row["got"]
            if batch == n:
                out[name] = row
            else:
                out[name].update({f"{k}_16384": v for k, v in row.items()})
    return out


def group_sweep(vals, commit, svals, scommit, card: str) -> None:
    """Each grouped kernel at 1, 2 and 4 threads a lane, B=180 and 16,384,
    launched through its C entry point, each output equal to the
    wrapper's (whose group size the rule picks): the measurement behind
    build.group_size."""
    dev = torch.device("cuda")
    stream = build.stream_ptr(dev)
    pks = [v.pub_key.bytes() for v in vals.validators]
    msgs = [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(len(pks))]
    sigs = [cs.signature for cs in commit.signatures]
    pk_arr = np.frombuffer(b"".join(pks), np.uint8).reshape(-1, 32)
    rsh, _ = ed25519_batch._prepare_rsh_compact(pk_arr, msgs, sigs)
    (keys_t,) = to_dev(dev, pk_arr)
    tables = ed25519_batch.key_tables_kernel(keys_t)
    base = ed25519_batch.base_tables(dev)
    items = precommits(svals, scommit)
    swire, sflags, _ = secp256k1_batch.prepare_batch(*lane_columns(items))
    res_lib = ed25519_batch._resident_lib()
    secp_lib = build.load("secp256k1_verify", secp256k1_batch._SIGNATURES)
    for batch in (N_VALIDATORS, 4096, BIG_BATCH):
        lanes = np.arange(batch) % N_VALIDATORS
        idx = None if batch == N_VALIDATORS else to_dev(dev, lanes.astype(np.int32))[0]
        rsh_t, w_t, f_t = to_dev(dev, rsh[:, lanes], swire[:, lanes], sflags[lanes])
        want_ed = ed25519_batch.verify_kernel_resident(tables, idx, rsh_t)
        want_secp = secp256k1_batch.verify_kernel(w_t, f_t)
        line = []
        for group in (1, 2, 4):
            out = torch.empty(batch, dtype=torch.uint8, device=dev)

            def ed():
                build.check(res_lib.cbt_ed25519_verify_resident(
                    tables.data_ptr(), tables.shape[0], None if idx is None else idx.data_ptr(), rsh_t.data_ptr(),
                    base.data_ptr(), out.data_ptr(), batch, group, stream), "ed25519_verify_resident")

            def sp():
                build.check(secp_lib.cbt_secp256k1_verify(
                    w_t.data_ptr(), f_t.data_ptr(), out.data_ptr(), batch, group, stream), "secp256k1_verify")

            for name, fn, want in (("ed25519_verify_resident", ed, want_ed), ("secp256k1_verify", sp, want_secp)):
                fn()
                torch.cuda.synchronize()
                check(torch.equal(out.bool(), want), f"{name} at G={group} B={batch} != the wrapper's output")
                line.append(f"{name} G={group} {cuda_ms(fn, runs=20):.4f} ms")
        rule = [build.group_size(batch, dev, m.GROUP_THREADS_PER_SM) for m in (ed25519_batch, secp256k1_batch)]
        print(f"time: group sweep B={batch}: " + ", ".join(line) + f"; the rule picks G={rule[0]} and G={rule[1]} [{card}]")


def core_group_sweep(vals, commit, sr_lanes, card: str) -> dict:
    """The two wire-key cores at 1, 2 and 4 threads a lane (Ed25519 through
    ed25519_verify_compact at B=180 and the window's 8,192 and 16,384;
    sr25519_verify at B=180 and its window's 8,192), launched through their
    C entry points, each output equal to the wrapper's (whose group size
    the rule picks): the measurement behind the cores' budgets. Returns
    {kernel: {"sweep_ms": {B: {G: ms}}}}."""
    dev = torch.device("cuda")
    pks = [v.pub_key.bytes() for v in vals.validators]
    msgs = [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(len(pks))]
    sigs = [cs.signature for cs in commit.signatures]
    ed_wire, _ = ed25519_batch.prepare_batch_compact(pks, msgs, sigs)
    sr_wire, _ = sr25519_batch.prepare_batch(*lane_columns(sr_lanes))
    kernels = {
        "ed25519_verify_compact": (ed_wire, ed25519_batch.verify_kernel_compact, (N_VALIDATORS, 8192, BIG_BATCH),
                                   lambda b: ed25519_batch.core_group(b, dev)),
        "sr25519_verify": (sr_wire, sr25519_batch.verify_kernel, (N_VALIDATORS, SR_WINDOW),
                           lambda b: sr25519_batch.core_group(b, dev)),
    }
    result = {}
    for name, (wire, wrapper, batches, rule) in kernels.items():
        sweep = {}
        for batch in batches:
            (w_t,) = to_dev(dev, wire[:, np.arange(batch) % N_VALIDATORS])
            want = wrapper(w_t)
            out = torch.empty(batch, dtype=torch.uint8, device=dev)
            line = []
            sweep[batch] = {}
            for group in (1, 2, 4):
                launch_group(name, group, out, w_t)
                torch.cuda.synchronize()
                check(torch.equal(out.bool(), want), f"{name} at G={group} B={batch} != the wrapper's output")
                ms = cuda_ms(lambda: launch_group(name, group, out, w_t), runs=20)
                sweep[batch][group] = ms
                line.append(f"G={group} {ms:.4f} ms")
            print(f"time: group sweep {name} B={batch}: " + ", ".join(line) + f"; the rule picks G={rule(batch)} [{card}]")
        result[name] = {"sweep_ms": sweep}
    return result


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


def wall_ms_turns(fns: dict, runs: int, turns: int = 4) -> dict:
    """Host wall times of each fn in ms, run in turns (a, b, b, a, ...) so
    that two routes see the same host: {name: (median, min, max)}; each
    fn ends in a sync."""
    times = {k: [] for k in fns}
    for name, fn in fns.items():
        fn()  # warm-up
    order = list(fns)
    for t in range(turns):
        for name in (order if t % 2 == 0 else order[::-1]):
            for _ in range(max(1, runs // turns)):
                t0 = time.perf_counter()
                fns[name]()
                times[name].append((time.perf_counter() - t0) * 1e3)
    return {k: (statistics.median(v), min(v), max(v)) for k, v in times.items()}


def time_end_to_end(vals, block_id, commit, window, card: str) -> None:
    """Host wall medians of the entry points a node calls per commit, the
    flushes, and the blocksync window."""
    height = commit.height
    store = keystore.default_store()

    def verify(backend):
        return lambda: vals.verify_commit(CHAIN_ID, block_id, height, commit, backend=backend)

    def keyed_route():
        """verify_commit with the keys shipped through add()/verify() on
        the compact wire: neither the resident nor the indexed route."""
        real = cryptobatch.resident_commit_eligible, keystore.verify_batch_indexed
        cryptobatch.resident_commit_eligible = lambda n_present, backend=None: False
        keystore.verify_batch_indexed = lambda *args: None
        try:
            verify("gpu")()
        finally:
            cryptobatch.resident_commit_eligible, keystore.verify_batch_indexed = real

    pks = [v.pub_key.bytes() for v in vals.validators]
    msgs = [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(len(pks))]
    sigs = [cs.signature for cs in commit.signatures]
    pk_arr = np.frombuffer(b"".join(pks), np.uint8).reshape(-1, 32)
    items = precommits(vals, commit)
    store.invalidate()
    ab = wall_ms_turns({"resident": verify("gpu"), "compact": keyed_route}, runs=20)
    for label, key in (("resident (hit)", "resident"), ("compact route", "compact")):
        med, lo, hi = ab[key]
        print(f"e2e: verify_commit gpu {label:15s} p50 {med:.3f} ms host wall (min {lo:.3f}, max {hi:.3f}), "
              f"{N_VALIDATORS} validators, in turns [{card}]")

    def miss():
        store.invalidate()
        verify("gpu")()

    def upload():
        ed25519_batch._build_resident(pks, "cuda")
        torch.cuda.synchronize()

    rows = [
        ("verify_commit gpu resident (miss)", wall_ms(miss, runs=10)),
        ("  of which upload and key tables", wall_ms(upload, runs=10)),
        ("verify_commit cpu", wall_ms(verify("cpu"), runs=3, warmup=0)),
        ("  of which sign bytes", wall_ms(lambda: [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(len(pks))], runs=20)),
        ("  of which verify_commit_valset", wall_ms(lambda: cryptobatch.verify_commit_valset(pks, msgs, sigs), runs=20)),
        ("  of which R||S||h packing", wall_ms(lambda: ed25519_batch._prepare_rsh_compact(pk_arr, msgs, sigs), runs=20)),
        ("  of which compact packing", wall_ms(lambda: ed25519_batch.prepare_batch_compact(pks, msgs, sigs), runs=20)),
        ("indexed flush gpu", wall_ms(lambda: flush(items, None), runs=20)),
    ]
    store.invalidate()
    rows.append(("keyed flush gpu (host hash)", wall_ms(lambda: flush(items, None), runs=20)))
    os.environ["CBFT_TPU_HASH"] = "device"
    try:
        rows.append(("device-hash flush gpu", wall_ms(lambda: flush(items, None), runs=20)))
    finally:
        del os.environ["CBFT_TPU_HASH"]
    for label, ms in rows:
        print(f"e2e: {label:34s} p50 {ms:.3f} ms host wall, {N_VALIDATORS} validators [{card}]")
    leaves = [v.bytes() for v in vals.validators]
    h = wall_ms_turns({"cuda": lambda: vals.hash(device="cuda"), "host": lambda: vals.hash(device="cpu"),
                       "  of which leaf encoding": lambda: [v.bytes() for v in vals.validators],
                       "  of which padding": lambda: sha256.pad_ragged_np(leaves, prefix=merkle.LEAF_PREFIX)},
                      runs=40)
    for label, (med, lo, hi) in h.items():
        print(f"e2e: ValidatorSet.hash {label:26s} p50 {med:.3f} ms host wall (min {lo:.3f}, max {hi:.3f}), "
              f"{N_VALIDATORS} validators, in turns [{card}]")

    def one_launch():
        mesh.configure_chunk_cap(BIG_BATCH)
        try:
            flush(window, None)
        finally:
            mesh.configure_chunk_cap(None)

    store.invalidate()
    w = wall_ms_turns({"two chunks": lambda: flush(window, None), "one launch": one_launch}, runs=8, turns=8)
    for label, (ms, lo, hi) in w.items():
        print(f"e2e: window {BIG_BATCH} lanes, {label:10s} p50 {ms:.3f} ms host wall (min {lo:.3f}, max {hi:.3f}) "
              f"= {BIG_BATCH / ms * 1e3:.0f} signatures/s, in turns [{card}]")


def time_call_sites(w, commit, card: str) -> None:
    """Host wall medians of the light client's two steps (the non-adjacent
    one with both sets resident, and with the rotated set missing from the
    key store: its upload and key tables included) and of consensus's
    preverify flush with its 180 add_vote, each on the card and on "cpu" in
    turns."""
    store = keystore.default_store()
    vals, calls = w["vals"], light_calls(w)
    adjacent, non_adjacent = calls["verify_adjacent"], calls["verify_non_adjacent"]
    rot_id = hashlib.sha256(b"".join(v.pub_key.bytes() for v in w["rot"].validators)).digest()

    def miss():
        store.invalidate(rot_id)
        non_adjacent(None)

    t = wall_ms_turns({
        "verify_adjacent gpu": lambda: adjacent(None),
        "verify_adjacent cpu": lambda: adjacent("cpu"),
        "verify_non_adjacent gpu (hit)": lambda: non_adjacent(None),
        "verify_non_adjacent gpu (miss)": miss,
        "verify_non_adjacent cpu": lambda: non_adjacent("cpu"),
    }, runs=8)
    for label, (med, lo, hi) in t.items():
        print(f"e2e: light {label:31s} p50 {med:.3f} ms host wall (min {lo:.3f}, max {hi:.3f}), "
              f"{N_VALIDATORS} validators, in turns [{card}]")
    runs, turns = 8, 4
    pools = {b: [[commit.get_vote(i) for i in range(N_VALIDATORS)] for _ in range(runs + 1)] for b in ("gpu", "cpu")}
    t = wall_ms_turns({
        f"preverify + add_vote {b}": (lambda b=b: preverify_and_add(vals, commit.height, pools[b].pop(), b))
        for b in ("gpu", "cpu")
    }, runs=runs, turns=turns)
    for label, (med, lo, hi) in t.items():
        print(f"e2e: vote set {label:27s} p50 {med:.3f} ms host wall (min {lo:.3f}, max {hi:.3f}), "
              f"{N_VALIDATORS} precommits, in turns [{card}]")


class NoopVerifier(cryptobatch.CPUBatchVerifier):
    """Answers True for every lane without verifying: the verify plane's
    own host cost, timed with nothing behind it."""

    def verify(self):
        n = self.count()
        self._take()
        return True, [True] * n


def time_verify_plane(w, commit, window, card: str) -> None:
    """Host wall medians, in turns: the 180-precommit preverify flush
    through a scheduler over a supervisor over "gpu" (the node's 500 µs
    deadline, audit off: the plane's own cost), on bare "gpu" and on
    "cpu"; the same flush through the plane over a verifier that verifies
    nothing, its own cost; and the four call sites' round from four
    threads through that plane, and through a plane at every default a
    node takes (5% background audit, 200% hedge, 8,192-lane budget),
    against the same four one after another through the first plane and
    on bare "gpu", counting the interpreter's full collections."""
    sched, sup, flushes = build_plane(audit_pct=0, flush_us=500)
    node_sup = supervisor.BackendSupervisor(spec="gpu")
    node = scheduler.VerifyScheduler(spec="gpu", supervisor=node_sup)
    node.start()
    try:
        items = precommits(w["vals"], commit)
        t = wall_ms_turns({
            "scheduler + supervisor": lambda: flush_tagged(items, sched, "consensus"),
            "bare gpu": lambda: flush(items, "gpu"),
            "cpu": lambda: flush(items, "cpu"),
        }, runs=8, turns=4)
        for label, (med, lo, hi) in t.items():
            print(f"e2e: verify plane preverify flush {label:22s} p50 {med:.3f} ms host wall (min {lo:.3f}, "
                  f"max {hi:.3f}), {N_VALIDATORS} precommits, in turns [{card}]")
        cryptobatch.register_backend("plane-noop", NoopVerifier)
        noop_sup = supervisor.BackendSupervisor(spec="plane-noop", audit_pct=0, hedge_pct=0)
        noop = scheduler.VerifyScheduler(spec="plane-noop", supervisor=noop_sup, flush_us=500)
        noop.start()
        try:
            t = wall_ms_turns({
                "scheduler + supervisor": lambda: flush_tagged(items, noop, "consensus"),
                "supervisor": lambda: noop_sup.verify_items(items),
                "bare": lambda: flush(items, "plane-noop"),
            }, runs=40, turns=4)
        finally:
            noop.stop()
            noop_sup.stop()
        for label, (med, lo, hi) in t.items():
            print(f"e2e: verify plane's own cost, a verifier that verifies nothing, {label:22s} p50 {med:.3f} ms "
                  f"host wall (min {lo:.3f}, max {hi:.3f}), {N_VALIDATORS} lanes, in turns [{card}]")
        base = (sched.metrics.requests.value(), sched.n_dispatches)
        full = {"n": 0, "ms": 0.0, "t0": 0.0}

        def on_gc(phase, info):
            if info["generation"] == 2 and phase == "start":
                full["t0"] = time.perf_counter()
            elif info["generation"] == 2:
                full["n"] += 1
                full["ms"] += (time.perf_counter() - full["t0"]) * 1e3

        gc.callbacks.append(on_gc)
        try:
            t = wall_ms_turns({
                "coalesced (four threads, one plane)": lambda: call_site_round(w, commit, window, sched, threaded=True),
                "coalesced (four threads, node defaults)": lambda: call_site_round(w, commit, window, node,
                                                                                   threaded=True),
                "serial (one thread, one plane)": lambda: call_site_round(w, commit, window, sched, threaded=False),
                "serial (one thread, bare gpu)": lambda: call_site_round(w, commit, window, "gpu", threaded=False),
            }, runs=4, turns=4)
        finally:
            gc.callbacks.remove(on_gc)
        requests, dispatches = sched.metrics.requests.value() - base[0], sched.n_dispatches - base[1]
        for s, label in ((sup, "the timing plane"), (node_sup, "the plane at node defaults")):
            check(s.state() == supervisor.HEALTHY and s.metrics.cpu_verdicts.value() == 0
                  and s.metrics.audit_mismatches.value() == 0,
                  f"{label} fell back: {s.state()}, {s.metrics.cpu_verdicts.value()} CPU-released batches, "
                  f"{s.metrics.audit_mismatches.value()} audit mismatches")
        for label, (med, lo, hi) in t.items():
            print(f"e2e: verify plane round {label:40s} p50 {med:.3f} ms host wall (min {lo:.3f}, max {hi:.3f}), "
                  f"consensus {N_VALIDATORS + 1} + blocksync {len(window)} + light 2 steps + evidence, in turns [{card}]")
        print(f"e2e: verify plane round: the rounds through the plane made {int(requests)} requests in {dispatches} "
              f"flushes; {sup.metrics.triage_runs.value():.0f} triage runs, "
              f"{faults_total(sup.metrics.triage_offenders):.0f} bad signatures confirmed on the CPU [{card}]")
        m = node_sup.metrics
        caps = (f"at most {supervisor.AUDIT_MAX_LANES} lanes each" if supervisor.lane_caps_apply()
                else f"every lane: CPU rung {native.rung()}")
        print(f"e2e: verify plane round at node defaults: {int(node.metrics.requests.value())} requests in "
              f"{node.n_dispatches} flushes; {m.audits.value():.0f} background audits ({caps}), "
              f"{m.hedge_fires.value():.0f} hedges fired, "
              f"{m.hedge_wins.with_labels(winner='cpu').value():.0f} won by the CPU, "
              f"{m.cpu_verdicts.value():.0f} CPU-released batches [{card}]")
        print(f"e2e: verify plane rounds above: {full['n']} full collections of the interpreter, "
              f"{full['ms']:.1f} ms in them [{card}]")
    finally:
        for s in (sched, sup, node, node_sup):
            s.stop()


def time_secp_end_to_end(svals, sblock_id, scommit, window, card: str) -> None:
    """The secp256k1 set's verify_commit on the card and on "cpu" in turns,
    its host packing alone, and the secp window's signatures per second."""

    def verify(backend):
        return lambda: svals.verify_commit(CHAIN_ID, sblock_id, scommit.height, scommit, backend=backend)

    t = wall_ms_turns({"gpu": verify("gpu"), "cpu": verify("cpu")}, runs=8)
    for label, (med, lo, hi) in t.items():
        print(f"e2e: secp256k1 verify_commit {label} p50 {med:.3f} ms host wall (min {lo:.3f}, max {hi:.3f}), "
              f"{N_VALIDATORS} validators, in turns [{card}]")
    items = precommits(svals, scommit)
    cols = [it[0].bytes() for it in items], [it[1] for it in items], [it[2] for it in items]
    s_values = [int.from_bytes(sig[32:], "big") for sig in cols[2]]
    rows = [
        ("  of which sign bytes", wall_ms(lambda: [scommit.vote_sign_bytes(CHAIN_ID, i) for i in range(len(items))], runs=20)),
        ("  of which packing (hashlib, s^-1)", wall_ms(lambda: secp256k1_batch.prepare_batch(*cols), runs=20)),
        ("    of which pow(s, -1, n)", wall_ms(lambda: [pow(s, -1, secp.N) for s in s_values], runs=20)),
        ("  of which verify_batch", wall_ms(lambda: secp256k1_batch.verify_batch(*cols), runs=20)),
        ("secp256k1 flush gpu", wall_ms(lambda: flush(items, None), runs=20)),
    ]
    for label, ms in rows:
        print(f"e2e: {label:34s} p50 {ms:.3f} ms host wall, {N_VALIDATORS} validators [{card}]")
    w = wall_ms_turns({"four chunks": lambda: flush(window, None)}, runs=4, turns=4)
    ms, lo, hi = w["four chunks"]
    print(f"e2e: secp window {BIG_BATCH} lanes, four chunks p50 {ms:.3f} ms host wall (min {lo:.3f}, max {hi:.3f}) "
          f"= {BIG_BATCH / ms * 1e3:.0f} signatures/s [{card}]")


def time_sr_end_to_end(sr_lanes, sr_timing, card: str) -> None:
    """The sr flush on the card and on "cpu" in turns, its packing alone,
    and the sr window's signatures per second (from its one timed pass on
    the main path)."""
    t = wall_ms_turns({"gpu": lambda: flush(sr_lanes, None), "cpu": lambda: flush(sr_lanes, "cpu")}, runs=3, turns=3)
    for label, (med, lo, hi) in t.items():
        print(f"e2e: sr25519 flush {label} p50 {med:.3f} ms host wall (min {lo:.3f}, max {hi:.3f}), "
              f"{len(sr_lanes)} lanes, in turns [{card}]")
    cols = lane_columns(sr_lanes)
    ms = wall_ms(lambda: sr25519_batch.prepare_batch(*cols), runs=5)
    print(f"e2e: {'  of which packing (merlin)':34s} p50 {ms:.3f} ms host wall, {len(sr_lanes)} lanes [{card}]")
    wall, packing = sr_timing["window_s"], sr_timing["packing_s"]
    print(f"e2e: sr window {SR_WINDOW} lanes, one chunk, one pass {wall * 1e3:.3f} ms host wall "
          f"(packing {packing * 1e3:.3f} ms) = {SR_WINDOW / wall:.0f} signatures/s [{card}]")


def time_block_execution(card: str) -> None:
    """The block-execution chain on "gpu" and on "cpu", a fresh chain a
    run, in turns (the validator sets stay resident in the key store
    from the main path's run), and the card's idle share over the
    BLOCK_HEIGHTS heights of one more "gpu" run under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    keys = block_keys()
    runs = {"gpu": [], "cpu": []}
    for turn in range(4):
        for backend in (("gpu", "cpu") if turn % 2 == 0 else ("cpu", "gpu")):
            t0 = time.perf_counter()
            chain, _, splits, _ = run_block_chain(backend, keys)
            wall = (time.perf_counter() - t0) * 1e3
            chain.stop()
            runs[backend].append((wall, {k: sum(t[k] for t in splits.values()) for k in splits[1]}))
    for backend, got in runs.items():
        wall = statistics.median(w for w, _ in got)
        split = {k: statistics.median(t[k] for _, t in got) for k in got[0][1]}
        print(f"e2e: block execution on \"{backend}\": {BLOCK_HEIGHTS} heights p50 {wall:.3f} ms host wall "
              f"(proposing and signing included); apply_block {split['apply']:.3f} ms over the heights "
              f"(validate_block {split['validate']:.3f}, verify_commit {split['verify']:.3f}, "
              f"exec_block_on_proxy_app {split['exec']:.3f}, state saves {split['saves']:.3f}, "
              f"other {split['other']:.3f}), save_block {split['save_block']:.3f}; 4 runs in turns, "
              f"CPU rung {native.rung()} [{card}]")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chain, _, splits, _ = run_block_chain("gpu", keys)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    chain.stop()
    events = prof.key_averages()
    busy_us = sum(getattr(e, "self_device_time_total", 0) for e in events)
    if busy_us <= 0:
        print(f"profile: block execution, {BLOCK_HEIGHTS} heights on \"gpu\": device time not measured "
              f"(the trace holds no device events) [{card}]")
        return
    top = sorted(events, key=lambda e: getattr(e, "self_device_time_total", 0), reverse=True)[:3]
    shares = ", ".join(f"{e.key[:40]} {e.self_device_time_total / busy_us:.1%}" for e in top)
    apply_ms = sum(t["apply"] for t in splits.values())
    print(f"profile: block execution, {BLOCK_HEIGHTS} heights on \"gpu\": wall {wall:.3f} ms (apply_block "
          f"{apply_ms:.3f}), device busy {busy_us / 1e3:.3f} ms, idle share {1 - busy_us / 1e3 / wall:.1%} of the "
          f"heights ({1 - busy_us / 1e3 / apply_ms:.1%} of apply_block); device time: {shares} [{card}]")


def time_native_rung(w, commit, window, card: str) -> None:
    """The CPU ladder's live rung, and on it the CPU work that PERF.md
    timed on pure Python: the healthy verify-plane round's synchronous
    audit (its CPU check of the round's window and precommits), the
    180-lane preverify flush on "cpu", and the host challenge
    h = SHA-512(R || A || M) mod L of 16,384 lanes, native and the Python
    loop in turns."""
    print(f"native: CPU rung {native.rung()} ({native.why()}); {json.dumps(native.stats())} [{card}]")
    lanes = window + precommits(w["vals"], commit)
    audit = wall_ms(lambda: flush(lanes, "cpu"), runs=3)
    pre = precommits(w["vals"], commit)
    t_pre = wall_ms(lambda: flush(pre, "cpu"), runs=20)
    print(f"p6: the synchronous audit's CPU check of {len(lanes)} lanes (the healthy round's window and "
          f"precommits) p50 {audit:.3f} ms host wall; the {len(pre)}-lane preverify flush on \"cpu\" p50 "
          f"{t_pre:.3f} ms; CPU rung {native.rung()} [{card}]")
    pk_arr, sig_arr, valid = ed25519_batch._parse_inputs([pk.bytes() for pk, _, _ in window],
                                                         [sig for _, _, sig in window])
    msgs = [msg for _, msg, _ in window]
    floor = ed25519_batch.NATIVE_CHALLENGE_MIN_LANES

    def python_loop():
        ed25519_batch.NATIVE_CHALLENGE_MIN_LANES = 1 << 30
        try:
            return ed25519_batch._challenge_scalars(pk_arr, sig_arr, msgs, valid)
        finally:
            ed25519_batch.NATIVE_CHALLENGE_MIN_LANES = floor

    check(np.array_equal(ed25519_batch._challenge_scalars(pk_arr, sig_arr, msgs, valid), python_loop()),
          "the native challenges differ from the Python loop")
    t = wall_ms_turns({
        "native": lambda: ed25519_batch._challenge_scalars(pk_arr, sig_arr, msgs, valid),
        "python loop": python_loop,
    }, runs=8, turns=4)
    for label, (med, lo, hi) in t.items():
        print(f"p6: _challenge_scalars of {len(msgs)} lanes, {label:11s} p50 {med:.3f} ms host wall (min {lo:.3f}, "
              f"max {hi:.3f}), {os.cpu_count()} host cores, in turns [{card}]")


def profile_commit(vals, block_id, commit, card: str, calls: int = 10, label: str = "resident, hit") -> None:
    """The device's busy and idle share over back-to-back verify_commit
    calls, from a torch.profiler trace of the card."""
    from torch.profiler import ProfilerActivity, profile

    def verify():
        vals.verify_commit(CHAIN_ID, block_id, commit.height, commit)

    verify()  # warm: an Ed25519 set is resident from here on
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            verify()
        torch.cuda.synchronize()
        wall_ms_total = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy_us = sum(getattr(e, "self_device_time_total", 0) for e in events)
    if busy_us <= 0:
        print(f"profile: {calls} verify_commit calls ({label}), device time not measured (the trace holds no device events) [{card}]")
        return
    top = sorted(events, key=lambda e: getattr(e, "self_device_time_total", 0), reverse=True)[:3]
    shares = ", ".join(f"{e.key[:40]} {e.self_device_time_total / busy_us:.1%}" for e in top)
    print(f"profile: {calls} verify_commit calls ({label}): wall {wall_ms_total:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / 1e3 / wall_ms_total:.1%}; device time: {shares} [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card)
    print(f"native: CPU rung {native.rung()} ({native.why()}) [{card}]")
    dev = torch.device("cuda")
    torch.manual_seed(SEED)

    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(built)}; each library's own: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(built.items())))
    print(f"phase: build {time.perf_counter() - t0:.1f} s")
    for name in build.SOURCES:
        with open(build.log_path(name), encoding="utf-8") as f:
            for line in f:
                if any(k in line for k in ("entry function", "Function properties", "registers", "spill", "stack frame")):
                    print(f"build: {name}: {line.strip()}")

    t0 = time.perf_counter()
    vals, block_id, commit = make_valset_and_commit()
    print(f"main: {N_VALIDATORS} validators signed in {time.perf_counter() - t0:.1f} s, total power {vals.total_voting_power()}")
    t0 = time.perf_counter()
    svals, sblock_id, scommit = make_valset_and_commit(secp, b"cosmoshub-secp-val-%d")
    print(f"main: {N_VALIDATORS} secp256k1 validators signed in {time.perf_counter() - t0:.1f} s (pure Python), "
          f"total power {svals.total_voting_power()}")
    t0 = time.perf_counter()
    sr_lanes = make_sr_lanes(commit)
    print(f"main: {N_VALIDATORS} sr25519 keys signed in {time.perf_counter() - t0:.1f} s (pure Python)")
    t0 = time.perf_counter()
    world = call_site_world(vals)
    world["conflicting"] = conflicting_vote(vals, commit, world["keys"])
    print(f"main: the light chain and the attack (5 commits of {N_VALIDATORS}) signed in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    errs = {
        "ed25519_verify_compact": check_ed25519(dev),
        "ed25519_key_tables": check_key_tables(dev, vals),
        "ed25519_verify_resident": check_resident(dev, vals, commit),
        "ed25519_verify_full_compact": check_full_compact(dev),
        "sha256_blocks": check_sha256(dev),
        "secp256k1_verify": check_secp(dev),
        "sr25519_verify": check_sr25519(dev),
    }
    errs.update(check_merkle(dev))
    errs.update(check_words(dev))
    print(f"phase: kernels {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches, per_call, sr_timing = run_main_path(vals, block_id, commit, svals, sblock_id, scommit, sr_lanes, world)
    print(f"main: every path in {time.perf_counter() - t0:.1f} s")
    print(f"phase: main {time.perf_counter() - t0:.1f} s")
    for name in sorted({k for kernels in PATHS.values() for k in kernels}):
        check(launches[name] > 0, f"{name} was not launched on the main path")
    print(f"main: launches {json.dumps(launches)}")
    print(f"main: launches per call {json.dumps(per_call)}")

    t_times = time.perf_counter()
    window, _ = window_items(vals, commit)
    time_end_to_end(vals, block_id, commit, window, card)
    profile_commit(vals, block_id, commit, card)
    t0 = time.perf_counter()
    time_call_sites(world, commit, card)
    print(f"time: the call sites' timings took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    time_verify_plane(world, commit, window, card)
    print(f"time: the verify plane's timings took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    time_native_rung(world, commit, window, card)
    time_block_execution(card)
    print(f"time: the native rung's and block execution's timings took {time.perf_counter() - t0:.1f} s")
    s_window, _ = secp_window_items(svals, scommit)
    t0 = time.perf_counter()
    time_secp_end_to_end(svals, sblock_id, scommit, s_window, card)
    profile_commit(svals, sblock_id, scommit, card, label="secp256k1, add/verify")
    print(f"time: the secp256k1 end-to-end timings took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    time_sr_end_to_end(sr_lanes, sr_timing, card)
    print(f"time: the sr25519 end-to-end timings took {time.perf_counter() - t0:.1f} s")
    times = time_kernels(vals, commit, card, errs)
    times.update(time_secp_kernel(svals, scommit, card, errs))
    int_rate = int32_ops_per_s()
    times.update(time_sr_kernel(sr_lanes, card, errs, int_rate))
    times.update(time_words_kernels(vals, commit, card, errs, int_rate))
    group_sweep(vals, commit, svals, scommit, card)
    for name, sweep in core_group_sweep(vals, commit, sr_lanes, card).items():
        times[name].update(sweep)
    print(f"phase: times {time.perf_counter() - t_times:.1f} s")
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
