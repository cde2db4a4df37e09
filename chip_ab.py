"""Time commit verification on one NVIDIA card for two checkouts of this
repository, in turns.

    python3 chip_ab.py OTHER_CHECKOUT [TURNS]

Each turn starts one process per checkout, other then this, then this
then other, and so on for TURNS turns (default 4). A process runs on its
own tree (PYTHONPATH and working directory), builds that tree's kernels
if they are not built yet, makes chip_smoke.py's seeded 180-validator
Ed25519 and secp256k1 sets and their commits and its 180 sr25519 lanes,
warms up, and takes the median host wall on the card of
ValidatorSet.verify_commit for the Ed25519 set on the resident route
(hits) and on the keyed compact route (key store bypassed: the keys ride
the wire to ed25519_verify_compact), of the secp256k1 set's
(add()/verify()), of a new_batch_verifier("gpu") flush of the sr25519
lanes, of the Ed25519 set's first resident commit (the miss: the key store
emptied, so the call uploads the keys and builds their comb tables), and
of ValidatorSet.hash on the card and on the host, taken in turns in the
process; and the CUDA-event time a call of the tree's ed25519_key_tables
kernel for the set's 180 keys, 20 calls back to back.
Comparing two versions within one call, in turns, gives both the same
card and the same load on the host, whose Python time moves by up to 2x
between calls.

Prints one line per process, then one per checkout with the median of
its processes' medians; exits non-zero without a card or when a process
fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import torch

ED_RUNS, SECP_RUNS, SR_RUNS, MISS_RUNS, HASH_RUNS = 40, 20, 5, 20, 40

CHILD = f"""
import json, statistics, time
import numpy as np, torch
import chip_smoke as cs
from cometbft_tpu_torch.crypto import batch as cryptobatch
from cometbft_tpu_torch.crypto import secp256k1 as secp
from cometbft_tpu_torch.crypto.cuda import build, ed25519_batch, keystore

build.build_all()
vals, block_id, commit = cs.make_valset_and_commit()
svals, sblock_id, scommit = cs.make_valset_and_commit(secp, b"cosmoshub-secp-val-%d")
sr_lanes = cs.make_sr_lanes(commit)


def p50(fn, runs):
    fn()
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def keyed():
    real = cryptobatch.resident_commit_eligible, keystore.verify_batch_indexed
    cryptobatch.resident_commit_eligible = lambda n_present, backend=None: False
    keystore.verify_batch_indexed = lambda *args: None
    try:
        vals.verify_commit(cs.CHAIN_ID, block_id, commit.height, commit)
    finally:
        cryptobatch.resident_commit_eligible, keystore.verify_batch_indexed = real


ed = p50(lambda: vals.verify_commit(cs.CHAIN_ID, block_id, commit.height, commit), {ED_RUNS})
compact = p50(keyed, {ED_RUNS})
sp = p50(lambda: svals.verify_commit(cs.CHAIN_ID, sblock_id, scommit.height, scommit), {SECP_RUNS})
sr = p50(lambda: cs.flush(sr_lanes, None), {SR_RUNS})


def miss():
    keystore.default_store().invalidate()
    vals.verify_commit(cs.CHAIN_ID, block_id, commit.height, commit)


first = p50(miss, {MISS_RUNS})
hashes = cs.wall_ms_turns({{"card": lambda: vals.hash(device="cuda"), "host": lambda: vals.hash(device="cpu")}},
                          runs={HASH_RUNS})
keys = torch.from_numpy(np.frombuffer(b"".join(v.pub_key.bytes() for v in vals.validators), np.uint8)
                        .reshape(-1, 32).copy()).cuda()
ed25519_batch.key_tables_kernel(keys)
torch.cuda.synchronize()
start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
start.record()
for _ in range(20):
    ed25519_batch.key_tables_kernel(keys)
end.record()
end.synchronize()
print(json.dumps({{"ed25519": ed, "compact": compact, "secp256k1": sp, "sr25519": sr, "miss": first,
                  "hash_card": hashes["card"][0], "hash_host": hashes["host"][0],
                  "key_tables": start.elapsed_time(end) / 20}}))
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    trees = {"other": os.path.abspath(sys.argv[1]), "this": os.path.dirname(os.path.abspath(__file__))}
    turns = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    results = {name: [] for name in trees}
    for t in range(turns):
        for name in ("other", "this") if t % 2 == 0 else ("this", "other"):
            env = dict(os.environ, PYTHONPATH=trees[name])
            run = subprocess.run([sys.executable, "-c", CHILD], cwd=trees[name], env=env,
                                 capture_output=True, text=True, timeout=900)
            if run.returncode != 0:
                print(f"chip_ab: the {name} process failed:\n{run.stdout[-2000:]}\n{run.stderr[-4000:]}", file=sys.stderr)
                return 1
            res = json.loads(run.stdout.strip().splitlines()[-1])
            results[name].append(res)
            print(f"ab: turn {t} {name:5s} p50 verify_commit Ed25519 resident {res['ed25519']:.3f} ms, "
                  f"Ed25519 keyed compact route {res['compact']:.3f} ms, secp256k1 {res['secp256k1']:.3f} ms; "
                  f"sr25519 flush {res['sr25519']:.3f} ms; first resident commit (miss) {res['miss']:.3f} ms; "
                  f"ValidatorSet.hash card {res['hash_card']:.3f} ms, host {res['hash_host']:.3f} ms; "
                  f"ed25519_key_tables kernel {res['key_tables']:.4f} ms; 180 lanes [{card}]", flush=True)
    for name, rows in results.items():
        med = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
        print(f"ab: {name:5s} ({trees[name]}) median of {len(rows)} processes: verify_commit Ed25519 resident "
              f"{med['ed25519']:.3f} ms, Ed25519 keyed compact route {med['compact']:.3f} ms, secp256k1 "
              f"{med['secp256k1']:.3f} ms; sr25519 flush {med['sr25519']:.3f} ms; first resident commit (miss) "
              f"{med['miss']:.3f} ms; ValidatorSet.hash card {med['hash_card']:.3f} ms, host {med['hash_host']:.3f} "
              f"ms; ed25519_key_tables kernel {med['key_tables']:.4f} ms [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
