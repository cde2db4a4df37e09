"""The port stands alone: importing it, or chip_smoke.py, loads neither JAX
nor any module of the reference package, and nothing falls back to the CPU
when the card is missing: not the entry points, not the verify plane
(a supervisor or scheduler over "gpu" raises when it is built), and not
block execution (a ``BlockExecutor`` over "gpu" raises when it is built).

The import check runs in a fresh interpreter, so what this test process
has already imported (the JAX package, through tests/conftest.py) does not
hide anything. One test runs every check (see tests/test_torch_field.py
for why each of these files holds one test).
"""

import os
import pkgutil
import re
import shutil
import subprocess
import sys

import torch

import cometbft_tpu_torch
from cometbft_tpu_torch import native
from cometbft_tpu_torch.crypto import batch as port_batch
from cometbft_tpu_torch.crypto import ed25519 as ed
from cometbft_tpu_torch.crypto import purepy
from cometbft_tpu_torch.crypto import sr25519 as sr
from cometbft_tpu_torch.crypto.cuda import ed25519_batch, sr25519_batch
from cometbft_tpu_torch.light import verifier as light_verifier
from cometbft_tpu_torch.proto.gogo import Timestamp
from cometbft_tpu_torch.proto.version import BLOCK_PROTOCOL, ConsensusVersion
from cometbft_tpu_torch.types.block import (
    BLOCK_ID_FLAG_COMMIT,
    BlockID,
    Commit,
    CommitSig,
    Header,
    PartSetHeader,
)
from cometbft_tpu_torch.types.light_block import SignedHeader
from cometbft_tpu_torch.types.validator import Validator
from cometbft_tpu_torch.types.validator_set import ValidatorSet

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_ROOT, "cometbft_tpu_torch")
_SMOKE = os.path.join(_ROOT, "chip_smoke.py")


def _run(args, cwd=_ROOT):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )


def check_imports_in_a_fresh_interpreter(tmp_path):
    mods = sorted(
        m.name
        for m in pkgutil.walk_packages(cometbft_tpu_torch.__path__, "cometbft_tpu_torch.")
    )
    assert {
        "cometbft_tpu_torch.abci.types",
        "cometbft_tpu_torch.abci.application",
        "cometbft_tpu_torch.abci.client",
        "cometbft_tpu_torch.abci.kvstore",
        "cometbft_tpu_torch.libs.amino_json",
        "cometbft_tpu_torch.libs.db",
        "cometbft_tpu_torch.libs.fail",
        "cometbft_tpu_torch.libs.pubsub",
        "cometbft_tpu_torch.libs.pubsub.pubsub",
        "cometbft_tpu_torch.libs.pubsub.query",
        "cometbft_tpu_torch.native",
        "cometbft_tpu_torch.proxy",
        "cometbft_tpu_torch.state",
        "cometbft_tpu_torch.state.execution",
        "cometbft_tpu_torch.state.metrics",
        "cometbft_tpu_torch.state.store",
        "cometbft_tpu_torch.state.validation",
        "cometbft_tpu_torch.store",
        "cometbft_tpu_torch.store.block_store",
        "cometbft_tpu_torch.types.event_bus",
        "cometbft_tpu_torch.types.genesis",
        "cometbft_tpu_torch.types.params",
        "cometbft_tpu_torch.types.priv_validator",
        "cometbft_tpu_torch.types.proposal",
        "cometbft_tpu_torch.version",
        "cometbft_tpu_torch.crypto.cuda.topology",
        "cometbft_tpu_torch.crypto.decisions",
        "cometbft_tpu_torch.crypto.faults",
        "cometbft_tpu_torch.crypto.qos",
        "cometbft_tpu_torch.crypto.scheduler",
        "cometbft_tpu_torch.crypto.supervisor",
        "cometbft_tpu_torch.libs.log",
        "cometbft_tpu_torch.libs.metrics",
        "cometbft_tpu_torch.libs.service",
        "cometbft_tpu_torch.libs.trace",
        "cometbft_tpu_torch.crypto.cuda.ed25519_batch",
        "cometbft_tpu_torch.crypto.cuda.sr25519_batch",
        "cometbft_tpu_torch.crypto.merkle",
        "cometbft_tpu_torch.crypto.merlin",
        "cometbft_tpu_torch.crypto.sr25519",
        "cometbft_tpu_torch.evidence.verify",
        "cometbft_tpu_torch.libs.bits",
        "cometbft_tpu_torch.light.errors",
        "cometbft_tpu_torch.light.verifier",
        "cometbft_tpu_torch.proto.gogo",
        "cometbft_tpu_torch.proto.version",
        "cometbft_tpu_torch.types.block",
        "cometbft_tpu_torch.types.evidence",
        "cometbft_tpu_torch.types.light_block",
        "cometbft_tpu_torch.types.part_set",
        "cometbft_tpu_torch.types.tx",
        "cometbft_tpu_torch.types.validator_set",
        "cometbft_tpu_torch.types.vote",
        "cometbft_tpu_torch.types.vote_set",
    } <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cometbft_tpu'))\n"
        "print('BAD', bad)\n"
    )
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "BAD []" in r.stdout, r.stdout


def check_no_import_statement_names_them(tmp_path):
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|cometbft_tpu)\b(?!_torch)", re.M)
    files = [_SMOKE]
    for base, _, names in os.walk(_PKG):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    offenders = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            if pattern.search(f.read()):
                offenders.append(os.path.relpath(path, _ROOT))
    assert offenders == []


def check_gpu_backend_raises_without_a_card(tmp_path):
    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        port_batch.new_batch_verifier("gpu")
    except RuntimeError as e:
        assert "CUDA device" in str(e)
    else:
        raise AssertionError("the gpu backend was built without a CUDA device")
    finally:
        torch.cuda.is_available = real


def check_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """With no backend or device named, verification and hashing go to the
    card, so without one they raise instead of running on the CPU: the
    commit and flush entry points, ``ValidatorSet.hash``, the sr25519
    batch, and the Ed25519 batch on the word wire."""
    priv = ed.gen_priv_key_from_secret(b"isolation")
    vals = ValidatorSet([Validator.new(priv.pub_key(), 10)])
    block_id = BlockID(b"\x01" * 32, PartSetHeader(1, b"\x02" * 32))
    commit = Commit(height=1, round=0, block_id=block_id)
    commit.signatures.append(
        CommitSig(BLOCK_ID_FLAG_COMMIT, vals.validators[0].address, Timestamp(1, 0), b"")
    )
    commit.signatures[0].signature = priv.sign(commit.vote_sign_bytes("c", 0))
    vals.verify_commit("c", block_id, 1, commit, backend="cpu")
    assert vals.hash(device="cpu") == vals.hash(device=None)
    sr_key = sr.gen_priv_key_from_secret(b"isolation")
    sr_lane = ([sr_key.pub_key().bytes()], [b"m"], [sr_key.sign(b"m")])
    assert sr25519_batch.verify_batch(*sr_lane, device="cpu") == [True]
    ed_lane = ([priv.pub_key().bytes()], [b"m"], [priv.sign(b"m")])
    monkeypatch.setenv("CBFT_TPU_WIRE", "words")
    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        for what, fn in (
            ("verify_commit", lambda: vals.verify_commit("c", block_id, 1, commit)),
            ("new_batch_verifier", port_batch.new_batch_verifier),
            ("hash", vals.hash),
            ("sr25519 verify_batch", lambda: sr25519_batch.verify_batch(*sr_lane)),
            ("ed25519 verify_batch, word wire", lambda: ed25519_batch.verify_batch(*ed_lane)),
        ):
            try:
                fn()
            except (RuntimeError, AssertionError) as e:
                assert "CUDA" in str(e), (what, e)
            else:
                raise AssertionError(f"{what} ran without a CUDA device")
    finally:
        torch.cuda.is_available = real


def check_light_verifier_needs_the_card(tmp_path, monkeypatch):
    """``light.verifier.verify_adjacent`` under the default backend raises
    without a card, before any signature or the validator set's hash runs
    on the host; under "cpu" the same call verifies."""
    priv = ed.gen_priv_key_from_secret(b"isolation-light")
    vals = ValidatorSet([Validator.new(priv.pub_key(), 10)])
    vals_hash = vals.hash(device="cpu")
    signed = []
    for height in (1, 2):
        hdr = Header(
            version=ConsensusVersion(BLOCK_PROTOCOL, 0), chain_id="c", height=height,
            time=Timestamp(1_000 + height, 0), validators_hash=vals_hash,
            next_validators_hash=vals_hash, proposer_address=vals.validators[0].address,
        )
        block_id = BlockID(hdr.hash(), PartSetHeader(1, b"\x02" * 32))
        commit = Commit(height=height, round=0, block_id=block_id)
        commit.signatures.append(CommitSig(BLOCK_ID_FLAG_COMMIT, vals.validators[0].address, hdr.time, b""))
        commit.signatures[0].signature = priv.sign(commit.vote_sign_bytes("c", 0))
        signed.append(SignedHeader(hdr, commit))
    args = (signed[0], signed[1], vals, 10**12, Timestamp(1_010, 0), 10**9)
    light_verifier.verify_adjacent(*args, backend="cpu")
    ran = []
    monkeypatch.setattr(purepy, "ed25519_verify", lambda *a: ran.append("signature"))
    monkeypatch.setattr(native, "ed25519_verify_batch", lambda *a, **k: ran.append("signature"))
    real_hash = ValidatorSet.hash
    monkeypatch.setattr(ValidatorSet, "hash", lambda self, device="cuda": ran.append(("hash", device)) or real_hash(self, device))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        light_verifier.verify_adjacent(*args)
    except RuntimeError as e:
        assert "CUDA" in str(e)
    else:
        raise AssertionError("verify_adjacent ran without a CUDA device")
    # only the header's own 14-leaf hash ran, on the host as in the
    # reference: no signature, and the validator set was not hashed
    assert ran == [], ran


def check_verify_plane_needs_the_card(tmp_path):
    """With CUDA_VISIBLE_DEVICES="", a supervisor or a scheduler over "gpu"
    (named, by default, or behind a fault plan) raises at construction,
    before any item is queued or any signature is verified on the host;
    so does a device topology's detect()."""
    code = (
        "import torch\n"
        "from cometbft_tpu_torch.crypto import faults, purepy\n"
        "ran = []\n"
        "purepy.ed25519_verify = lambda *a: ran.append(a)\n"
        "from cometbft_tpu_torch import native\n"
        "native.ed25519_verify_batch = lambda *a, **k: ran.append(a)\n"
        "from cometbft_tpu_torch.crypto.scheduler import VerifyScheduler\n"
        "from cometbft_tpu_torch.crypto.supervisor import BackendSupervisor\n"
        "from cometbft_tpu_torch.crypto.cuda.topology import DeviceTopology\n"
        "faults.install(name='faulty-gpu', inner='gpu')\n"
        "cases = {\n"
        "    'supervisor gpu': lambda: BackendSupervisor('gpu', audit_pct=100, audit_sync=True),\n"
        "    'supervisor default': BackendSupervisor,\n"
        "    'supervisor faulty gpu': lambda: BackendSupervisor('faulty-gpu'),\n"
        "    'scheduler gpu': lambda: VerifyScheduler('gpu'),\n"
        "    'scheduler default': VerifyScheduler,\n"
        "    'detect': DeviceTopology.detect,\n"
        "}\n"
        "for name, fn in cases.items():\n"
        "    try:\n"
        "        fn()\n"
        "        print(name, 'built')\n"
        "    except RuntimeError as e:\n"
        "        print(name, 'raised', 'CUDA' in str(e))\n"
        "print('AVAILABLE', torch.cuda.is_available(), 'VERIFIED', len(ran))\n"
    )
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert lines[-1] == "AVAILABLE False VERIFIED 0", r.stdout
    assert len(lines) == 7 and all(line.endswith(" raised True") for line in lines[:-1]), r.stdout


def check_verify_plane_needs_its_kernels(tmp_path):
    """A kernel that does not build is never answered from the CPU. With a
    card reported present and an nvcc that fails, a supervisor or a
    scheduler over "gpu" (or behind a fault plan) raises the build error
    at construction; a build error that a dispatch meets later reaches
    the caller of the supervisor, of a bare scheduler and of a scheduler
    over a supervisor, with no CPU verdict, fallback or breaker strike."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'nvcc fatal: injected failure' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    code = (
        "import os, torch\n"
        f"os.environ['NVCC'] = {str(nvcc)!r}\n"
        "from cometbft_tpu_torch.crypto import batch, ed25519, faults, purepy\n"
        "from cometbft_tpu_torch.crypto.cuda import build\n"
        f"build.BUILD_DIR = {str(tmp_path / 'build')!r}\n"
        "ran = []\n"
        "purepy.ed25519_verify = lambda *a: ran.append(a)\n"
        "from cometbft_tpu_torch import native\n"
        "native.ed25519_verify_batch = lambda *a, **k: ran.append(a)\n"
        "from cometbft_tpu_torch.crypto import scheduler, supervisor\n"
        "from cometbft_tpu_torch.crypto.cuda.topology import DeviceTopology\n"
        "from cometbft_tpu_torch.libs.metrics import Registry\n"
        "torch.cuda.is_available = lambda: True\n"
        "faults.install(name='faulty-gpu', inner='gpu')\n"
        "cases = {\n"
        "    'supervisor gpu': lambda: supervisor.BackendSupervisor('gpu'),\n"
        "    'supervisor faulty gpu': lambda: supervisor.BackendSupervisor('faulty-gpu'),\n"
        "    'scheduler gpu': lambda: scheduler.VerifyScheduler('gpu'),\n"
        "}\n"
        "for name, fn in cases.items():\n"
        "    try:\n"
        "        fn()\n"
        "        print(name, 'built')\n"
        "    except build.BuildError as e:\n"
        "        print(name, 'raised', 'injected failure' in str(e))\n"
        "class LateBuild(batch.BatchVerifier):\n"
        "    def add(self, *item): pass\n"
        "    def verify(self): raise build.BuildError('nvcc failed for x: injected failure')\n"
        "batch.register_backend('late-build', LateBuild)\n"
        "k = ed25519.gen_priv_key_from_secret(b'k')\n"
        "items = [(k.pub_key(), b'm%d' % i, k.sign(b'm%d' % i)) for i in range(4)]\n"
        "def plane(with_scheduler, with_supervisor):\n"
        "    sup = supervisor.BackendSupervisor('late-build', audit_pct=100, audit_sync=True,\n"
        "        hedge_pct=0, metrics=supervisor.Metrics(Registry()), topology=DeviceTopology.virtual(1))\n"
        "    sched = scheduler.VerifyScheduler('late-build', metrics=scheduler.Metrics(Registry()),\n"
        "        supervisor=sup if with_supervisor else None, flush_us=1000)\n"
        "    sched.start()\n"
        "    try:\n"
        "        if with_scheduler:\n"
        "            sched.submit(items, subsystem='consensus').result(30)\n"
        "        else:\n"
        "            sup.verify_items(items)\n"
        "        out = 'released'\n"
        "    except build.BuildError as e:\n"
        "        out = 'raised %s' % ('injected failure' in str(e))\n"
        "    sched.stop()\n"
        "    sup.stop()\n"
        "    return out, sup.metrics.cpu_verdicts.value(), sup.state(), sched.metrics.cpu_fallbacks.value()\n"
        "for name, w in {'dispatch supervisor': (False, True), 'dispatch scheduler': (True, False),\n"
        "                'dispatch scheduler over supervisor': (True, True)}.items():\n"
        "    print(name, *plane(*w))\n"
        "print('VERIFIED', len(ran))\n"
    )
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.splitlines() == [
        "supervisor gpu raised True",
        "supervisor faulty gpu raised True",
        "scheduler gpu raised True",
        "dispatch supervisor raised True 0.0 healthy 0.0",
        "dispatch scheduler raised True 0.0 healthy 0.0",
        "dispatch scheduler over supervisor raised True 0.0 healthy 0.0",
        "VERIFIED 0",
    ], r.stdout + r.stderr[-2000:]


def check_block_executor_needs_the_card(tmp_path):
    """``BlockExecutor`` over ``"gpu"`` (named or by default) raises when it
    is built without a card, and with a card reported present and an nvcc
    that fails it raises the build error; under ``"cpu"`` it is built. No
    signature is verified on the host either way."""
    nvcc = tmp_path / "nvcc-block"
    nvcc.write_text("#!/bin/sh\necho 'nvcc fatal: injected failure' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    code = (
        "import os, torch\n"
        f"os.environ['NVCC'] = {str(nvcc)!r}\n"
        "from cometbft_tpu_torch import native\n"
        "from cometbft_tpu_torch.crypto import purepy\n"
        "from cometbft_tpu_torch.crypto.cuda import build\n"
        f"build.BUILD_DIR = {str(tmp_path / 'build-block')!r}\n"
        "ran = []\n"
        "purepy.ed25519_verify = lambda *a: ran.append(a)\n"
        "native.ed25519_verify_batch = lambda *a, **k: ran.append(a)\n"
        "from cometbft_tpu_torch.abci.client import new_local_client_creator\n"
        "from cometbft_tpu_torch.abci.kvstore import KVStoreApplication\n"
        "from cometbft_tpu_torch.libs.db import MemDB\n"
        "from cometbft_tpu_torch.proxy import new_app_conns\n"
        "from cometbft_tpu_torch.state.execution import BlockExecutor\n"
        "from cometbft_tpu_torch.state.store import Store\n"
        "conns = new_app_conns(new_local_client_creator(KVStoreApplication()))\n"
        "conns.start()\n"
        "def make(**kw):\n"
        "    return BlockExecutor(Store(MemDB()), conns.consensus(), **kw)\n"
        "cases = {'default': make, 'gpu': lambda: make(crypto_backend='gpu'),\n"
        "         'cpu': lambda: make(crypto_backend='cpu')}\n"
        "for card in (False, True):\n"
        "    torch.cuda.is_available = lambda: card\n"
        "    for name, fn in cases.items():\n"
        "        try:\n"
        "            fn()\n"
        "            print(card, name, 'built')\n"
        "        except build.BuildError as e:\n"
        "            print(card, name, 'build error', 'injected failure' in str(e))\n"
        "        except RuntimeError as e:\n"
        "            print(card, name, 'raised', 'CUDA' in str(e))\n"
        "conns.stop()\n"
        "print('VERIFIED', len(ran))\n"
    )
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.splitlines() == [
        "False default raised True",
        "False gpu raised True",
        "False cpu built",
        "True default build error True",
        "True gpu build error True",
        "True cpu built",
        "VERIFIED 0",
    ], r.stdout + r.stderr[-2000:]


def check_chip_smoke_fails_without_a_card(tmp_path):
    r = _run([_SMOKE])
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def check_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(_SMOKE, tmp_path / "chip_smoke.py")
    r = _run([str(tmp_path / "chip_smoke.py")], cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_port_is_isolated_and_never_falls_back(tmp_path, monkeypatch):
    check_imports_in_a_fresh_interpreter(tmp_path)
    check_no_import_statement_names_them(tmp_path)
    check_gpu_backend_raises_without_a_card(tmp_path)
    with monkeypatch.context() as m:
        check_entry_points_default_to_the_card(tmp_path, m)
    with monkeypatch.context() as m:
        check_light_verifier_needs_the_card(tmp_path, m)
    check_verify_plane_needs_the_card(tmp_path)
    check_verify_plane_needs_its_kernels(tmp_path)
    check_block_executor_needs_the_card(tmp_path)
    check_chip_smoke_fails_without_a_card(tmp_path)
    check_chip_smoke_fails_without_the_repo(tmp_path)
