"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles on its own into
``build/lib<name>.so`` with a plain C interface, and is loaded with
``ctypes`` (no PyTorch headers: a file that includes them takes minutes
to compile, one with a C interface seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o build/lib<name>.so csrc/<name>.cu

A library is built at first use, or again when a source it depends on is
newer. ``build_all`` starts one ``nvcc`` per stale library, all at once,
and waits for them, noting when each one finished. The compiler's ``-Xptxas=-v`` report (registers,
spills, stack per kernel) is kept beside each library as ``<name>.log``.
Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

# library name -> (its .cu, then every header it includes)
SOURCES: Dict[str, Sequence[str]] = {
    "ed25519_verify": ("ed25519_verify.cu", "fe25519.cuh", "ge25519_group.cuh", "sc25519.cuh", "sha512.cuh"),
    "ed25519_resident": ("ed25519_resident.cu", "fe25519.cuh", "ge25519_group.cuh"),
    "sha256": ("sha256.cu", "sha256.cuh"),
    "merkle": ("merkle.cu", "sha256.cuh"),
    "secp256k1_verify": ("secp256k1_verify.cu", "fe256k1.cuh"),
    "sr25519_verify": ("sr25519_verify.cu", "fe25519.cuh", "ge25519_group.cuh"),
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

class BuildError(RuntimeError):
    """A kernel library could not be built: no ``nvcc``, or ``nvcc``
    failed. Not a device fault: the supervisor and the scheduler raise it
    to their callers and never serve verdicts from the CPU in its place."""


_lock = threading.Lock()  # loading (load builds under it, then takes _build_lock)
_build_lock = threading.Lock()  # building
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise BuildError("nvcc not found: the CUDA kernels cannot be built here")


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def log_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}.log")


def _stale(name: str) -> bool:
    so = lib_path(name)
    if not os.path.exists(so):
        return True
    built = os.path.getmtime(so)
    return any(
        os.path.getmtime(os.path.join(CSRC_DIR, src)) > built
        for src in SOURCES[name]
    )


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build every stale library in ``names`` (default: all), one nvcc
    each, started together. Returns {name: seconds} for those built;
    raises BuildError with the compiler's output if any build fails.
    Safe from several threads at once (a supervisor's dispatch, canary
    and audit threads, a caller's warm-up): one build runs at a time, and
    a library another thread has just built is no longer stale."""
    with _build_lock:
        return _build_stale(list(SOURCES if names is None else names))


def _build_stale(names: List[str]) -> Dict[str, float]:
    stale = [n for n in names if _stale(n)]
    if not stale:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in stale:
        tmp = lib_path(name) + f".{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, SOURCES[name][0])]
        with open(log_path(name), "w", encoding="utf-8") as log:
            procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp)
    seconds: Dict[str, float] = {}
    failed: List[str] = []
    while len(seconds) < len(procs):  # each library's own time: poll, do not wait in turn
        for name, (proc, tmp) in procs.items():
            if name in seconds or proc.poll() is None:
                continue
            seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                with open(log_path(name), encoding="utf-8") as f:
                    failed.append(f"{name} (rc {proc.returncode}):\n{f.read()}")
                continue
            os.replace(tmp, lib_path(name))
        time.sleep(0.05)
    if failed:
        raise BuildError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str, signatures: Dict[str, List[type]]) -> ctypes.CDLL:
    """The built library ``name`` with each C function in ``signatures``
    declared (argument types as given, an int return)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(lib_path(name))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry point's cudaGetLastError() is not 0; the
    message carries the runtime's own text for the error ("out of
    memory", "an illegal memory access was encountered"), which
    ``crypto.supervisor.classify_device_error`` reads."""
    if rc != 0:
        try:
            import torch

            text = torch.cuda.cudart().cudaGetErrorString(rc)
        except Exception:  # noqa: BLE001 - the code alone still raises
            text = "unknown"
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {rc}: {text})")


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, as the C entry points take it."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


_SM_COUNT: Dict[str, int] = {}


def group_size(batch: int, device, threads_per_sm: int, groups: Sequence[int] = (4, 2)) -> int:
    """Threads a lane for a launch of ``batch`` lanes of a grouped kernel:
    the largest G in ``groups`` with batch·G threads within the kernel's
    budget of ``threads_per_sm`` on each streaming multiprocessor of the
    card, else 1. A commit (B = 180) always gets 4 threads a lane. Where a
    batch fills the card, the budget decides: ed25519_verify_resident's
    split adds 15 doublings a thread (4% of a lane), so two warps a
    scheduler (256) pay for themselves in hidden latency;
    secp256k1_verify's split repeats a 128-doubling chain (40% of a lane
    at G = 2), so it takes one warp a scheduler (128). The wire-key cores
    (ed25519_verify.cu, sr25519_verify.cu) take 4 or 1: their G = 2 is
    slower than G = 4 at 8,192 lanes and than G = 1 at 16,384.
    chip_smoke.py's group sweeps measure each G."""
    import torch

    dev = torch.device(device)
    sms = _SM_COUNT.get(str(dev))
    if sms is None:
        sms = _SM_COUNT[str(dev)] = torch.cuda.get_device_properties(dev).multi_processor_count
    for g in groups:
        if batch * g <= sms * threads_per_sm:
            return g
    return 1


def require_cuda_tensor(t, what: str, dtype, shape_ndim: int) -> None:
    """Raise on anything a kernel does not take: the wrong dtype, rank,
    device, or a non-contiguous layout."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != shape_ndim:
        raise ValueError(f"{what}: expected {shape_ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
