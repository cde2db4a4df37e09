"""The native CPU rung: Ed25519 through OpenSSL, built at first use.

Reference: cometbft_tpu/native/__init__.py. ``ed25519_batch.c`` (a copy
of the reference's) is compiled with the system ``cc`` against the
system ``libcrypto`` into ``native/build/`` the first time a verify,
sign or challenge call asks for it, and loaded with ctypes, which
releases the GIL around each call; inside, pthreads split a batch over
up to 16 threads.

The port's CPU ladder is this rung, then pure Python
(``crypto/purepy.py``). The rung is taken only when it builds, loads and
gives the same verdicts and challenges as pure Python on a fixed set of
contract cases (valid and corrupted signatures, s >= L, a non-canonical
key, x = -0, a small-order key, a non-canonical R). Otherwise the ladder
falls to pure Python: the fall is counted in ``stats()["falls"]``,
logged once, and ``rung()`` says ``"purepy"`` with ``why()`` giving the
reason. Nothing is downloaded. ``CC`` names the compiler;
``CBFT_NATIVE_ED25519=0`` turns the rung off; ``reset(build_dir=...)``
forgets the loaded library and builds into another directory (tests).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import List, Optional, Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ed25519_batch.c")
_SO_NAME = "libcbft_ed25519.so"
# build images ship a runtime libcrypto (.so.3 or .so.1.1) without the dev
# symlink or headers: try -lcrypto first, then link the runtime .so by path
# (the EVP ABI used is stable since 1.1.1); the reference's candidates
LIBCRYPTO_CANDIDATES = (
    ["-lcrypto"],
    ["/usr/lib/x86_64-linux-gnu/libcrypto.so.3"],
    ["/lib/x86_64-linux-gnu/libcrypto.so.3"],
    ["/usr/lib/x86_64-linux-gnu/libcrypto.so.1.1"],
    ["/lib/x86_64-linux-gnu/libcrypto.so.1.1"],
)
NATIVE = "native"
PUREPY = "purepy"

_log = logging.getLogger(__name__)
_lock = threading.Lock()
_build_dir = os.path.join(_HERE, "build")
_lib: Optional[ctypes.CDLL] = None
_rung: Optional[str] = None  # None until the first call decides
_why = ""
_stats = {"falls": 0, "builds": 0, "native_calls": 0, "purepy_calls": 0}


def reset(build_dir: Optional[str] = None) -> None:
    """Forget the loaded rung (the next call decides again), building
    into ``build_dir`` when given, else ``native/build/``."""
    global _lib, _rung, _why, _build_dir
    with _lock:
        _lib, _rung, _why = None, None, ""
        _build_dir = build_dir or os.path.join(_HERE, "build")


def stats() -> dict:
    return dict(_stats)


def count_purepy(n: int = 1) -> None:
    """A caller served ``n`` calls from pure Python (the native rung
    was not live)."""
    _stats["purepy_calls"] += n


def _so_path() -> str:
    return os.path.join(_build_dir, _SO_NAME)


def _build() -> str:
    """Compile the library; "" on success, else why it failed."""
    so = _so_path()
    try:
        os.makedirs(_build_dir, exist_ok=True)
        if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(_SRC):
            return ""
    except OSError as e:
        return f"build directory: {e}"
    cc = os.environ.get("CC", "cc")
    tmp = f"{so}.{os.getpid()}.tmp"
    last = "no libcrypto candidate linked"
    for libargs in LIBCRYPTO_CANDIDATES:
        cmd = [cc, "-O2", "-shared", "-fPIC", "-o", tmp, _SRC, "-pthread", *libargs]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"{cc} did not run: {e}"
        if proc.returncode == 0:
            try:
                os.replace(tmp, so)
            except OSError as e:
                return f"build output: {e}"
            _stats["builds"] += 1
            return ""
        last = f"{cc} {' '.join(libargs)}: {(proc.stderr or proc.stdout).strip()[-200:]}"
    return last


def _bind(lib: ctypes.CDLL) -> None:
    size_p = ctypes.POINTER(ctypes.c_size_t)
    u8_p = ctypes.POINTER(ctypes.c_ubyte)
    lib.cbft_ed25519_verify_batch.restype = ctypes.c_int
    lib.cbft_ed25519_verify_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, size_p, size_p, ctypes.c_char_p, u8_p,
        ctypes.c_size_t, ctypes.c_int,
    ]
    lib.cbft_ed25519_sign.restype = ctypes.c_int
    lib.cbft_ed25519_sign.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
    lib.cbft_ed25519_pub_from_seed.restype = ctypes.c_int
    lib.cbft_ed25519_pub_from_seed.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.cbft_ed25519_challenges.restype = ctypes.c_int
    lib.cbft_ed25519_challenges.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, size_p, size_p, u8_p,
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
    ]


def _fall(why: str) -> None:
    global _rung, _why
    _rung, _why = PUREPY, why
    _stats["falls"] += 1
    _log.warning("native Ed25519 rung unavailable, falling to pure Python: %s", why)


# pure Python's verdicts on _self_check_cases(), in order
# (tests/test_torch_native.py holds them against purepy.ed25519_verify)
SELF_CHECK_VERDICTS = (True, False, False, False, True, True, True, False, False)


def _self_check_cases():
    """Contract cases where an OpenSSL build could part from pure Python:
    (label, pub, msg, sig)."""
    from cometbft_tpu_torch.crypto import purepy

    seed = hashlib.sha256(b"native-self-check").digest()
    pub = purepy.ed25519_public_from_seed(seed)
    msg = b"native rung self-check"
    sig = purepy.ed25519_sign(seed, pub, msg)
    p, el = purepy.P, purepy.L
    ident = (1).to_bytes(32, "little")

    def crafted(s: int) -> bytes:  # verifies against the identity key
        return purepy.pt_encode(purepy.pt_mul(s, purepy.B)) + s.to_bytes(32, "little")

    s_over = (int.from_bytes(sig[32:], "little") + el).to_bytes(32, "little")
    bad_s = bytearray(sig)
    bad_s[40] ^= 0x80
    return [
        ("valid", pub, msg, sig),
        ("corrupt_s", pub, msg, bytes(bad_s)),
        ("corrupt_msg", pub, msg + b"!", sig),
        ("s_ge_l", pub, msg, sig[:32] + s_over),
        ("noncanonical_key", (p + 1).to_bytes(32, "little"), b"m", crafted(12345)),
        ("minus_zero_key", (1 | (1 << 255)).to_bytes(32, "little"), b"m", crafted(777)),
        ("order2_key", (p - 1).to_bytes(32, "little"), b"m", crafted(4242)),
        ("noncanonical_r", ident, b"r", (p + 1).to_bytes(32, "little") + bytes(32)),
        ("garbage_key", b"\xff" * 32, msg, sig),
    ]


def _self_check(lib: ctypes.CDLL) -> str:
    """"" when the library's verdicts and challenges equal pure Python's
    on the contract cases, else the first case where they differ."""
    from cometbft_tpu_torch.crypto import purepy

    cases = _self_check_cases()
    got = _verify_with(lib, [c[1] for c in cases], [c[2] for c in cases], [c[3] for c in cases], 1)
    if got is None:
        return "the verify entry point returned an error"
    for (label, _, _, _), v, want in zip(cases, got, SELF_CHECK_VERDICTS):
        if v != want:
            return f"its verdict differs from pure Python's on {label}"
    h = _challenges_with(
        lib, b"".join(c[1] for c in cases), b"".join(c[3][:32] for c in cases),
        [c[2] for c in cases], [True] * len(cases), 1,
    )
    for i, (label, pub, msg, sig) in enumerate(cases):
        if h is None or h[32 * i : 32 * i + 32] != purepy.sha512_mod_l(sig[:32], pub, msg).to_bytes(32, "little"):
            return f"its challenge differs from pure Python's on {label}"
    return ""


def load_ed25519() -> Optional[ctypes.CDLL]:
    """Build (if needed), load and check the native library; None when
    the ladder stands on pure Python."""
    global _lib, _rung, _why
    if _rung is not None:
        return _lib
    with _lock:
        if _rung is not None:
            return _lib
        if os.environ.get("CBFT_NATIVE_ED25519", "1") == "0":
            _fall("disabled by CBFT_NATIVE_ED25519=0")
            return None
        why = _build()
        if why:
            _fall(f"build failed: {why}")
            return None
        try:
            lib = ctypes.CDLL(_so_path())
            _bind(lib)
        except (OSError, AttributeError) as e:
            _fall(f"load failed: {e}")
            return None
        why = _self_check(lib)
        if why:
            _fall(f"not used: {why}")
            return None
        _lib, _rung, _why = lib, NATIVE, f"built with {os.environ.get('CC', 'cc')} against libcrypto"
        return _lib


def rung() -> str:
    """``"native"`` or ``"purepy"``: the live CPU rung (decides it now
    if no call has yet)."""
    load_ed25519()
    return _rung


def why() -> str:
    """How the live rung was reached (a build or self-check failure for
    ``"purepy"``)."""
    load_ed25519()
    return _why


def default_threads() -> int:
    return min(os.cpu_count() or 1, 16)


def _pack_msgs(msgs: Sequence[bytes]):
    """Concatenate messages into one buffer with (offset, length) arrays."""
    n = len(msgs)
    offs = (ctypes.c_size_t * n)()
    lens = (ctypes.c_size_t * n)()
    pos = 0
    parts = []
    for i, m in enumerate(msgs):
        b = bytes(m)
        parts.append(b)
        offs[i] = pos
        lens[i] = len(b)
        pos += len(b)
    return b"".join(parts), offs, lens


def _verify_with(lib, pubs, msgs, sigs, nthreads) -> Optional[List[bool]]:
    n = len(pubs)
    if n == 0:
        return []
    ok_shape = [len(pubs[i]) == 32 and len(sigs[i]) == 64 for i in range(n)]
    # malformed entries get zeroed slots so indices stay aligned
    pub_buf = b"".join(pubs[i] if ok_shape[i] else bytes(32) for i in range(n))
    sig_buf = b"".join(sigs[i] if ok_shape[i] else bytes(64) for i in range(n))
    msg_buf, offs, lens = _pack_msgs(msgs)
    out = (ctypes.c_ubyte * n)()
    if lib.cbft_ed25519_verify_batch(pub_buf, msg_buf, offs, lens, sig_buf, out, n, nthreads) != 0:
        return None
    return [bool(out[i]) and ok_shape[i] for i in range(n)]


def _challenges_with(lib, pubs, rs, msgs, valid, nthreads) -> Optional[bytes]:
    n = len(valid)
    vbuf = (ctypes.c_ubyte * n)(*[1 if v else 0 for v in valid])
    msg_buf, offs, lens = _pack_msgs([msgs[i] if valid[i] else b"" for i in range(n)])
    out = ctypes.create_string_buffer(32 * n)
    if lib.cbft_ed25519_challenges(pubs, rs, msg_buf, offs, lens, vbuf, out, n, nthreads) != 0:
        return None
    return out.raw


def ed25519_verify_batch(
    pubs: Sequence[bytes], msgs: Sequence[bytes], sigs: Sequence[bytes],
    nthreads: Optional[int] = None,
) -> Optional[List[bool]]:
    """One native call for the whole batch; None when the rung is not
    live. Entries of the wrong length are rejected without reaching
    OpenSSL, as ``PubKeyEd25519.verify_signature`` rejects them."""
    lib = load_ed25519()
    if lib is None:
        return None
    _stats["native_calls"] += 1
    return _verify_with(lib, pubs, msgs, sigs, nthreads or default_threads())


def ed25519_sign(seed: bytes, msg: bytes) -> Optional[bytes]:
    """OpenSSL's Ed25519 signature over msg; None when the rung is not live."""
    lib = load_ed25519()
    if lib is None or len(seed) != 32:
        return None
    out = ctypes.create_string_buffer(64)
    if lib.cbft_ed25519_sign(seed, msg, len(msg), out) != 0:
        return None
    return out.raw


def ed25519_pub_from_seed(seed: bytes) -> Optional[bytes]:
    """seed -> 32-byte public key; None when the rung is not live."""
    lib = load_ed25519()
    if lib is None or len(seed) != 32:
        return None
    out = ctypes.create_string_buffer(32)
    if lib.cbft_ed25519_pub_from_seed(seed, out) != 0:
        return None
    return out.raw


def ed25519_challenges(
    pubs: bytes, rs: bytes, msgs: Sequence[Optional[bytes]], valid: Sequence[bool],
    nthreads: Optional[int] = None,
) -> Optional[bytes]:
    """h = SHA-512(R || A || M) mod L for each valid lane, one native call.

    ``pubs`` and ``rs`` are the concatenated n*32-byte A and R rows; lanes
    with ``valid[i]`` False are zeros in the output. Returns the n*32
    little-endian buffer, or None when the rung is not live, the shapes
    disagree, or a valid lane has no message (callers then run the
    Python loop, which raises for the last)."""
    lib = load_ed25519()
    if lib is None:
        return None
    n = len(valid)
    if n == 0:
        return b""
    if len(pubs) != 32 * n or len(rs) != 32 * n:
        return None
    if any(valid[i] and msgs[i] is None for i in range(n)):
        return None
    _stats["native_calls"] += 1
    return _challenges_with(lib, pubs, rs, msgs, valid, nthreads or default_threads())
