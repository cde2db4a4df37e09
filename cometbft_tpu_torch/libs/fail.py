"""Fail-point injection for crash-recovery tests.

Ported from cometbft_tpu/libs/fail.py.

Reference: libs/fail/fail.go:28-46 — the env var FAIL_TEST_INDEX selects the
N-th call to fail() process-wide; when the counter hits it, the process
exits immediately (simulating a crash at that exact point). Fail points are
planted through the consensus commit path (consensus/state.go:1612-1691) and
block execution (state/execution.go:149-196).
"""

from __future__ import annotations

import os
import threading

_mtx = threading.Lock()
_call_index = -1
_fail_index = None  # lazily read from env


def _target() -> int:
    global _fail_index
    if _fail_index is None:
        v = os.environ.get("FAIL_TEST_INDEX", "")
        _fail_index = int(v) if v else -1
    return _fail_index


def reset(fail_index: int = -1) -> None:
    """Test helper: reset counter and set target in-process."""
    global _call_index, _fail_index
    with _mtx:
        _call_index = -1
        _fail_index = fail_index


def fail() -> None:
    global _call_index
    with _mtx:
        target = _target()
        if target < 0:
            return
        _call_index += 1
        if _call_index == target:
            # Simulate a hard crash. os._exit skips finalizers/flushes just
            # like the reference's os.Exit.
            os._exit(1)
