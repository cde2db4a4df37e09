"""Structured leveled logger (reference: cometbft_tpu/libs/log.py, all of
it; the port's own copy).

Upstream: libs/log — go-kit style key-value logger with `tmfmt` console
format, module scoping via With(), and per-module level filtering
(libs/log/filter.go).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Dict, Optional, TextIO

LEVEL_DEBUG = 10
LEVEL_INFO = 20
LEVEL_ERROR = 40
LEVEL_NONE = 100

_LEVEL_NAMES = {LEVEL_DEBUG: "D", LEVEL_INFO: "I", LEVEL_ERROR: "E"}
_LEVELS_BY_NAME = {
    "debug": LEVEL_DEBUG,
    "info": LEVEL_INFO,
    "error": LEVEL_ERROR,
    "none": LEVEL_NONE,
}

_write_lock = threading.Lock()


class Logger:
    """Key-value logger with bound context (reference: log.Logger iface)."""

    def __init__(
        self,
        sink: Optional[TextIO] = None,
        level: int = LEVEL_INFO,
        context: Optional[Dict[str, Any]] = None,
        module_levels: Optional[Dict[str, int]] = None,
    ):
        self._sink = sink
        self._level = level
        self._context = dict(context or {})
        # per-module level overrides, keyed on the `module` context value
        # (reference: libs/log/filter.go AllowLevelWith)
        self._module_levels = dict(module_levels or {})

    def with_(self, **kv: Any) -> "Logger":
        ctx = dict(self._context)
        ctx.update(kv)
        return Logger(self._sink, self._level, ctx, self._module_levels)

    def _effective_level(self) -> int:
        mod = self._context.get("module")
        if mod is not None and mod in self._module_levels:
            return self._module_levels[mod]
        return self._module_levels.get("*", self._level)

    def _log(self, level: int, msg: str, kv: Dict[str, Any]) -> None:
        if self._sink is None or level < self._effective_level():
            return
        ts = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime())
        parts = [f"{_LEVEL_NAMES.get(level, '?')}[{ts}]", msg]
        merged = dict(self._context)
        merged.update(kv)
        for k, v in merged.items():
            parts.append(f"{k}={v}")
        line = " ".join(parts) + "\n"
        with _write_lock:
            self._sink.write(line)
            self._sink.flush()

    def debug(self, msg: str, **kv: Any) -> None:
        self._log(LEVEL_DEBUG, msg, kv)

    def info(self, msg: str, **kv: Any) -> None:
        self._log(LEVEL_INFO, msg, kv)

    def error(self, msg: str, **kv: Any) -> None:
        self._log(LEVEL_ERROR, msg, kv)


def new_tm_logger(sink: Optional[TextIO] = None, level: str = "info") -> Logger:
    return Logger(sink or sys.stderr, _LEVELS_BY_NAME[level])


def new_nop_logger() -> Logger:
    return Logger(None, LEVEL_NONE)


def parse_log_level(spec: str, default: str = "info") -> Dict[str, int]:
    """Parse 'module1:level1,module2:level2,*:level' filter specs.

    Reference: libs/log/filter.go ParseLogLevel.
    """
    out: Dict[str, int] = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if ":" in item:
            mod, lvl = item.split(":", 1)
            out[mod] = _LEVELS_BY_NAME[lvl]
        else:
            out["*"] = _LEVELS_BY_NAME[item]
    out.setdefault("*", _LEVELS_BY_NAME[default])
    return out
