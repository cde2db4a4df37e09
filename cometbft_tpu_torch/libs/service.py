"""Service lifecycle management (reference: cometbft_tpu/libs/service.py,
all of it; the port's own copy).

Upstream: libs/service/service.go:109 — Service interface + BaseService with
Start/Stop/Reset/Quit semantics and idempotency guarantees. Every long-lived
object (reactors, stores, the node) derives from this.
"""

from __future__ import annotations

import threading
from typing import Optional

from cometbft_tpu_torch.libs.log import Logger, new_nop_logger


class AlreadyStartedError(RuntimeError):
    pass


class AlreadyStoppedError(RuntimeError):
    pass


class NotStartedError(RuntimeError):
    pass


class BaseService:
    """Lifecycle base class.

    Subclasses override ``on_start``/``on_stop``/``on_reset``. ``start`` and
    ``stop`` are idempotent in the same way the reference is: a second start
    raises AlreadyStartedError, a second stop raises AlreadyStoppedError, and
    start-after-stop (without reset) raises AlreadyStoppedError.
    """

    def __init__(self, name: str = "", logger: Optional[Logger] = None):
        self._name = name or type(self).__name__
        self.logger: Logger = logger or new_nop_logger()
        self._mtx = threading.Lock()
        self._started = False
        self._stopped = False
        self._quit = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    def set_logger(self, logger: Logger) -> None:
        self.logger = logger

    def start(self) -> None:
        with self._mtx:
            if self._started:
                if self._stopped:
                    raise AlreadyStoppedError(self._name)
                raise AlreadyStartedError(self._name)
            self._started = True
        self.logger.info("service start", name=self._name)
        try:
            self.on_start()
        except Exception:
            with self._mtx:
                self._started = False
            raise

    def stop(self) -> None:
        with self._mtx:
            if not self._started:
                raise NotStartedError(self._name)
            if self._stopped:
                raise AlreadyStoppedError(self._name)
            self._stopped = True
        self.logger.info("service stop", name=self._name)
        self._quit.set()
        self.on_stop()

    def reset(self) -> None:
        with self._mtx:
            if not self._stopped:
                raise RuntimeError(f"cannot reset running service {self._name}")
            self._started = False
            self._stopped = False
            self._quit = threading.Event()
        self.on_reset()

    # -- overridables ------------------------------------------------------

    def on_start(self) -> None:  # pragma: no cover - trivial
        pass

    def on_stop(self) -> None:  # pragma: no cover - trivial
        pass

    def on_reset(self) -> None:  # pragma: no cover - trivial
        pass

    # -- queries -----------------------------------------------------------

    def is_running(self) -> bool:
        with self._mtx:
            return self._started and not self._stopped

    def quit_event(self) -> threading.Event:
        """Event set when the service stops (reference: Quit() channel)."""
        return self._quit

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._quit.wait(timeout)

    def __str__(self) -> str:
        return self._name
