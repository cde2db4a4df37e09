"""Pub/sub server implementation.

Ported from cometbft_tpu/libs/pubsub/pubsub.py.

Reference: libs/pubsub/pubsub.go — per-(client, query) subscriptions with
buffered or unbuffered delivery; slow unbuffered clients are evicted
(subscription cancelled with reason). publish_with_events matches each
subscription's query against the event map.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, List, Optional, Sequence

from cometbft_tpu_torch.libs.pubsub.query import Query


class AlreadySubscribedError(Exception):
    pass


class NotSubscribedError(Exception):
    pass


class SubscriptionCancelled(Exception):
    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class Message:
    __slots__ = ("data", "events")

    def __init__(self, data: Any, events: Dict[str, Sequence[str]]):
        self.data = data
        self.events = events


class Subscription:
    """A single client+query subscription with its delivery queue."""

    def __init__(self, client_id: str, q: Query, out_capacity: int):
        self.client_id = client_id
        self.query = q
        # capacity 0 == unbuffered in the reference; we use capacity 1 with
        # non-blocking put + eviction to model "slow client dropped".
        # capacity -1 == unbounded: never full, never evicted — for
        # must-not-miss internal consumers (the reference's
        # SubscribeUnbuffered blocks the publisher instead; an unbounded
        # queue trades memory for the same no-loss guarantee without
        # holding the publish lock).
        self._queue: "queue.Queue[Message]" = queue.Queue(
            maxsize=0 if out_capacity < 0 else max(out_capacity, 1)
        )
        self._unbuffered = out_capacity == 0
        self._cancelled = threading.Event()
        self.cancel_reason: Optional[str] = None

    def next(self, timeout: Optional[float] = None) -> Message:
        """Block for the next message; raises SubscriptionCancelled."""
        while True:
            if self._cancelled.is_set() and self._queue.empty():
                raise SubscriptionCancelled(self.cancel_reason or "cancelled")
            try:
                return self._queue.get(timeout=0.05 if timeout is None else min(timeout, 0.05))
            except queue.Empty:
                if timeout is not None:
                    timeout -= 0.05
                    if timeout <= 0:
                        raise TimeoutError("no message")

    def try_next(self) -> Optional[Message]:
        if self._cancelled.is_set() and self._queue.empty():
            raise SubscriptionCancelled(self.cancel_reason or "cancelled")
        try:
            return self._queue.get_nowait()
        except queue.Empty:
            return None

    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def _cancel(self, reason: str) -> None:
        self.cancel_reason = reason
        self._cancelled.set()

    def _deliver(self, msg: Message) -> bool:
        try:
            self._queue.put_nowait(msg)
            return True
        except queue.Full:
            return False


class Server:
    """Event pub/sub server.

    Unlike the reference (which runs a goroutine loop), publishing happens on
    the caller thread under a subscriber-map lock; delivery into per-
    subscription queues is non-blocking with slow-client eviction, matching
    the observable semantics.
    """

    def __init__(self, buffer_capacity: int = 0):
        self._mtx = threading.RLock()
        # client_id -> {query_str -> Subscription}
        self._subs: Dict[str, Dict[str, Subscription]] = {}
        self._buffer_capacity = buffer_capacity
        self._running = False

    # -- service facade ----------------------------------------------------

    def start(self) -> None:
        self._running = True

    def stop(self) -> None:
        with self._mtx:
            for client_subs in self._subs.values():
                for sub in client_subs.values():
                    sub._cancel("server stopped")
            self._subs.clear()
        self._running = False

    # -- subscription management ------------------------------------------

    def subscribe(
        self, client_id: str, q: Query, out_capacity: int = 0
    ) -> Subscription:
        with self._mtx:
            client_subs = self._subs.setdefault(client_id, {})
            if str(q) in client_subs:
                raise AlreadySubscribedError(f"{client_id}: {q}")
            sub = Subscription(client_id, q, out_capacity)
            client_subs[str(q)] = sub
            return sub

    def unsubscribe(self, client_id: str, q: Query) -> None:
        with self._mtx:
            client_subs = self._subs.get(client_id)
            if not client_subs or str(q) not in client_subs:
                raise NotSubscribedError(f"{client_id}: {q}")
            sub = client_subs.pop(str(q))
            sub._cancel("unsubscribed")
            if not client_subs:
                del self._subs[client_id]

    def unsubscribe_all(self, client_id: str) -> None:
        with self._mtx:
            client_subs = self._subs.pop(client_id, None)
            if not client_subs:
                raise NotSubscribedError(client_id)
            for sub in client_subs.values():
                sub._cancel("unsubscribed")

    def num_clients(self) -> int:
        with self._mtx:
            return len(self._subs)

    def num_client_subscriptions(self, client_id: str) -> int:
        with self._mtx:
            return len(self._subs.get(client_id, {}))

    # -- publishing --------------------------------------------------------

    def publish(self, data: Any) -> None:
        self.publish_with_events(data, {})

    def publish_with_events(
        self, data: Any, events: Dict[str, Sequence[str]]
    ) -> None:
        msg = Message(data, events)
        evicted: List[Subscription] = []
        with self._mtx:
            for client_id, client_subs in list(self._subs.items()):
                for qstr, sub in list(client_subs.items()):
                    if sub.query.matches(events):
                        if not sub._deliver(msg):
                            # slow client (queue full): evict with reason
                            # rather than silently dropping events
                            # (reference: pubsub.go send timeout → cancel)
                            client_subs.pop(qstr)
                            evicted.append(sub)
                if not client_subs:
                    self._subs.pop(client_id, None)
        for sub in evicted:
            sub._cancel("client is not pulling messages fast enough")
