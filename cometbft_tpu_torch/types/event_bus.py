"""EventBus — the node-wide typed event plane over libs.pubsub.

Ported from cometbft_tpu/types/event_bus.py.

Reference: types/event_bus.go (EventBus wraps pubsub.Server; every publish
carries the composite event map consumed by subscriptions and indexers)
and types/events.go (event type strings + reserved tm.event key).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from cometbft_tpu_torch.libs.pubsub.pubsub import Server, Subscription
from cometbft_tpu_torch.libs.pubsub.query import Query, parse_query
from cometbft_tpu_torch.libs.service import BaseService

# Reserved composite key (types/events.go EventTypeKey)
EVENT_TYPE_KEY = "tm.event"
TX_HASH_KEY = "tx.hash"
TX_HEIGHT_KEY = "tx.height"

# Event values (types/events.go)
EVENT_NEW_BLOCK = "NewBlock"
EVENT_NEW_BLOCK_HEADER = "NewBlockHeader"
EVENT_NEW_EVIDENCE = "NewEvidence"
EVENT_TX = "Tx"
EVENT_NEW_ROUND_STEP = "NewRoundStep"
EVENT_TIMEOUT_PROPOSE = "TimeoutPropose"
EVENT_TIMEOUT_WAIT = "TimeoutWait"
EVENT_NEW_ROUND = "NewRound"
EVENT_COMPLETE_PROPOSAL = "CompleteProposal"
EVENT_POLKA = "Polka"
EVENT_UNLOCK = "Unlock"
EVENT_LOCK = "Lock"
EVENT_RELOCK = "Relock"
EVENT_VALID_BLOCK = "ValidBlock"
EVENT_VOTE = "Vote"
EVENT_VALIDATOR_SET_UPDATES = "ValidatorSetUpdates"


def query_for_event(event_value: str) -> Query:
    return parse_query(f"{EVENT_TYPE_KEY}='{event_value}'")


EVENT_QUERY_NEW_BLOCK = query_for_event(EVENT_NEW_BLOCK)
EVENT_QUERY_NEW_BLOCK_HEADER = query_for_event(EVENT_NEW_BLOCK_HEADER)
EVENT_QUERY_TX = query_for_event(EVENT_TX)
EVENT_QUERY_VOTE = query_for_event(EVENT_VOTE)
EVENT_QUERY_NEW_EVIDENCE = query_for_event(EVENT_NEW_EVIDENCE)
EVENT_QUERY_VALIDATOR_SET_UPDATES = query_for_event(EVENT_VALIDATOR_SET_UPDATES)


@dataclass
class EventDataNewBlock:
    block: object = None
    result_begin_block: object = None
    result_end_block: object = None


@dataclass
class EventDataNewBlockHeader:
    header: object = None
    num_txs: int = 0
    result_begin_block: object = None
    result_end_block: object = None


@dataclass
class EventDataTx:
    height: int = 0
    index: int = 0
    tx: bytes = b""
    result: object = None


@dataclass
class EventDataNewEvidence:
    evidence: object = None
    height: int = 0


@dataclass
class EventDataRoundState:
    height: int = 0
    round: int = 0
    step: str = ""


@dataclass
class EventDataNewRound:
    height: int = 0
    round: int = 0
    step: str = ""
    proposer_address: bytes = b""
    proposer_index: int = 0


@dataclass
class EventDataCompleteProposal:
    height: int = 0
    round: int = 0
    step: str = ""
    block_id: object = None


@dataclass
class EventDataVote:
    vote: object = None


@dataclass
class EventDataValidatorSetUpdates:
    validator_updates: list = field(default_factory=list)


def _abci_events_to_map(events) -> Dict[str, List[str]]:
    """abci.Event list → composite 'type.attr' → values map
    (reference: pubsub resolving via events map)."""
    out: Dict[str, List[str]] = {}
    for ev in events or []:
        if not ev.type:
            continue
        for attr in ev.attributes:
            if not attr.key:
                continue
            key = f"{ev.type}.{attr.key.decode('utf-8', 'replace')}"
            out.setdefault(key, []).append(attr.value.decode("utf-8", "replace"))
    return out


def merge_block_events(begin_events, end_events) -> Dict[str, List[str]]:
    """BeginBlock + EndBlock ABCI event lists → one composite map. Shared
    by live publishing and reindex-event so both index identically."""
    events = _abci_events_to_map(begin_events)
    for k, v in _abci_events_to_map(end_events).items():
        events.setdefault(k, []).extend(v)
    return events


def _merged_block_events(data) -> Dict[str, List[str]]:
    return merge_block_events(
        getattr(data.result_begin_block, "events", None),
        getattr(data.result_end_block, "events", None),
    )


class EventBus(BaseService):
    def __init__(self):
        super().__init__("EventBus")
        self._pubsub = Server(buffer_capacity=0)

    def on_start(self) -> None:
        self._pubsub.start()

    def on_stop(self) -> None:
        self._pubsub.stop()

    def subscribe(
        self, subscriber: str, q: Query, out_capacity: int = 100
    ) -> Subscription:
        return self._pubsub.subscribe(subscriber, q, out_capacity)

    def subscribe_unbuffered(self, subscriber: str, q: Query) -> Subscription:
        """Loss-proof subscription for internal consumers that must see
        every event (reference: SubscribeUnbuffered, used by the indexer —
        event_bus.go). Never evicted as a slow client."""
        return self._pubsub.subscribe(subscriber, q, -1)

    def unsubscribe(self, subscriber: str, q: Query) -> None:
        self._pubsub.unsubscribe(subscriber, q)

    def unsubscribe_all(self, subscriber: str) -> None:
        self._pubsub.unsubscribe_all(subscriber)

    def num_clients(self) -> int:
        return self._pubsub.num_clients()

    def num_client_subscriptions(self, client_id: str) -> int:
        return self._pubsub.num_client_subscriptions(client_id)

    # -- publishing ---------------------------------------------------------

    def _publish(self, event_value: str, data, events: Dict[str, List[str]]):
        events = dict(events)
        events.setdefault(EVENT_TYPE_KEY, []).append(event_value)
        self._pubsub.publish_with_events(data, events)

    def publish_event_new_block(self, data: EventDataNewBlock) -> None:
        self._publish(EVENT_NEW_BLOCK, data, _merged_block_events(data))

    def publish_event_new_block_header(
        self, data: EventDataNewBlockHeader
    ) -> None:
        self._publish(EVENT_NEW_BLOCK_HEADER, data, _merged_block_events(data))

    def publish_event_tx(self, data: EventDataTx) -> None:
        from cometbft_tpu_torch.crypto import sha256

        events = _abci_events_to_map(getattr(data.result, "events", None))
        events.setdefault(TX_HASH_KEY, []).append(sha256(data.tx).hex().upper())
        events.setdefault(TX_HEIGHT_KEY, []).append(str(data.height))
        self._publish(EVENT_TX, data, events)

    def publish_event_new_evidence(self, data: EventDataNewEvidence) -> None:
        self._publish(EVENT_NEW_EVIDENCE, data, {})

    def publish_event_vote(self, data: EventDataVote) -> None:
        self._publish(EVENT_VOTE, data, {})

    def publish_event_valid_block(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_VALID_BLOCK, data, {})

    def publish_event_new_round_step(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_NEW_ROUND_STEP, data, {})

    def publish_event_timeout_propose(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_TIMEOUT_PROPOSE, data, {})

    def publish_event_timeout_wait(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_TIMEOUT_WAIT, data, {})

    def publish_event_new_round(self, data: EventDataNewRound) -> None:
        self._publish(EVENT_NEW_ROUND, data, {})

    def publish_event_complete_proposal(
        self, data: EventDataCompleteProposal
    ) -> None:
        self._publish(EVENT_COMPLETE_PROPOSAL, data, {})

    def publish_event_polka(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_POLKA, data, {})

    def publish_event_lock(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_LOCK, data, {})

    def publish_event_relock(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_RELOCK, data, {})

    def publish_event_unlock(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_UNLOCK, data, {})

    def publish_event_validator_set_updates(
        self, data: EventDataValidatorSetUpdates
    ) -> None:
        self._publish(EVENT_VALIDATOR_SET_UPDATES, data, {})


class NopEventBus:
    """Publishes into the void (reference: types.NopEventBus)."""

    def __getattr__(self, name):
        if name.startswith("publish"):
            return lambda *a, **k: None
        raise AttributeError(name)
