"""In-process pub/sub server with a query language.

Ported from cometbft_tpu/libs/pubsub/__init__.py.

Reference: libs/pubsub — backs types.EventBus and all RPC event
subscriptions. Subscribers register a Query; published (message, events)
pairs are delivered to every subscription whose query matches the event map.
"""

from cometbft_tpu_torch.libs.pubsub.pubsub import (
    Message,
    Server,
    Subscription,
    SubscriptionCancelled,
    AlreadySubscribedError,
    NotSubscribedError,
)
from cometbft_tpu_torch.libs.pubsub.query import Query, Empty, parse_query

__all__ = [
    "Message",
    "Server",
    "Subscription",
    "SubscriptionCancelled",
    "AlreadySubscribedError",
    "NotSubscribedError",
    "Query",
    "Empty",
    "parse_query",
]
