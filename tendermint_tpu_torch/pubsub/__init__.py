"""In-process pub/sub with query filtering (ref: internal/pubsub/).

A copy of the JAX package's pubsub/: the same query language and the same
deliveries."""

from .query import Query, QueryError, parse_query
from .pubsub import Server, Subscription

__all__ = ["Query", "QueryError", "Server", "Subscription", "parse_query"]
