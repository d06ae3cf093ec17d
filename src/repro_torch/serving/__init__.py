"""Serving over the port's filter-bank engines: `AsyncBankServer`, the
double-buffered request path with bounded retry, backoff and deadlines
over `ShardedFilterBankEngine.push_async`."""
from .engine import AsyncBankServer

__all__ = ["AsyncBankServer"]
