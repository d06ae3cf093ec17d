"""Serving: `ServeEngine`, the batched greedy language-model engine over
the prefill and decode steps; and, over the port's filter-bank engines,
`AsyncBankServer`, the double-buffered request path with bounded retry,
backoff and deadlines over `ShardedFilterBankEngine.push_async`;
`BankSessionServer`, many tenant streams batched into the shared lanes
of one engine, with admission control, pause/resume, hot swaps and
per-tenant fault attribution; and `SessionJournal`, its write-ahead
log."""
from .engine import (AsyncBankServer, ServeEngine, abstract_caches,
                     cache_pspecs, make_decode_fn, make_prefill_fn)
from .journal import JournalFormatError, SessionJournal
from .sessions import AdmissionRejected, BankSession, BankSessionServer

__all__ = [
    "AdmissionRejected",
    "AsyncBankServer",
    "BankSession",
    "BankSessionServer",
    "JournalFormatError",
    "ServeEngine",
    "SessionJournal",
    "abstract_caches",
    "cache_pspecs",
    "make_decode_fn",
    "make_prefill_fn",
]
