"""Named host spans of the port's hot path, on the profiler's clock.

``with span("plan"): ...`` records a ``repro_torch.plan`` range while a
`torch.profiler` (or `torch.autograd.profiler.emit_nvtx`) is recording:
the range lands in the profiler's own timeline beside the kernels it
launches, is exported with its Chrome trace, and becomes an NVTX range
under ``emit_nvtx``.  Spans nest by time on the calling thread.  With no
profiler recording, `span` returns one shared null context: a call
costs a flag test, and no ``record_function`` is entered.  `spanned`
makes every call of a function one span.

The spans of `kernels.ops.blmac_fir_bank` (docs/operations.md lists
them): ``blmac_fir_bank`` (the whole entry), ``compile.lookup``,
``plan``, ``frame``, ``launch.k1`` / ``launch.k2`` / ``launch.fold``,
``stack``, and ``build.<what>`` at each rebuild of a cached artifact.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.autograd import profiler as _profiler

__all__ = ["PREFIX", "span", "spanned"]

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``repro_torch.<name>`` range while the profiler records, else a
    shared null context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(PREFIX + name)
    return _OFF


def spanned(name: str):
    """Decorator: each call of the function is a `span` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap
