"""Spans and counters of the port, at its layer boundaries.

Off by default.  Off, ``span(name)`` and ``sync(device)`` return one
shared no-op context manager, a function decorated with ``spanned(name)``
is called straight through, and ``count(name, n)`` returns at once: none
of them allocates, reads a clock or touches torch.  ``enable()`` turns
recording on and ``disable()`` off again; nothing is read from the
environment.

On, each span appends one record to an in-memory list: its name, its
start and end on ``time.perf_counter_ns()``, the index of the span it
opened in (-1 at the outside) and the index of its outermost span (a
round in ``fl``, a prove when a production round is driven by hand).
Every thread keeps its own stack of open spans.  Counters add up in a
``collections.Counter``.  ``take()`` returns both and clears them; nothing
is written anywhere during a run.

Names are ``layer.stage`` (``groth16.assemble``, ``msm.sort``): the
spans and counters, and what reads each one, are listed in PERF.md.
"""

from __future__ import annotations

import collections
import functools
import threading
import time
from contextlib import contextmanager
from typing import List, NamedTuple

clock_ns = time.perf_counter_ns


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int      # 0 while the span is still open
    parent: int      # index of the enclosing span in the same list, -1 if none
    root: int        # index of the outermost enclosing span (itself if outermost)


class _Off:
    """The shared no-op: what ``span`` and ``sync`` give while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()

_on = False
_records: list = []                  # [name, start, end, parent, root] per span
_counters: collections.Counter = collections.Counter()
_lock = threading.Lock()
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    __slots__ = ("name", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        with _lock:
            index = len(_records)
            parent = stack[-1] if stack else -1
            root = _records[parent][4] if parent >= 0 else index
            self.record = [self.name, clock_ns(), 0, parent, root]
            _records.append(self.record)
        stack.append(index)
        return None

    def __exit__(self, *exc):
        self.record[2] = clock_ns()
        _stack().pop()
        return False


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def span(name: str):
    """A context manager around one stage of work, recorded while on."""
    if not _on:
        return OFF
    return _Open(name)


def count(name: str, n: int = 1) -> None:
    if not _on:
        return
    _counters[name] += n


def sync(device, h2d: int = 0, d2h: int = 0, waits: int = 1):
    """Around a call that blocks the host until ``device``'s queue has
    drained ``waits`` times: a ``device.sync`` span and ``waits`` more
    ``device.syncs``, on a CUDA device alone (nothing waits on the CPU).
    ``h2d`` and ``d2h`` are the bytes the call copies to and from the
    device, added to ``pipeline.h2d_bytes`` and ``pipeline.d2h_bytes``."""
    if not _on or device.type != "cuda":
        return OFF
    _counters["device.syncs"] += waits
    if h2d:
        _counters["pipeline.h2d_bytes"] += h2d
    if d2h:
        _counters["pipeline.d2h_bytes"] += d2h
    return _Open("device.sync")


def spanned(name: str):
    """Decorator: every call of the function is one span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Open(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextmanager
def timed(into: dict, key: str, name: str | None = None):
    """``into[key]``: the block's seconds on this module's clock, for a
    caller that returns its own timings; with ``name``, also a span."""
    with span(name) if name else OFF:
        t0 = clock_ns()
        try:
            yield
        finally:
            into[key] = (clock_ns() - t0) / 1e9


def take():
    """(spans, counters) recorded since the last take, and clear both.
    Take between rounds: a span still open on this thread cannot be split."""
    global _records, _counters
    if _stack():
        raise RuntimeError("trace.take() inside an open span")
    with _lock:
        records, counters = _records, _counters
        _records, _counters = [], collections.Counter()
    return [Span(*r) for r in records], counters


# -- readers of a taken list -------------------------------------------------


def seconds(spans: List[Span], name: str) -> float:
    return sum(s.end_ns - s.start_ns for s in spans if s.name == name) / 1e9


def self_ns(spans: List[Span]) -> List[int]:
    """Each span's self time: its duration less what its child spans cover
    (children of one span never overlap on one thread)."""
    out = [s.end_ns - s.start_ns for s in spans]
    for s in spans:
        if s.parent >= 0:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


def under(spans: List[Span], index: int, names) -> bool:
    """True when a span enclosing span ``index`` (not itself) is named in ``names``."""
    p = spans[index].parent
    while p >= 0:
        if spans[p].name in names:
            return True
        p = spans[p].parent
    return False
