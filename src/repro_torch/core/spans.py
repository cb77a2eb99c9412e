"""Host spans and counters inside the walk engines.

One process-wide recorder, off by default, so no engine, pool or store
takes a new argument.  A caller that wants to see where the host's time
goes calls :func:`enable`, runs engines, and calls :func:`take` (once per
task, say) to get and clear what was recorded; :func:`disable` stops it.

* :func:`span` is a context manager.  Each span records its name, its start
  and end on ``time.perf_counter_ns()``, the index of its parent (the span
  open below it on the same thread), the thread's ident and its attributes.
* :func:`add` records a span whose two clock reads the caller already made
  (the advance call's ``IOStats.exec_time`` and its span share them).
* :func:`count` adds to a named counter.

Disabled, :func:`span` returns one shared no-op object and :func:`add` and
:func:`count` return at once: no clock read, no lock, nothing recorded.
Spans go at call granularity, never one per walk.

``perf_counter_ns`` is the clock a ``torch.profiler`` trace can be aligned
to (a ``record_function`` mark whose host time is read inside it), so
:func:`attribute_idle` can put each idle nanosecond of the device down to
the innermost span open on one thread.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "COARSE",
    "NO_SPAN",
    "Span",
    "add",
    "attribute_idle",
    "count",
    "disable",
    "enable",
    "self_times",
    "span",
    "take",
]

#: spans that only group leaves; idle time whose innermost span is one of
#: these (or none) is not put down to any piece of work
COARSE = frozenset({"task.run", "init", "slot", "bucket"})

_enabled = False
_lock = threading.Lock()
_spans: List["Span"] = []
_counts: Dict[str, int] = {}
_index = itertools.count()
_local = threading.local()
_clock = time.perf_counter_ns


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span:
    """One recorded span; also the context manager :func:`span` returns
    while recording is on.  ``parent`` is the ``index`` of the span open
    below it on the same thread, -1 for none."""

    __slots__ = ("name", "start", "end", "parent", "thread", "attrs", "index")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.start = self.end = 0
        self.parent = -1
        self.thread = 0
        self.index = -1

    def set(self, **attrs) -> None:
        """Add attributes known only once the span is open."""
        self.attrs.update(attrs)

    def _place(self, stack: list) -> None:
        self.index = next(_index)
        self.parent = stack[-1].index if stack else -1
        self.thread = threading.get_ident()

    def __enter__(self) -> "Span":
        stack = _stack()
        self._place(stack)
        self.start = _clock()
        stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _stack().pop()
        self.end = _clock()
        with _lock:
            _spans.append(self)
        return False


class _NoSpan:
    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def span(name: str, **attrs):
    """A span named ``name`` around a ``with`` block (the shared no-op
    when recording is off)."""
    if not _enabled:
        return NO_SPAN
    return Span(name, attrs)


def add(name: str, start: int, end: int) -> None:
    """Record a span from ``start`` to ``end`` (``perf_counter_ns``) inside
    the span open on this thread."""
    if not _enabled:
        return
    s = Span(name, {})
    s._place(_stack())
    s.start, s.end = start, end
    with _lock:
        _spans.append(s)


def count(name: str, n: int = 1) -> None:
    if not _enabled:
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def take() -> Tuple[List[Span], Dict[str, int]]:
    """The spans closed and the counts made since the last call, which
    clears them.  A span still open is returned by a later call."""
    global _spans, _counts
    with _lock:
        out, _spans = _spans, []
        counts, _counts = _counts, {}
    return out, counts


def self_times(spans: Iterable[Span]) -> Dict[str, dict]:
    """``{name: {"n": calls, "self_ns": ...}}``: each span's duration less
    its children's, summed by name."""
    spans = list(spans)
    child_ns: Dict[int, int] = {}
    for s in spans:
        if s.parent >= 0:
            child_ns[s.parent] = child_ns.get(s.parent, 0) + (s.end - s.start)
    out: Dict[str, dict] = {}
    for s in spans:
        row = out.setdefault(s.name, {"n": 0, "self_ns": 0})
        row["n"] += 1
        row["self_ns"] += s.end - s.start - child_ns.get(s.index, 0)
    return out


def _innermost(spans: List[Span]) -> List[Tuple[int, int, str]]:
    """Disjoint ``(start, end, name)`` pieces of one thread's spans, each
    named after the innermost span open over it, in time order."""
    by_index = {s.index: s for s in spans}
    children: Dict[int, List[Span]] = {}
    for s in spans:
        key = s.parent if s.parent in by_index else -1
        children.setdefault(key, []).append(s)
    for kids in children.values():
        kids.sort(key=lambda s: (s.start, s.index))
    pieces: List[Tuple[int, int, str]] = []

    def emit(s: Span, lo: int, hi: int) -> None:
        t = lo
        for c in children.get(s.index, ()):
            a, b = max(c.start, t), min(c.end, hi)
            if b <= a:
                continue
            if a > t:
                pieces.append((t, a, s.name))
            emit(c, a, b)
            t = b
        if hi > t:
            pieces.append((t, hi, s.name))

    t = None
    for root in children.get(-1, ()):
        a = root.start if t is None else max(root.start, t)
        if root.end > a:
            emit(root, a, root.end)
            t = root.end
    return pieces


def attribute_idle(
    idle: Iterable[Tuple[int, int]],
    spans: Iterable[Span],
    thread: Optional[int] = None,
) -> Tuple[Dict[str, int], int]:
    """Put each nanosecond of the sorted, disjoint ``idle`` intervals
    (``perf_counter_ns``) down to the innermost span of ``thread`` (the
    calling thread by default) open at that instant.  Returns
    ``({name: idle ns}, idle ns under no span)``; the two add up to the
    idle time.  Exact: no sampling."""
    thread = threading.get_ident() if thread is None else thread
    pieces = _innermost([s for s in spans if s.thread == thread and s.end > s.start])
    by_name: Dict[str, int] = {}
    unspanned = 0
    j = 0
    for a, b in idle:
        t = a
        while j < len(pieces) and pieces[j][1] <= t:
            j += 1
        k = j
        while t < b:
            if k >= len(pieces) or pieces[k][0] >= b:
                unspanned += b - t
                break
            pa, pb, name = pieces[k]
            if pa > t:
                unspanned += pa - t
                t = pa
            hi = min(pb, b)
            by_name[name] = by_name.get(name, 0) + hi - t
            t = hi
            if pb <= b:
                k += 1
    return by_name, unspanned
