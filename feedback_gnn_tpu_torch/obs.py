"""Spans and counters at the port's layer boundaries.

A span names a stretch of the program (``with obs.span("cascade.gnn",
round=r): ...``); a counter counts what happened there (``obs.count``,
``obs.count_device``).  ``snapshot()`` folds them into totals by name.

Tracing is on while ``enable()`` has switched it on, or while a torch
profiler is recording (its active steps).  Off, ``span`` returns one shared
no-op after a flag check: it records nothing, creates no CUDA event and
opens no ``record_function``.  On, a span records its name, attributes,
parent span, the batch in progress (counted by ``end_batch``) and its host
start and end, in nanoseconds of Unix time: the clock of the profiler's exported
trace, whose events lie at ``ts`` (microseconds) + the header's
``baseTimeNanoseconds``.  Once CUDA is initialised it also records a pair
of timing events on the current stream, so its device time is the
stream's time from the span's first enqueue to its last; on the CPU the
device time is the host time.  While a profiler records, the span also
opens ``torch.profiler.record_function(name)``, so it shows in the
exported trace beside the kernels.

Host counters (``count``: the kernel launch counts among them) always
count.  Device counters (``count_device``) add on the device without a
host sync, and only while tracing is on.  Set-up spans (``setup``) are
recorded whether tracing is on or off; they run once per process.

Finished spans are folded into the totals at each ``end_batch`` once
their events have completed, so a long run keeps about a batch's spans.
``end_batch`` comes where the batch's work is enqueued and the device still
works behind the host, so folding takes no device time.
Span names never start with ``ProfilerStep#``, which marks the profiler's
own steps.
"""

from __future__ import annotations

import functools
import time

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span", "begin", "setup", "end_batch", "count", "count_device", "counter", "enable", "on",
           "snapshot", "reset", "recent", "NULL"]

# finished spans kept unfolded where no batch boundary folds them (a loop
# with no end_batch, such as a train step under a profiler)
MAX_UNFOLDED = 4096


def on() -> bool:
    """Whether tracing is on: switched on, or a torch profiler recording."""
    return _state.enabled or _profiler._is_profiler_enabled


class _Null:
    """The span while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def close(self):
        pass


NULL = _Null()


class _Span:
    """One recorded span; also a decorator that records one per call."""

    __slots__ = ("name", "attrs", "parent", "batch", "t0", "t1", "ev0", "ev1", "stream", "rf", "always")

    def __init__(self, name, attrs, always=False):
        self.name, self.attrs, self.always = name, attrs, always
        self.t1 = None

    def __call__(self, fn):
        name, attrs, always = self.name, self.attrs, self.always

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with (_Span(name, attrs, always) if always or on() else NULL):
                return fn(*args, **kwargs)

        return wrapped

    def __enter__(self):
        st = _state
        self.parent = st.stack[-1].name if st.stack else None
        self.batch = st.batch
        self.rf = self.ev0 = self.ev1 = None
        if on():
            if _profiler._is_profiler_enabled:
                self.rf = _profiler.record_function(self.name)
                self.rf.__enter__()
            if torch.cuda.is_initialized():
                self.stream = torch.cuda.current_stream()
                self.ev0 = st.event()
                self.ev0.record(self.stream)
        st.stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.t1 is not None:  # closed already
            return False
        self.t1 = time.time_ns()
        st = _state
        if self.ev0 is not None:
            self.ev1 = st.event()
            self.ev1.record(self.stream)
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        if st.stack and st.stack[-1] is self:
            st.stack.pop()
        elif self in st.stack:
            st.stack.remove(self)
        if self.ev1 is None and not on():
            st.fold_one(self)  # a set-up span with tracing off: no batch boundary may come
        else:
            st.finished.append(self)
            if len(st.finished) > MAX_UNFOLDED:
                st.fold(wait=False)
        return False

    def close(self):
        self.__exit__(None, None, None)

    @property
    def host_s(self):
        return (self.t1 - self.t0) * 1e-9

    @property
    def device_s(self):
        """Device seconds; its events must have completed."""
        if self.ev1 is None:
            return self.host_s
        return self.ev0.elapsed_time(self.ev1) * 1e-3


def _add(totals, key, host_s, device_s):
    t = totals.get(key)
    if t is None:
        totals[key] = [1, host_s, device_s]
    else:
        t[0] += 1
        t[1] += host_s
        t[2] += device_s


class _State:
    """Everything recorded since the last reset."""

    def __init__(self, enabled=False, pool=None):
        self.enabled = enabled
        self.batch = 0  # the batch in progress
        self.batches = 0  # batches ended while tracing was on
        self.stack = []  # open spans, innermost last
        self.finished = []  # closed spans not yet folded
        self.totals = {}  # name -> [count, host_s, device_s]
        self.by_attr = {}  # (name, attribute, value) -> [count, host_s, device_s]
        self.counts = {}  # name -> {key: n}
        self.device_counts = {}  # name -> 0-d tensor on its device
        self.device_pending = {}  # name -> [0-d tensors not yet added]
        self.pool = pool if pool is not None else []  # timing events to reuse

    def event(self):
        return self.pool.pop() if self.pool else torch.cuda.Event(enable_timing=True)

    def fold_one(self, s):
        host_s, device_s = s.host_s, s.device_s
        _add(self.totals, s.name, host_s, device_s)
        for k, v in s.attrs.items():
            _add(self.by_attr, (s.name, k, v), host_s, device_s)
        if s.ev1 is not None:
            self.pool += [s.ev0, s.ev1]
            s.ev0 = s.ev1 = None

    def fold(self, wait):
        """Fold the finished spans whose events have completed (all of them
        after a synchronize where ``wait``), and add the device counts."""
        if wait and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        done = len(self.finished)
        for i, s in enumerate(self.finished):
            # spans end in the order their end events were recorded: the
            # first not yet reached on the device leaves the rest waiting
            if s.ev1 is not None and not wait and not s.ev1.query():
                done = i
                break
            self.fold_one(s)
        del self.finished[:done]
        for name, parts in self.device_pending.items():
            total = torch.stack(parts).sum()
            acc = self.device_counts.get(name)
            self.device_counts[name] = total if acc is None else acc + total
        self.device_pending.clear()


_state = _State()


def span(name: str, **attrs):
    """A span over a ``with`` block; the shared no-op while tracing is off."""
    if _state.enabled or _profiler._is_profiler_enabled:
        return _Span(name, attrs)
    return NULL


def begin(name: str, **attrs):
    """A span entered now and ended by its ``close()``, for a stretch that
    does not fit one ``with`` block; ``NULL`` while tracing is off."""
    return span(name, **attrs).__enter__()


def setup(name: str, **attrs):
    """A set-up span ``setup.<name>``, recorded whether tracing is on or
    off; decorates a function (one span a call) or wraps a block."""
    return _Span("setup." + name, attrs, always=True)


def end_batch():
    """End the batch in progress, its work enqueued (tracing on only): count
    it, fold the finished spans whose events have completed, and begin the
    next.  Called while the device still works behind the host, folding
    costs the device nothing."""
    if _state.enabled or _profiler._is_profiler_enabled:
        st = _state
        st.batch += 1
        st.batches += 1
        st.fold(wait=False)


def count(name: str, n=1, key=None):
    """Add ``n`` to a host counter, under ``key`` where given; always counts."""
    by_key = _state.counts.setdefault(name, {})
    by_key[key] = by_key.get(key, 0) + n


def count_device(name: str, t: torch.Tensor):
    """Add the sum of ``t`` (booleans or integers) to a device counter on
    its device, without a host sync; only while tracing is on (off, not
    even the sum runs)."""
    if _state.enabled or _profiler._is_profiler_enabled:
        _state.device_pending.setdefault(name, []).append(t.sum(dtype=torch.int64))


def counter(name: str):
    """A host counter's total over its keys (0 where it never counted)."""
    return sum(_state.counts.get(name, {}).values())


def enable(flag: bool = True):
    """Switch tracing on (or off with False) until switched again."""
    _state.enabled = bool(flag)


def recent():
    """The finished spans not yet folded into the totals, oldest first:
    each a dict of name, attributes, parent, batch and host start and end
    (ns of Unix time)."""
    return [dict(name=s.name, attrs=dict(s.attrs), parent=s.parent, batch=s.batch, t0_ns=s.t0, t1_ns=s.t1)
            for s in _state.finished]


def snapshot() -> dict:
    """Synchronize once, fold every finished span and return the totals:

    ``batches``: batches ended while tracing was on; ``spans``: per name
    ``count``, ``host_s``, ``device_s`` and, per attribute and value,
    ``by[attribute][value]`` the same three; ``counters``: per name the
    total over keys, device counters read to the host; ``keys``: per host
    counter that has keys, the count of each key."""
    st = _state
    st.fold(wait=True)
    spans = {}
    for name, (n, h, d) in st.totals.items():
        spans[name] = {"count": n, "host_s": h, "device_s": d, "by": {}}
    for (name, attr, value), (n, h, d) in st.by_attr.items():
        spans[name]["by"].setdefault(attr, {})[value] = {"count": n, "host_s": h, "device_s": d}
    counters = {name: sum(by_key.values()) for name, by_key in st.counts.items()}
    for name, acc in st.device_counts.items():
        counters[name] = counters.get(name, 0) + acc.item()
    keys = {name: dict(by_key) for name, by_key in st.counts.items() if any(k is not None for k in by_key)}
    return {"batches": st.batches, "spans": spans, "counters": counters, "keys": keys}


def reset():
    """Clear every span, counter and batch; the switch stays as it is."""
    global _state
    _state = _State(_state.enabled, _state.pool)
