"""Host spans of the STT path, on the clock of a ``torch.profiler`` trace.

A span is a named interval of one thread: its start and end as
``time.time_ns()`` (the realtime clock a profiler's Chrome trace counts its
``ts`` on, in microseconds from the trace's ``baseTimeNanoseconds``), the
thread it ran on, the ids of the transcription windows it serves, its
parent span and, where it has one, its size (windows admitted, tokens
appended). The thread is kept twice, as the trace names it twice: its
native id (``tid``: the ``tid`` of the trace's CPU events) and its
``pthread_self`` (``ident``: a CUDA runtime event's ``tid`` is that value
cut to a signed 32-bit integer, without its sign). Spans are taken here
rather than as ``torch.profiler.record_function`` ranges, which a profiler
records only on the thread that started it: the batcher's admissions and
ticks and the mel front ends run on executor threads.

Recording is on between ``start()`` and ``stop()`` only (``/api/profiler/*``
calls them around its trace). Off, a site costs one test of ``on()``: no
clock read, no allocation. Spans stay in memory, at most ``cap`` of them;
the rest are counted as dropped. ``stop()`` hands them over. A span opened
before a ``start()`` or ``stop()`` is not kept when it ends.

Spans of the continuous-batching path (``runtime/batcher_pool.py``,
``runtime/batcher.py``, ``runtime/audio_llm_batcher.py``):

- ``stt.mel``: a ``transcribe_pcm_batched`` window's mel front end on an
  executor thread, under the window's id, which its batcher spans carry
  (``window``, a context variable of the submitting task, hands it over);
- ``batcher.queue``: a window's wait, from the batcher's queue ``put`` to
  ``_admit`` taking it off;
- ``batcher.admit`` (size: windows admitted), children ``admit.encode``
  (stack, encoder, cross K and V, the slot scatter) and ``admit.feed`` (the
  prompt feed) in Whisper's batcher; in an audio-LLM's, ``admit.encode``
  (stack, encoder, adapter) and ``admit.prefill`` (size: prompt positions
  prefilled: the causal pass that writes the slots' K and V);
- ``batcher.tick`` (size: tokens appended), children ``tick.enqueue`` (the
  state copy and the decode block's launches), ``tick.sync`` (the one host
  sync) and ``tick.drain`` (the host loop over the result).
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time

CAP = 1 << 17

_started = False
_gen = 0  # bumped by start() and stop(): a span opened before is not kept
_cap = CAP
_spans: list[Span] = []
_dropped = 0
_lock = threading.Lock()
_span_ids = itertools.count(1)
_window_ids = itertools.count(1)

# the id of the window the current task submits to the batcher (0: none)
window: contextvars.ContextVar[int] = contextvars.ContextVar("window", default=0)


def on() -> bool:
    """Whether sites record now: between ``start()`` and ``stop()``."""
    return _started


class Span:
    """An open span until ``end``; ``next`` closes its current child and opens
    the next one, so a span's phases are recorded back to back."""

    __slots__ = ("name", "start_ns", "end_ns", "tid", "ident", "ids", "parent", "size", "id",
                 "_gen", "_child")

    def __init__(self, name: str, ids: tuple = (), parent: int = 0) -> None:
        self.name, self.ids, self.parent = name, ids, parent
        self.id = next(_span_ids)
        self.tid, self.ident = threading.get_native_id(), threading.get_ident()
        self.end_ns = 0
        self.size = None
        self._gen = _gen
        self._child: Span | None = None
        self.start_ns = time.time_ns()

    def next(self, child: str) -> None:
        if self._child is not None:
            end(self._child)
        self._child = Span(child, self.ids, self.id)

    def end_child(self, size: int | None = None) -> None:
        """Close the open child, with its size."""
        if self._child is not None:
            end(self._child, size)
            self._child = None


def begin(name: str, ids: tuple = (), child: str | None = None) -> Span:
    """Open a span (the caller has tested ``on()``), and its first child."""
    span = Span(name, ids)
    if child is not None:
        span.next(child)
    return span


def end(span: Span, size: int | None = None) -> None:
    """Close ``span`` (and its open child) and keep it."""
    global _dropped
    if span._child is not None:
        end(span._child)
        span._child = None
    span.end_ns = time.time_ns()
    span.size = size
    with _lock:
        if span._gen != _gen:
            return
        if len(_spans) < _cap:
            _spans.append(span)
        else:
            _dropped += 1


def window_id() -> int:
    """A new transcription window's id."""
    return next(_window_ids)


def start(cap: int = CAP) -> None:
    """Record from now on, into an empty store of at most ``cap`` spans."""
    global _started, _gen, _cap, _dropped
    with _lock:
        _started, _cap, _dropped = True, cap, 0
        _gen += 1
        _spans.clear()


def stop() -> list[Span]:
    """Stop recording; the spans kept since ``start()``, in order of end."""
    global _started, _gen
    with _lock:
        _started = False
        _gen += 1
        out = list(_spans)
        _spans.clear()
    return out


def dropped() -> int:
    """Spans that ended past the cap since the last ``start()``."""
    return _dropped


def chrome_events(spans: list[Span], base_ns: int, pid: int) -> list[dict]:
    """``spans`` as Chrome trace complete events on their own threads, on a
    trace's clock (``ts`` in microseconds from ``base_ns``)."""
    return [{"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": s.tid,
             "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"ids": list(s.ids), "id": s.id, "parent": s.parent, "size": s.size}}
            for s in spans]
