"""The port's spans and counters, on the profiler's clock.

Tracing is on exactly while a ``torch.profiler`` session records (the flag
``torch.autograd.profiler`` keeps, read again at every span's entry); no
option or environment variable turns it on. Off, :func:`span` is a test of
that flag and a shared no-op context: no allocation, no
``record_function``, no counter.

On:

  * :func:`span` opens a ``torch.profiler.record_function`` range, so the
    span sits in the profiler's trace on the device kernels' clock, and on
    exit adds to ``("span_calls", name)``, ``("span_ns", name)`` and
    ``("span_self_ns", name)`` (its time less that of the spans opened
    inside it on the same thread);
  * every wait of the host on the card counts under ``("host_sync",
    <innermost open span of the thread, or "outside">)``: torch's CUDA sync
    debug mode is set to ``warn`` while tracing is on and each of its
    warnings (``.item()``, ``bool()`` / ``float()`` of a device tensor,
    blocking copies either way, ``nonzero``) is counted, none printed;
    the mode does not see ``torch.cuda.synchronize``, so
    :func:`synchronize` counts that at its call. A sync inside a backward
    on autograd's device thread is replayed as a warning when
    ``backward()`` returns, and counts under the span that called it;
  * :func:`cast` counts each weight cast that launches under
    ``("weight_cast", "<from>-><to>")``;
  * :func:`count` adds to any other ``(name, key)`` counter (the SDS
    encode's ``("vae_encode_chunk", "kept" | "recomputed")``).

``COUNTERS`` is also ``ops/_build.LAUNCHES``, the kernel launch counts by
(counter, shape): every key is a ``(name, key)`` pair. The spans and
counters each module adds are listed in ``PERF.md`` §3.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import re
import threading
import time
import warnings
from typing import Dict

import torch
from torch.autograd import profiler as _profiler

COUNTERS: "collections.Counter[tuple]" = collections.Counter()
OUTSIDE = "outside"
SYNC_WARNING = "called a synchronizing CUDA operation"

_NOOP = contextlib.nullcontext()
_local = threading.local()
_stacks: Dict[int, list] = {}  # each thread's stack of open spans, by thread id
_lock = threading.RLock()
_armed = False
_saved: dict = {}


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = _stacks[threading.get_ident()] = []
    return stack


def innermost() -> str:
    """The innermost span open on this thread; on another thread with no
    span open (autograd's device thread running Python code of a
    backward), the main thread's, which called ``backward()``; else
    ``"outside"``."""
    stack = _stack()
    if not stack and threading.current_thread() is not threading.main_thread():
        stack = _stacks.get(threading.main_thread().ident) or stack
    return stack[-1].name if stack else OUTSIDE


def _add(*items) -> None:
    with _lock:
        for key, n in items:
            COUNTERS[key] += n


class _Span:
    __slots__ = ("name", "_rf", "_t0", "_children")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._children = 0
        _stack().append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1]._children += ns
        _add((("span_calls", self.name), 1), (("span_ns", self.name), ns),
             (("span_self_ns", self.name), ns - self._children))
        self._rf.__exit__(*exc)
        return False


def span(name: str):
    """A span around one call into a layer: a no-op unless a profiler
    session records (see the module's docstring)."""
    if not _profiler._is_profiler_enabled:
        if _armed:
            _arm(False)
        return _NOOP
    if not _armed:
        _arm(True)
    return _Span(name)


def spanned(name: str):
    """Decorator: the whole function inside :func:`span` ``(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


# -- host syncs -----------------------------------------------------------------

def _show(message, category, filename, lineno, file=None, line=None):
    if not str(message).startswith(SYNC_WARNING):
        return _saved["showwarning"](message, category, filename, lineno, file, line)
    if not _profiler._is_profiler_enabled:  # the session ended before a span saw it
        _arm(False)
        return None
    _local.seen = getattr(_local, "seen", 0) + 1
    _add((("host_sync", innermost()), 1))
    return None


def _arm(on: bool) -> None:
    """Count host syncs (``on``) or stop counting them: torch's sync debug
    mode, an ``always`` filter for its warning (the registry would keep one
    a call site) and the hook that counts it instead of printing it."""
    global _armed
    with _lock:
        if on == _armed:
            return
        _armed = on
        cuda = torch.cuda.is_available()
        if on:
            _saved["showwarning"] = warnings.showwarning
            warnings.showwarning = _show
            warnings.filterwarnings("always", message=re.escape(SYNC_WARNING))
            _saved["filter"] = warnings.filters[0]
            if cuda:
                _saved["mode"] = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
            return
        if cuda:
            torch.cuda.set_sync_debug_mode(_saved.pop("mode", 0))
        with contextlib.suppress(ValueError):
            warnings.filters.remove(_saved.pop("filter", None))
            warnings._filters_mutated()
        if warnings.showwarning is _show:
            warnings.showwarning = _saved["showwarning"]


def synchronize(device=None) -> None:
    """``torch.cuda.synchronize(device)``, counted as a host sync while
    tracing is on (where the sync debug mode did not already count it)."""
    if not _profiler._is_profiler_enabled:
        torch.cuda.synchronize(device)
        return
    if not _armed:
        _arm(True)
    seen = getattr(_local, "seen", 0)
    torch.cuda.synchronize(device)
    if getattr(_local, "seen", 0) == seen:
        _add((("host_sync", innermost()), 1))


# -- weight casts -----------------------------------------------------------------

def cast(t, dtype: torch.dtype):
    """``t.to(dtype)`` (``None`` stays ``None``); a cast that launches counts
    one under ``("weight_cast", "<from>-><to>")`` while tracing is on."""
    if t is None or t.dtype == dtype:
        return t
    if _profiler._is_profiler_enabled:
        _add((("weight_cast", f"{str(t.dtype)[6:]}->{str(dtype)[6:]}"), 1))
    return t.to(dtype)


def count(key: tuple, n: int) -> None:
    """Add ``n`` to the counter ``key`` while tracing is on."""
    if _profiler._is_profiler_enabled:
        _add((key, n))


# -- reading the counters ---------------------------------------------------------

def snapshot() -> Dict[tuple, int]:
    with _lock:
        return dict(COUNTERS)


def changes(before: Dict[tuple, int]) -> Dict[tuple, int]:
    """The counters' change since ``before`` (a :func:`snapshot`), zeros left out."""
    after = snapshot()
    return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


def as_json(counts: Dict[tuple, int]) -> Dict[str, Dict[str, int]]:
    """``{name: {str(key): n}}``: the counters grouped by name, for JSON."""
    out: Dict[str, Dict[str, int]] = {}
    for (name, key), n in sorted(counts.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        out.setdefault(name, {})[str(key)] = n
    return out
