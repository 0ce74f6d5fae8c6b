"""Lightweight tracing: spans -> Chrome/Perfetto trace-event JSON.

Design constraints, in order:

1.  **Near-zero cost when disabled.**  ``span()`` checks one module-level
    bool and returns a shared no-op context manager — no event object,
    no timestamp read, no lock.  The hot paths (``planned_dense_apply``
    dispatch, ``ServeEngine.step``) additionally guard their attribute
    construction on ``enabled()`` so a disabled run allocates nothing
    per call beyond the argument tuple of the guard itself.  The
    ``tests/test_torch_obs.py`` pins this.
2.  **Thread-safe.**  Realtime serving runs one worker thread per tier;
    events append under a lock, span timing itself is thread-local
    state on the span object.
3.  **Two clock domains.**  Runtime spans are stamped with
    ``time.perf_counter`` relative to the trace epoch (pid
    ``PID_RUNTIME``).  The virtual-time server instead emits
    *explicit-timestamp* complete events (``complete_event``) on pid
    ``PID_SERVER`` whose microseconds are simulated seconds — so a
    virtual-mode trace shows the request timeline the simulation
    computed, side by side with the real host wall time.

Export format is the Chrome trace-event JSON object form
(``{"traceEvents": [...]}``) with ``ph: "X"`` complete events —
loadable by ``chrome://tracing`` and https://ui.perfetto.dev.

Enabling: set ``REPRO_TRACE=1`` (collect; fetch with ``events()`` /
``save()``), or ``REPRO_TRACE=/path/out.json`` (collect and write the
trace at process exit), or call ``enable()`` programmatically.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["ENV_TRACE", "PID_RUNTIME", "PID_SERVER", "enabled", "enable",
           "disable", "span", "instant", "complete_event", "events",
           "clear", "save", "to_chrome"]

ENV_TRACE = "REPRO_TRACE"

# Chrome trace "process" ids: two logical timelines, not OS processes.
PID_RUNTIME = 1     # host wall clock (perf_counter since trace epoch)
PID_SERVER = 2      # serving clock (virtual seconds in virtual-time mode)

_FALSY = ("", "0", "false", "off", "no", "none")

_enabled = False
_lock = threading.Lock()
_events: List[Dict[str, Any]] = []
_epoch = time.perf_counter()


def enabled() -> bool:
    """True when span collection is on (the hot-path guard)."""
    return _enabled


def enable(clear_events: bool = False) -> None:
    global _enabled
    if clear_events:
        clear()
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def clear() -> None:
    with _lock:
        del _events[:]


def _now_us() -> float:
    return (time.perf_counter() - _epoch) * 1e6


class _NullSpan:
    """Shared do-nothing context manager returned while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "cat", "args", "_t0")

    def __init__(self, name: str, cat: str, args: Optional[dict]):
        self.name = name
        self.cat = cat
        self.args = args

    def set(self, **attrs):
        """Attach attributes discovered mid-span (e.g. a resolved route)."""
        if self.args is None:
            self.args = attrs
        else:
            self.args.update(attrs)
        return self

    def __enter__(self):
        self._t0 = _now_us()
        return self

    def __exit__(self, *exc):
        t1 = _now_us()
        ev = {"name": self.name, "cat": self.cat, "ph": "X",
              "ts": self._t0, "dur": t1 - self._t0,
              "pid": PID_RUNTIME, "tid": threading.get_ident()}
        if self.args:
            ev["args"] = self.args
        with _lock:
            _events.append(ev)
        return False


def span(name: str, cat: str = "repro", **attrs):
    """Context manager timing a runtime span; no-op when disabled.

    ``with obs.span("plan.build_schedule", m=m, k=k): ...``
    """
    if not _enabled:
        return NULL_SPAN
    return _Span(name, cat, attrs or None)


def instant(name: str, cat: str = "repro", **attrs) -> None:
    """A zero-duration marker event on the runtime timeline."""
    if not _enabled:
        return
    ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
          "ts": _now_us(), "pid": PID_RUNTIME,
          "tid": threading.get_ident()}
    if attrs:
        ev["args"] = attrs
    with _lock:
        _events.append(ev)


def complete_event(name: str, t0_s: float, t1_s: float, *,
                   tid: int = 0, pid: int = PID_SERVER,
                   cat: str = "serve",
                   args: Optional[dict] = None) -> None:
    """Record a complete event with explicit timestamps (seconds).

    Used for spans whose clock is not the host's — per-request lifecycle
    phases on the virtual serving clock, stamped post-hoc from the
    timestamps ``ServeRequest.to()`` recorded.  No-op when disabled.
    """
    if not _enabled:
        return
    ev = {"name": name, "cat": cat, "ph": "X", "ts": t0_s * 1e6,
          "dur": max(t1_s - t0_s, 0.0) * 1e6, "pid": pid, "tid": tid}
    if args:
        ev["args"] = args
    with _lock:
        _events.append(ev)


def events() -> List[Dict[str, Any]]:
    """A snapshot copy of the collected events."""
    with _lock:
        return list(_events)


def to_chrome() -> Dict[str, Any]:
    """The Chrome trace-event JSON object for the collected events."""
    meta = [
        {"ph": "M", "pid": PID_RUNTIME, "tid": 0, "name": "process_name",
         "args": {"name": "repro runtime (wall clock)"}},
        {"ph": "M", "pid": PID_SERVER, "tid": 0, "name": "process_name",
         "args": {"name": "repro serving clock"}},
    ]
    return {"traceEvents": meta + events(), "displayTimeUnit": "ms"}


def save(path: str) -> str:
    """Write the trace JSON to ``path`` (Chrome/Perfetto loadable)."""
    with open(path, "w") as fh:
        json.dump(to_chrome(), fh)
    return path


def _init_from_env() -> None:
    val = os.environ.get(ENV_TRACE)
    if val is None or val.strip().lower() in _FALSY:
        return
    enable()
    if val.strip().lower() not in ("1", "true", "on", "yes"):
        # value is an output path: write the trace at process exit
        atexit.register(save, val)


_init_from_env()
