"""Structured runtime tracing: typed, timestamped span/event records.

One process-wide :class:`Tracer` (``get_tracer()``), off by default, backed
by a bounded ring buffer so a long-running server never grows without
bound.  Timestamps come from an injectable clock: under a loadgen
``StepClock`` replay the clock is virtual (seconds == engine steps × dt),
so two replays of the same trace fingerprint produce bit-identical
records — the determinism the CI latency gates already rely on extends to
timelines (DESIGN §15).

Hot-path contract: every instrumentation site is guarded by

    tr = self.tracer
    if tr is not None and tr.enabled:
        tr.event(...)

so with tracing off the serving step pays exactly one attribute check and
allocates nothing.  ``tests/test_obs.py`` pins this with an overhead guard.

Records are plain tuples-of-fields (a small dataclass): ``kind`` is either
``"event"`` (instant) or ``"span"`` (has a duration); ``cat`` groups
records (``sched`` / ``step`` / ``fault`` / ``kernel``); ``track`` names
the Perfetto row the record lands on (``scheduler``, ``slot0``..``slotN``,
``engine``, ``kernel``).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

__all__ = ["TraceRecord", "Tracer", "get_tracer", "set_tracer"]

_EMPTY: Dict[str, Any] = {}


@dataclasses.dataclass(frozen=True)
class TraceRecord:
    """One trace record. ``dur == 0.0`` for instant events."""

    ts: float                 # seconds on the tracer's clock (virtual or wall)
    kind: str                 # "event" | "span"
    cat: str                  # "sched" | "step" | "fault" | "kernel" | ...
    name: str
    track: str                # Perfetto row: "scheduler" | "slot3" | ...
    dur: float = 0.0          # span duration in clock seconds
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class Tracer:
    """Ring-buffered trace collector.  Off by default; bounded memory."""

    __slots__ = ("enabled", "clock", "capacity", "dropped", "_ring",
                 "_seen")

    def __init__(self, capacity: int = 65536,
                 clock: Optional[Callable[[], float]] = None) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = False
        self.clock: Callable[[], float] = clock or time.monotonic
        self.capacity = capacity
        self.dropped = 0                      # records evicted by the ring
        self._ring: deque = deque(maxlen=capacity)
        self._seen: set = set()               # keys that :meth:`first` saw

    # -- lifecycle ----------------------------------------------------------
    def enable(self, clock: Optional[Callable[[], float]] = None) -> "Tracer":
        """Turn tracing on; optionally rebind the timestamp source."""
        if clock is not None:
            self.clock = clock
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def set_clock(self, clock: Callable[[], float]) -> None:
        """Rebind the timestamp source (e.g. a loadgen ``StepClock``)."""
        self.clock = clock

    def clear(self) -> None:
        self._ring.clear()
        self._seen.clear()
        self.dropped = 0

    def first(self, key: Any) -> bool:
        """True the first time ``key`` is asked about since the last
        :meth:`clear`: a site that runs on every eager call (the port's
        kernel dispatch) records one event per distinct key, so it cannot
        evict the scheduler's records from the ring."""
        if key in self._seen:
            return False
        self._seen.add(key)
        return True

    # -- emission -----------------------------------------------------------
    def event(self, cat: str, name: str, track: str, **args: Any) -> None:
        """Record an instant event.  No-op when disabled."""
        if not self.enabled:
            return
        self._push(TraceRecord(self.clock(), "event", cat, name, track,
                               0.0, args or _EMPTY))

    def span(self, cat: str, name: str, track: str, t0: float,
             t1: Optional[float] = None, **args: Any) -> None:
        """Record a completed span ``[t0, t1]`` (t1 defaults to now)."""
        if not self.enabled:
            return
        end = self.clock() if t1 is None else t1
        self._push(TraceRecord(t0, "span", cat, name, track,
                               max(0.0, end - t0), args or _EMPTY))

    def _push(self, rec: TraceRecord) -> None:
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(rec)

    # -- inspection ---------------------------------------------------------
    def records(self) -> List[TraceRecord]:
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)


# Process-wide default tracer.  Components capture a reference at
# construction time (``tracer or get_tracer()``), so enabling the global
# tracer lights up every layer without re-plumbing constructors.
_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-wide tracer (tests); returns the previous one."""
    global _TRACER
    prev, _TRACER = _TRACER, tracer
    return prev
