"""Timeline export: trace records -> Chrome/Perfetto ``trace_event`` JSON.

Emits the legacy JSON trace format (``{"traceEvents": [...]}``) that both
``chrome://tracing`` and https://ui.perfetto.dev load directly: one track
(thread) per slot, one for the scheduler, one for the engine step stream,
one for the kernel stream.  Spans become ``ph: "X"`` complete events,
instants become ``ph: "i"``; timestamps are microseconds.

Determinism: with ``normalize=True`` (default) timestamps are shifted so
the earliest record lands at t=0 and events are sorted by a stable record
key — two replays of the same trace fingerprint under the virtual clock
serialize to byte-identical files (pinned by tests/test_obs.py, and the
port's copy against it by tests/test_torch_export.py).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Sequence

from repro_torch.obs.trace import TraceRecord

__all__ = ["to_chrome_trace", "dumps_chrome_trace", "write_chrome_trace",
           "top_spans"]

_PID = 1
_PROCESS_NAME = "flash-llm-serve"

# Canonical track order: scheduler first, engine/kernel streams, then slots
# in index order, then anything else alphabetically.
_TRACK_PRIORITY = {"scheduler": 0, "engine": 1, "kernel": 2}


def _track_sort_key(track: str):
    if track in _TRACK_PRIORITY:
        return (0, _TRACK_PRIORITY[track], track)
    if track.startswith("slot"):
        suffix = track[4:]
        if suffix.isdigit():
            return (1, int(suffix), track)
    return (2, 0, track)


def _us(seconds: float) -> int:
    # integer microseconds keep the JSON stable across float formatting
    return int(round(seconds * 1e6))


def to_chrome_trace(records: Sequence[TraceRecord], *,
                    normalize: bool = True) -> Dict[str, Any]:
    """Convert records to a ``trace_event`` JSON object (as a dict)."""
    tracks = sorted({r.track for r in records}, key=_track_sort_key)
    tids = {track: i + 1 for i, track in enumerate(tracks)}
    t0 = min((r.ts for r in records), default=0.0) if normalize else 0.0

    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
        "args": {"name": _PROCESS_NAME},
    }]
    for track in tracks:
        events.append({"name": "thread_name", "ph": "M", "pid": _PID,
                       "tid": tids[track], "args": {"name": track}})

    # stable order: (ts, track, name) — insertion order breaks ties so two
    # identical replays serialize identically
    indexed = sorted(enumerate(records),
                     key=lambda p: (p[1].ts, _track_sort_key(p[1].track),
                                    p[1].name, p[0]))
    for _, r in indexed:
        ev: Dict[str, Any] = {
            "name": r.name, "cat": r.cat, "pid": _PID, "tid": tids[r.track],
            "ts": _us(r.ts - t0),
        }
        if r.kind == "span":
            ev["ph"] = "X"
            ev["dur"] = _us(r.dur)
        else:
            ev["ph"] = "i"
            ev["s"] = "t"               # thread-scoped instant
        if r.args:
            ev["args"] = dict(r.args)
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dumps_chrome_trace(records: Sequence[TraceRecord], *,
                       normalize: bool = True) -> str:
    """Serialize deterministically (sorted keys, fixed separators)."""
    return json.dumps(to_chrome_trace(records, normalize=normalize),
                      sort_keys=True, separators=(",", ":"))


def write_chrome_trace(records: Sequence[TraceRecord], path: str, *,
                       normalize: bool = True) -> str:
    with open(path, "w") as f:
        f.write(dumps_chrome_trace(records, normalize=normalize))
    return path


def top_spans(trace: Dict[str, Any], n: int = 5) -> List[Dict[str, Any]]:
    """Top-``n`` complete spans by duration from a loaded trace dict.

    The longest-lived spans (typically request residencies) are the first
    place to look in a slow run.
    """
    tid_names = {}
    spans: List[Dict[str, Any]] = []
    events: Iterable[Dict[str, Any]] = trace.get("traceEvents", [])
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            tid_names[ev.get("tid")] = ev.get("args", {}).get("name", "?")
    for ev in events:
        if ev.get("ph") == "X":
            spans.append(ev)
    spans.sort(key=lambda e: (-e.get("dur", 0), e.get("ts", 0),
                              e.get("name", "")))
    out = []
    for ev in spans[:n]:
        out.append({
            "name": ev.get("name", "?"),
            "track": tid_names.get(ev.get("tid"), str(ev.get("tid"))),
            "ts_us": ev.get("ts", 0),
            "dur_us": ev.get("dur", 0),
            "args": ev.get("args", {}),
        })
    return out
