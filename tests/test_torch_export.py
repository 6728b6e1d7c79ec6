"""The port's trace export (``repro_torch.obs.export``) against the
reference's (``repro.obs.export``): the same records give the same
Chrome/Perfetto JSON, byte for byte, and the same top spans.

The records come from a seeded numpy draw, mixed spans and instants over
scheduler, engine, kernel, slot and other tracks, with ties in ``ts`` so
the stable order is exercised; the same fields build each package's
``TraceRecord``.
"""

import numpy as np
import pytest

from repro.obs import export as ref_export
from repro.obs import trace as ref_trace
from repro_torch.obs import export, trace

TRACKS = ("scheduler", "engine", "kernel", "slot0", "slot1", "slot10",
          "slot2", "fault", "slotx")


def _fields(seed, n=64):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        span = bool(rng.integers(0, 2))
        out.append(dict(
            ts=float(rng.integers(0, 20)) * 0.25 + 3.0,
            kind="span" if span else "event",
            cat=str(rng.choice(["sched", "step", "fault", "kernel"])),
            name=str(rng.choice(["admit", "decode", "prefill", "evict"])),
            track=str(rng.choice(TRACKS)),
            dur=float(rng.random()) if span else 0.0,
            args={"uid": int(i), "bucket": int(rng.integers(8, 64))}))
    return out


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chrome_trace_equals_reference(seed, normalize):
    fields = _fields(seed)
    mine = [trace.TraceRecord(**f) for f in fields]
    ref = [ref_trace.TraceRecord(**f) for f in fields]
    assert export.to_chrome_trace(mine, normalize=normalize) == \
        ref_export.to_chrome_trace(ref, normalize=normalize)
    assert export.dumps_chrome_trace(mine, normalize=normalize) == \
        ref_export.dumps_chrome_trace(ref, normalize=normalize)


@pytest.mark.parametrize("n", [1, 5, 100])
def test_top_spans_equal_reference(n):
    fields = _fields(7)
    doc = ref_export.to_chrome_trace(
        [ref_trace.TraceRecord(**f) for f in fields])
    assert export.top_spans(doc, n) == ref_export.top_spans(doc, n)


def test_empty_and_written_trace(tmp_path):
    assert export.to_chrome_trace([]) == ref_export.to_chrome_trace([])
    fields = _fields(3, n=8)
    path = tmp_path / "t.json"
    got = export.write_chrome_trace(
        [trace.TraceRecord(**f) for f in fields], str(path))
    assert got == str(path)
    assert path.read_text() == ref_export.dumps_chrome_trace(
        [ref_trace.TraceRecord(**f) for f in fields])


def test_tracer_records_export():
    """Records from the port's own tracer (virtual clock) export as the
    reference's do for the same calls."""
    tracers = []
    for mod in (trace, ref_trace):
        t = mod.Tracer()
        t.enable()
        clock = iter(np.arange(0.0, 10.0, 0.5))
        t.clock = lambda clock=clock: float(next(clock))
        t.event("sched", "admit", "scheduler", uid=1)
        t0 = t.clock()
        t.span("step", "decode", "engine", t0, batch=4)
        tracers.append(t)
    mine, ref = tracers
    assert export.dumps_chrome_trace(mine.records()) == \
        ref_export.dumps_chrome_trace(ref.records())
