"""Observability cross-check pass (``tools/torch_check.py --obs``).

The counterpart of ``repro.analysis.obs_pass``. The metrics registry and
the trace stream are two views of the same events:
``SchedulerMetrics.preemptions`` counts what the ``preempt`` trace events
narrate, ``quarantined`` pairs with ``quarantine`` events, and every
fault the injector fires must land in the timeline. This pass runs the
reference's small fault-laden replay (its seeded trace and its
:class:`~repro_torch.serving.faults.FaultPlan`: a transient step error,
NaN-poisoned logits, a pool storm and a latency spike) on the port's
``StreamingServer`` with a private tracer, and holds counter ==
event count for every paired series. A mismatch is an ``OB-EVENT``
finding anchored to the pseudo-path ``obs:<scenario>`` (``obs:cuda:...``
on the card).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.analysis.findings import Finding
from repro_torch.device import device_of, resolve_device

#: (metrics attribute, trace (cat, name)) pairs that must count together.
PAIRED_SERIES: Tuple[Tuple[str, Tuple[str, str]], ...] = (
    ("admitted", ("sched", "admit")),
    ("preemptions", ("sched", "preempt")),
    ("quarantined", ("sched", "quarantine")),
    ("deadline_expired", ("sched", "deadline")),
    ("cancelled", ("sched", "cancel")),
    ("degradation_transitions", ("sched", "degradation")),
    ("step_retries", ("fault", "retry")),
    # one "sched"/"chunk" event per mixed launch (0 == 0 unchunked)
    ("mixed_steps", ("sched", "chunk")),
)

_ARCH = "tinyllama_1_1b"


def _scenario(seed: int, *, params=None, device=None):
    """The reference's chaos replay with a private tracer; returns
    (records, metrics, injector, n_responses). ``params``: the smoke
    model's (a test gives the reference's, through ``convert``); by
    default drawn from ``seed`` on ``device`` (the card unless "cpu")."""
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving import api, faults, loadgen
    from repro_torch.serving.config import ServeConfig

    cfg = configs.smoke(_ARCH)
    if params is None:
        params = transformer.init_model(cfg, seed=seed, device=device)
    plan = faults.FaultPlan([
        faults.FaultEvent(step=2, kind="step_error", op="decode",
                          attempts=1),
        faults.FaultEvent(step=3, kind="nan_logits", slot=0, op="decode"),
        faults.FaultEvent(step=4, kind="pool_storm", blocks=10, duration=3),
        faults.FaultEvent(step=6, kind="slow_step", delay_s=4.0),
    ])
    trace = loadgen.make_trace(
        seed=seed, n_requests=10, rate=0.8, vocab=cfg.vocab,
        tenants=[loadgen.TenantSpec("obs", suffix_len=(4, 10),
                                    max_new=(6, 10))])
    clock = loadgen.StepClock(dt=1.0)
    tracer = Tracer().enable(clock)
    server = api.StreamingServer(
        params, cfg, config=ServeConfig.from_kwargs(
            n_slots=4, max_len=64, cache_kind="paged", block_size=8,
            n_blocks=16),
        clock=clock, fault_plan=plan, tracer=tracer)
    result = loadgen.replay(server, trace, clock)
    return (tracer.records(), server.batcher.metrics,
            server.batcher.faults, len(result.responses))


def event_counts(records) -> Dict[Tuple[str, str], int]:
    """(cat, name) -> the trace's events of that name."""
    out: Dict[Tuple[str, str], int] = {}
    for r in records:
        if r.kind == "event":
            out[(r.cat, r.name)] = out.get((r.cat, r.name), 0) + 1
    return out


def scenario_path(seed: int, device) -> str:
    kind = torch.device(device).type
    where = "" if kind == "cpu" else f"{kind}:"
    return f"obs:{where}chaos_replay(seed={seed})"


def run_obs_pass(seed: int = 0, *, params=None, device=None
                 ) -> Tuple[List[Finding], Dict[str, object]]:
    """Cross-check the metrics counters against the trace event stream
    (on ``params``' device, else on ``device``: the card unless "cpu");
    stats carry each paired counter and the ``targets`` audited."""
    dev = device_of(params) if params is not None else \
        resolve_device(device)
    records, metrics, injector, n_responses = _scenario(
        seed, params=params, device=dev)
    path = scenario_path(seed, dev)
    hint = ("every counter bump and its trace event live together at the "
            "source (scheduler.py / batching.py / faults.py) — re-pair them")
    found: List[Finding] = []
    by_key = event_counts(records)
    counters: Dict[str, int] = {}
    for attr, (cat, name) in PAIRED_SERIES:
        counter = counters[attr] = getattr(metrics, attr)
        events = by_key.get((cat, name), 0)
        if counter != events:
            found.append(Finding(
                "OB-EVENT", path, 0,
                f"metrics.{attr}={counter} but the trace carries {events} "
                f"{name!r} event(s)", hint))
    # injected faults only: "retry" is the batcher's reaction (paired with
    # step_retries above), not an injector firing
    n_fault_events = sum(1 for r in records
                         if r.kind == "event" and r.cat == "fault"
                         and r.name != "retry")
    if len(injector.fired) != n_fault_events:
        found.append(Finding(
            "OB-EVENT", path, 0,
            f"injector fired {len(injector.fired)} fault(s) but the trace "
            f"carries {n_fault_events} fault event(s)", hint))
    # every request that finished must have closed its slot span
    n_finish = by_key.get(("sched", "finish"), 0)
    n_slot_spans = sum(1 for r in records
                       if r.kind == "span" and r.track.startswith("slot"))
    n_failed = (metrics.quarantined + metrics.deadline_expired
                + metrics.cancelled + metrics.preemptions)
    if n_slot_spans != n_finish + n_failed:
        found.append(Finding(
            "OB-EVENT", path, 0,
            f"{n_slot_spans} slot span(s) for {n_finish} finish + "
            f"{n_failed} fail/preempt event(s) — a request left a slot "
            f"without closing its span", hint))
    stats = {"records": len(records), "checks": len(PAIRED_SERIES) + 2,
             "nonzero_series": sum(1 for v in counters.values() if v),
             "responses": n_responses, "counters": counters,
             "fired": len(injector.fired), "targets": [path]}
    return found, stats

