"""Trace-driven open-loop load generation for the serving stack.

DESIGN.md §13: the measurement half of the session API. The hand-rolled
"submit everything, run to completion" workloads the benches used to carry
say nothing about *user-visible* latency — an open-loop generator does:
requests arrive on their own schedule (Poisson) whether or not the server
keeps up, so queueing delay shows up in TTFT instead of being hidden by
closed-loop back-to-back submission.

Three pieces:

* **Traces** — :func:`make_trace` draws a reproducible request trace from
  a single ``numpy`` Generator seed: Poisson arrivals at ``rate`` requests
  per (virtual) second, multiplexed over weighted :class:`TenantSpec`
  tenants, each with its own fixed shared prompt prefix (drawn once per
  tenant — the prefix-cache workload knob), suffix-length range, and
  output-budget range. Same seed → byte-identical trace
  (:func:`trace_fingerprint` is the regression gate's receipt).
* **Virtual time** — :class:`StepClock` advances a fixed ``dt`` per engine
  step and doubles as the batcher's latency ``clock``, so replayed TTFT /
  TPOT are *deterministic* functions of scheduling decisions (units:
  steps), immune to runner speed — the only latency form a CI gate can
  diff (`benchmarks/check_regression.py` module docstring). Wall-clock
  latencies are measured alongside and reported, ungated.
* **Replay** — :func:`replay` feeds a trace into a
  `serving.api.StreamingServer` open-loop: submit everything whose arrival
  time has passed, step once, tick. `api.Backpressure` sheds the request
  and `api.RequestRejected` rejects it (both recorded as distinct
  counters, never retried). :class:`ReplayResult` summarizes both clocks'
  percentiles plus completion / shed / rejected / deadline-missed /
  quarantined counts — the failure-mode split the chaos bench gates on.
  Deadline budgets ride the trace (per-tenant), so chaos scenarios replay
  bit-exactly: same trace seed + same `serving.faults.FaultPlan` seed →
  the same failures at the same steps under the virtual clock.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import trace as obs_trace
from repro_torch.serving import api
from repro_torch.serving.config import SLOSpec
from repro_torch.serving.scheduler import latency_summary


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One traffic class. ``prefix_len`` tokens are drawn once per tenant
    and shared by all its requests (0 = no sharing); suffixes are unique.
    Ranges are ``[lo, hi)`` like ``numpy.random.Generator.integers``."""

    name: str
    weight: float = 1.0
    prefix_len: int = 0
    suffix_len: Tuple[int, int] = (8, 16)
    max_new: Tuple[int, int] = (8, 9)
    # Latency budgets (virtual seconds) every request of this tenant
    # carries; None = no deadline (the default keeps old traces identical).
    ttft_deadline: Optional[float] = None
    deadline: Optional[float] = None
    # Typed SLO (soft targets + hard deadlines, DESIGN.md §16) every
    # request carries. When both forms are given, the plain deadlines fold
    # into the SLO at trace build time so the API layer never sees both.
    slo: Optional[SLOSpec] = None


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One arrival: at virtual time ``t``, tenant ``tenant`` submits
    ``prompt`` with a ``max_new_tokens`` budget."""

    t: float
    rid: int
    tenant: str
    prompt: np.ndarray
    max_new_tokens: int
    ttft_deadline: Optional[float] = None
    deadline: Optional[float] = None
    slo: Optional[SLOSpec] = None


def make_trace(*, seed: int, n_requests: int, rate: float,
               tenants: Sequence[TenantSpec], vocab: int
               ) -> List[TraceRequest]:
    """Draw a Poisson-arrival trace. Every random quantity comes from one
    ``default_rng(seed)`` in a fixed draw order (tenant prefixes first,
    then per-request inter-arrival / tenant / suffix / budget), so the
    trace is byte-for-byte reproducible from ``seed`` alone."""
    if rate <= 0:
        raise ValueError(f"arrival rate must be positive, got {rate}")
    rng = np.random.default_rng(seed)
    prefixes = {t.name: rng.integers(0, vocab, t.prefix_len)
                .astype(np.int64) for t in tenants}
    weights = np.asarray([t.weight for t in tenants], np.float64)
    weights = weights / weights.sum()
    trace: List[TraceRequest] = []
    t = 0.0
    for rid in range(n_requests):
        t += float(rng.exponential(1.0 / rate))
        spec = tenants[int(rng.choice(len(tenants), p=weights))]
        suffix = rng.integers(0, vocab,
                              int(rng.integers(*spec.suffix_len)))
        prompt = np.concatenate([prefixes[spec.name],
                                 suffix.astype(np.int64)])
        slo, ttft_dl, dl = spec.slo, spec.ttft_deadline, spec.deadline
        if slo is not None and (ttft_dl is not None or dl is not None):
            # Fold plain deadlines into the SLO (explicit SLO deadlines
            # win) and null the flat fields — the API rejects mixing.
            slo = dataclasses.replace(
                slo,
                ttft_deadline_ms=slo.ttft_deadline_ms if
                slo.ttft_deadline_ms is not None else
                (None if ttft_dl is None else ttft_dl * 1e3),
                deadline_ms=slo.deadline_ms if slo.deadline_ms is not None
                else (None if dl is None else dl * 1e3))
            ttft_dl = dl = None
        trace.append(TraceRequest(
            t=t, rid=rid, tenant=spec.name, prompt=prompt,
            max_new_tokens=int(rng.integers(*spec.max_new)),
            ttft_deadline=ttft_dl, deadline=dl, slo=slo))
    return trace


def trace_fingerprint(trace: Sequence[TraceRequest]) -> str:
    """sha256 over every field of every request — byte-for-byte trace
    identity for the reproducibility contract (same --seed, same hash)."""
    h = hashlib.sha256()
    for r in trace:
        h.update(f"{r.t!r}|{r.rid}|{r.tenant}|{r.max_new_tokens}|"
                 f"{r.ttft_deadline!r}|{r.deadline!r}|".encode())
        if r.slo is not None:
            # Appended only when present: SLO-free traces keep the exact
            # hashes the committed baselines were stamped with.
            h.update(f"slo:{sorted(r.slo.as_dict().items())!r}|".encode())
        h.update(np.ascontiguousarray(r.prompt, np.int64).tobytes())
    return h.hexdigest()


class StepClock:
    """Virtual clock: ``dt`` seconds per engine step. Passed as the
    batcher's ``clock``, it makes every latency stamp a deterministic
    function of scheduling decisions (a TTFT of 3.0 at dt=1.0 means "first
    token at the third step"), which is what lets CI gate p99 latency
    without runner-speed noise."""

    def __init__(self, dt: float = 1.0, t0: float = 0.0):
        self.dt = dt
        self.t = t0

    def __call__(self) -> float:
        return self.t

    def tick(self) -> None:
        self.t += self.dt

    def advance(self, dt: float) -> None:
        """Extra time beyond the per-step tick — injected latency spikes
        and retry backoff (`Scheduler.advance_clock`), so deadline math
        sees the lost time deterministically."""
        self.t += dt


class CostClock(StepClock):
    """Virtual clock whose per-step ``dt`` tracks *launch cost*: a fixed
    ``base`` (launch overhead) plus ``per_position`` virtual seconds per
    query position the engine computed that step (read from
    ``SchedulerMetrics.compute_positions`` via :meth:`bind`).

    The flat :class:`StepClock` charges a whole-prompt bucketed prefill
    the same dt as a 1-token decode step, which hides exactly the
    head-of-line blocking chunked prefill exists to fix. Under a cost
    clock a k×bucket prefill launch stalls every concurrent stream for
    ~k×bucket×per_position virtual seconds, while chunked admission
    amortizes the same positions across many cheap mixed steps — making
    the TTFT win measurable and still fully deterministic (positions are
    a function of scheduling decisions, not runner speed)."""

    def __init__(self, base: float = 0.25, per_position: float = 1 / 64,
                 t0: float = 0.0):
        super().__init__(dt=base, t0=t0)
        self.base = base
        self.per_position = per_position
        self._metrics = None
        self._last_positions = 0

    def bind(self, metrics) -> "CostClock":
        """Attach the live SchedulerMetrics to read compute_positions
        from (call once, after the server is built)."""
        self._metrics = metrics
        self._last_positions = int(metrics.compute_positions)
        return self

    def tick(self) -> None:
        d = 0
        if self._metrics is not None:
            now = int(self._metrics.compute_positions)
            d = now - self._last_positions
            self._last_positions = now
        self.t += self.base + self.per_position * d


@dataclasses.dataclass
class _WallStamps:
    submit: float
    first_token: float = -1.0
    finish: float = -1.0
    tokens: int = 0


#: finish reasons that end a session *without* completing it — the replay
#: summary counts them apart from natural stop/budget completions.
FAILURE_REASONS = ("cancelled", "deadline", "quarantined")


@dataclasses.dataclass
class ReplayResult:
    """What one open-loop replay did, on both clocks."""

    responses: List[api.GenerationResponse]
    rejected: List[int]                  # rids refused (never runnable)
    steps: int
    wall_s: float                        # total replay wall time
    wall_ttft_s: List[float]
    wall_tpot_s: List[float]
    shed: List[int] = dataclasses.field(default_factory=list)
    # rids shed by Backpressure (transient — a client would retry)
    slo: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)
    # per-tenant SLO attainment counters (scheduler.metrics.slo_attainment)

    def summary(self) -> Dict[str, Any]:
        done = [r for r in self.responses
                if r.finish_reason not in FAILURE_REASONS]
        by_reason: Dict[str, int] = {}
        for r in self.responses:
            by_reason[r.finish_reason] = by_reason.get(r.finish_reason,
                                                       0) + 1
        toks = sum(len(r.tokens) for r in done)
        return {
            "completed": len(done),
            "cancelled": by_reason.get("cancelled", 0),
            "deadline_missed": by_reason.get("deadline", 0),
            "quarantined": by_reason.get("quarantined", 0),
            "shed": len(self.shed),
            "rejected": len(self.rejected),
            "steps": self.steps,
            "tokens": toks,
            "tok_per_s": toks / max(self.wall_s, 1e-9),
            # virtual = the server clock's stamps (deterministic under
            # StepClock; units = virtual seconds, i.e. steps at dt=1)
            "virtual": {
                "ttft": latency_summary(
                    [r.ttft_s for r in done if r.ttft_s is not None]),
                "tpot": latency_summary(
                    [r.tpot_s for r in done if r.tpot_s is not None]),
            },
            # wall = host time around the same replay (runner-dependent;
            # reported for humans, never gated)
            "wall": {
                "ttft": latency_summary(self.wall_ttft_s),
                "tpot": latency_summary(self.wall_tpot_s),
            },
            **({"slo": self.slo} if self.slo else {}),
        }


def replay(server: api.StreamingServer, trace: Sequence[TraceRequest],
           clock: StepClock, max_steps: int = 100_000,
           on_step=None) -> ReplayResult:
    """Open-loop replay: before each step, submit every request whose
    arrival time has passed on the virtual clock (idle steps advance time
    when the server is ahead of the trace). `api.Backpressure` sheds the
    arrival (transient refusal — counted in ``shed``), `api.
    RequestRejected` drops it permanently (``rejected``); neither retries.
    Wall TTFT / TPOT are stamped here from the streaming callbacks,
    independent of the server's (possibly virtual) latency clock.
    ``on_step(step_index, server)``, if given, runs after each engine step
    — the chaos bench's hook for mid-run snapshots and kill points."""
    pending = deque(sorted(trace, key=lambda r: (r.t, r.rid)))
    # Latency reservoirs reseed from the trace fingerprint (obs/metrics.py):
    # replayed percentiles become a pure function of the trace, independent
    # of whatever ran on this server before — the determinism the CI
    # latency gates and the timeline-export tests rely on.
    server.metrics.seed_latency(trace_fingerprint(trace))
    if hasattr(clock, "bind"):          # CostClock: charge launch cost
        clock.bind(server.metrics)
    # An enabled tracer stamps from the replay's virtual clock (DESIGN §15:
    # a replayed timeline is a function of the trace, not of the runner).
    tr = obs_trace.get_tracer()
    if tr.enabled:
        tr.set_clock(clock)
    responses: List[api.GenerationResponse] = []
    rejected: List[int] = []
    shed: List[int] = []
    stamps: Dict[str, _WallStamps] = {}

    def on_token(ev: api.TokenEvent) -> None:
        st = stamps[ev.session_id]
        if st.first_token < 0:
            st.first_token = time.monotonic()
        st.tokens = ev.index + 1
        if ev.finish_reason:
            st.finish = time.monotonic()

    steps = 0
    t0 = time.monotonic()
    while pending or server.busy:
        if steps >= max_steps:
            raise RuntimeError(
                f"replay did not drain within {max_steps} steps "
                f"({len(pending)} arrivals pending)")
        while pending and pending[0].t <= clock():
            tr = pending.popleft()
            sid = f"{tr.tenant}/{tr.rid}"
            stamps[sid] = _WallStamps(submit=time.monotonic())
            try:
                server.submit(api.GenerationRequest(
                    prompt=tr.prompt, max_new_tokens=tr.max_new_tokens,
                    session_id=sid, on_token=on_token,
                    ttft_deadline_s=tr.ttft_deadline,
                    deadline_s=tr.deadline, slo=tr.slo))
            except api.Backpressure:
                del stamps[sid]
                shed.append(tr.rid)
            except api.RequestRejected:
                del stamps[sid]
                rejected.append(tr.rid)
        responses.extend(server.step())
        if on_step is not None:
            on_step(steps, server)
        clock.tick()
        steps += 1
    wall_s = time.monotonic() - t0
    wall_ttft = [st.first_token - st.submit for st in stamps.values()
                 if st.first_token >= 0]
    wall_tpot = [(st.finish - st.first_token) / (st.tokens - 1)
                 for st in stamps.values()
                 if st.finish >= 0 and st.tokens >= 2]
    return ReplayResult(responses=responses, rejected=rejected,
                        steps=steps, wall_s=wall_s,
                        wall_ttft_s=wall_ttft, wall_tpot_s=wall_tpot,
                        shed=shed,
                        slo={k: dict(v) for k, v in
                             server.metrics.slo_attainment.items()})


def sample_prompts(*, seed: int, n: int, tenants: Sequence[TenantSpec],
                   vocab: int) -> List[Tuple[str, np.ndarray]]:
    """Closed-loop helper: the same tenant/prefix/suffix machinery as
    :func:`make_trace` without arrival times — for benches that submit a
    whole workload up front (`benchmarks/e2e_throughput.py`). Returns
    ``(tenant_name, prompt)`` pairs, reproducible from ``seed``."""
    trace = make_trace(seed=seed, n_requests=n, rate=1.0,
                       tenants=tenants, vocab=vocab)
    return [(r.tenant, r.prompt) for r in trace]


def open_loop_trace(*, seed: int, n_requests: int, rate: float,
                    vocab: int,
                    shared_frac: Optional[float] = None
                    ) -> List[TraceRequest]:
    """Convenience two-tenant mix: a shared-prefix tenant (weight
    ``shared_frac``) plus a unique-prompt tenant. The default smoke/bench
    traffic shape; pass explicit :class:`TenantSpec`\\ s to
    :func:`make_trace` for anything richer."""
    if shared_frac is None:
        shared_frac = 0.5
    tenants = [
        TenantSpec("shared", weight=shared_frac, prefix_len=16,
                   suffix_len=(3, 7), max_new=(6, 9)),
        TenantSpec("unique", weight=1.0 - shared_frac, prefix_len=0,
                   suffix_len=(8, 15), max_new=(6, 9)),
    ]
    return make_trace(seed=seed, n_requests=n_requests, rate=rate,
                      tenants=tenants, vocab=vocab)
