"""Continuous batching: the facade over scheduler + stepper.

The port's counterpart of ``repro.serving.batching``. The paper's
throughput win comes from freeing GPU memory (sparse weights) so *more*
requests fit in flight; the serving loop converts that headroom into
tokens per GPU-second: a fixed pool of B decode slots, refilled from a
request queue without stopping the decode loop.

The loop itself lives in two modules:

* ``serving/scheduler.py`` — the scheduling-policy core (a copy of the
  reference's): bucketed FIFO admission, block-availability gating,
  preemption, cancellation, deadlines, degradation, metrics. Pure host
  state machine; plans work, commits results, never touches a tensor.
* ``serving/step.py`` — the device layer: params, K/V cache, and the
  prefill / decode entry points that execute those plans, the decode
  step as a captured CUDA graph on a card.

:class:`ContinuousBatcher` composes the two behind the reference's
interface (submit / step / run_to_completion, plus ``slots``, ``queue``,
``pos``, ``tables``, ``pool``, ``metrics``…). Streaming, cancellation and
backpressure sit on ``serving/api.py``.

Admission: prompts are right-padded to static power-of-two length
buckets (``engine.length_buckets``); up to ``admit_k`` queued requests of
one bucket prefill in one call, the group padded to a static ``k`` by
repeating a real row; their K/V is written into the shared cache in
place. Decode is one token for every slot per engine step, each slot at
its own absolute position. Requests end on EOS / stop tokens, on their
``max_new_tokens`` budget, or at ``max_len``.

Cache kinds (DESIGN.md §7 vs §10): ``cache_kind="dense"`` is the shared
``[n_slots, max_len]`` cache; ``cache_kind="paged"`` is the block pool,
where requests hold only the blocks they have filled, full prompt blocks
are prefix-shared by content chain-hash, admission is gated on block
availability, and on pool exhaustion mid-decode the youngest request is
preempted and re-queued (recompute resume: its prompt+generated tokens
re-prefill on re-admission, which regenerates an identical stream for
greedy and for the per-slot folded sampling draws alike).

Not ported yet (ROADMAP.md queue 1 item 9): speculative decoding
(``spec_k > 0``) and chunked prefill raise at construction.
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Dict, List, Optional

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import Tracer, get_tracer
from repro_torch.serving import engine, faults
from repro_torch.serving.config import ServeConfig, SLOSpec
from repro_torch.serving.scheduler import (DegradationPolicy,  # noqa: F401
                                           Request, Scheduler,
                                           SchedulerMetrics)
from repro_torch.serving.step import NOT_PORTED, DeviceStepper


class ContinuousBatcher:
    """Slot-based continuous batching over a fixed decode batch B.

    eos_id / stop_ids: generation stops when the model emits any of these
    (the stop token is kept in ``generated``). ``admit_k`` is the static
    admission batch. ``min_bucket`` floors the bucket ladder.

    ``cache_kind="paged"`` swaps the dense per-slot cache for the block
    pool: ``block_size`` positions per block, ``n_blocks`` usable blocks
    (default: the dense cache's exact byte equivalent, n_slots *
    blocks_per_seq), ``reserve_blocks`` held back at admission as the
    decode-growth margin, ``prefix_sharing`` dedupes full prompt blocks.
    ``temperature`` / ``top_k`` / ``seed`` select per-slot sampling (0.0 =
    exact greedy, the default).

    ``clock`` injects the clock of the per-request latency stamps
    (default ``time.monotonic``; ``serving.loadgen.StepClock`` makes
    replayed traces deterministic). ``graph`` is the stepper's (the decode
    step as a CUDA graph; default on for params on a card).

    Configuration: pass ``config=ServeConfig(...)``. The flat keyword set
    still works through ``ServeConfig.from_kwargs`` with a
    ``DeprecationWarning``, as in the reference.
    """

    def __init__(self, params, cfg: ModelConfig, *,
                 config: Optional[ServeConfig] = None,
                 clock: Optional[Callable[[], float]] = None,
                 fault_plan=None, degradation=None,
                 tracer: Optional[Tracer] = None,
                 graph: Optional[bool] = None, **legacy):
        if config is None:
            if legacy:
                warnings.warn(
                    "flat ContinuousBatcher/StreamingServer kwargs are "
                    "deprecated; pass config=ServeConfig(...) "
                    "(serving/config.py)", DeprecationWarning, stacklevel=3)
            config = ServeConfig.from_kwargs(**legacy)
        elif legacy:
            raise TypeError(f"pass config=ServeConfig(...) OR legacy "
                            f"kwargs, not both: {sorted(legacy)}")
        config.validate()
        sc = config.scheduler
        if config.spec_k:
            raise NotImplementedError(NOT_PORTED.format("spec_k > 0"))
        if sc.chunked_prefill:
            raise NotImplementedError(NOT_PORTED.format("chunked_prefill"))
        self.config = config
        self.params = params
        self.cfg = cfg
        self.n_slots = sc.n_slots
        self.max_len = sc.max_len
        self.backend = config.backend
        self.paged = config.cache_kind == "paged"
        self.temperature = float(config.temperature)
        self.top_k = int(config.top_k)
        stop = frozenset(([] if sc.eos_id is None else [int(sc.eos_id)])
                         + [int(t) for t in sc.stop_ids])
        self.admit_k = max(1, min(sc.admit_k or min(sc.n_slots, 4),
                                  sc.n_slots))
        # The port serves pure-attention stacks only
        # (transformer._check_family), where bucket padding is exact.
        buckets = engine.length_buckets(sc.max_len, sc.min_bucket)
        n_blocks = config.n_blocks
        if self.paged:
            self.block_size = config.block_size
            self.max_blocks = transformer.paged_blocks_per_seq(
                cfg, sc.max_len, config.block_size)
            if n_blocks is None:
                n_blocks = sc.n_slots * self.max_blocks  # dense byte-equiv
        self.max_step_retries = int(config.max_step_retries)
        self.retry_backoff_s = float(config.retry_backoff_s)
        self.faults = (fault_plan if isinstance(fault_plan,
                                                faults.FaultInjector)
                       else faults.FaultInjector(fault_plan)
                       if fault_plan is not None else None)
        self.tracer = tracer if tracer is not None else get_tracer()
        if self.faults is not None:
            self.faults.tracer = self.tracer    # one timeline per server
        self.sched = Scheduler(
            n_slots=sc.n_slots, max_len=sc.max_len, stop_ids=stop,
            admit_k=self.admit_k, buckets=buckets, ring_len=None,
            paged=self.paged, block_size=config.block_size,
            n_blocks=n_blocks,
            max_blocks=self.max_blocks if self.paged else 0,
            reserve_blocks=sc.reserve_blocks,
            prefix_sharing=config.prefix_sharing,
            request_history=sc.request_history,
            sampled=self.temperature != 0.0,
            clock=clock, degradation=degradation, tracer=self.tracer)
        self.stepper = DeviceStepper(
            params, cfg, n_slots=sc.n_slots, max_len=sc.max_len,
            backend=config.backend,
            physical_blocks=(self.sched.pool.physical_blocks
                             if self.paged else None),
            block_size=config.block_size,
            temperature=config.temperature, top_k=config.top_k,
            seed=config.seed, faults=self.faults, tracer=self.tracer,
            graph=graph)

    # -- delegation: the reference's introspection surface ------------------
    @property
    def buckets(self):
        return self.sched.buckets

    @property
    def stop_ids(self):
        return self.sched.stop_ids

    @property
    def queue(self):
        return self.sched.queue

    @property
    def requests(self):
        return self.sched.requests

    @property
    def slots(self):
        return self.sched.slots

    @property
    def pos(self):
        return self.sched.pos

    @property
    def last_token(self):
        return self.sched.last_token

    @property
    def tables(self):
        return self.sched.tables

    @property
    def pool(self):
        return self.sched.pool

    @property
    def metrics(self) -> SchedulerMetrics:
        return self.sched.metrics

    @metrics.setter
    def metrics(self, value: SchedulerMetrics) -> None:
        self.sched.metrics = value

    @property
    def cache(self):
        return self.stepper.cache

    @property
    def prefill_compiles(self) -> int:
        """Distinct prefill shapes run so far (one per bucket hit): the
        shapes the reference would compile."""
        return len(self.stepper.prefill_shapes)

    @property
    def busy(self) -> bool:
        """Anything queued or decoding — ``run_to_completion``'s (and the
        session API's) drain condition."""
        return self.sched.busy

    # -- public API ---------------------------------------------------------
    def submit(self, uid: int, prompt, max_new_tokens: int, *,
               ttft_deadline_s: Optional[float] = None,
               deadline_s: Optional[float] = None,
               slo: Optional[SLOSpec] = None) -> Request:
        return self.sched.submit(uid, prompt, max_new_tokens,
                                 ttft_deadline_s=ttft_deadline_s,
                                 deadline_s=deadline_s, slo=slo)

    def cancel(self, uid: int) -> Optional[Request]:
        """Cancel a live request in any state (queued, active, preempted);
        see :meth:`Scheduler.cancel`."""
        return self.sched.cancel(uid)

    def _launch(self, op: str, fn):
        """Run one device launch, retrying injected (or wrapped-real)
        transient failures with bounded exponential backoff. A
        ``TransientStepError`` raises *before* anything touches the device,
        so re-running ``fn`` is bitwise the launch that should have
        happened; each backoff advances the virtual clock. Exhausting the
        budget raises ``StepFault``."""
        delay = self.retry_backoff_s
        attempt = 0
        while True:
            try:
                return fn()
            except faults.TransientStepError as e:
                attempt += 1
                self.sched.metrics.step_retries += 1
                self.sched.note_fault()
                tr = self.tracer
                if tr.enabled:
                    tr.event("fault", "retry", "engine", op=op,
                             attempt=attempt, backoff_s=delay)
                if attempt > self.max_step_retries:
                    raise faults.StepFault(op, attempt, e) from e
                self.sched.advance_clock(delay)
                delay *= 2.0

    def step(self) -> Dict[int, List[int]]:
        """Admit + decode one token for all active slots. Returns finished
        — which under fault injection may include sessions ended by
        deadline expiry or slot quarantine, each with its explicit
        ``finish_reason``."""
        sched = self.sched
        m = sched.metrics
        finished: Dict[int, List[int]] = {}
        inj = self.faults
        if inj is not None:
            inj.begin_step(m.steps)
            delay = inj.delay_s()
            if delay:
                sched.advance_clock(delay)       # latency spike → deadlines
            sched.inject_drafter_fault = inj.drafter_fails()
            if self.paged:
                for ev in inj.storms():
                    sched.seize_blocks(ev.blocks, ev.duration)
        if self.paged:
            sched.release_seized()               # expired storms give back
        sched.expire_deadlines(finished)
        sched.update_degradation()
        t0 = time.monotonic()
        while not sched.shedding:
            plan = sched.plan_admission()
            if plan is None:
                break
            logits = self._launch(
                "prefill", lambda: self.stepper.prefill(
                    plan.tokens, plan.write_targets(), plan.lens))
            m.compute_positions += plan.tokens.size
            nxt, ok = self.stepper.sample_admitted(logits, plan.uids,
                                                   plan.counts)
            sched.commit_admission(plan, nxt, finished, ok=ok)
        m.admit_time_s += time.monotonic() - t0
        if self.paged:
            # Growth / copy-on-write / preemption happen before the step,
            # so the decode sees fully-valid tables.
            copies = sched.prepare_decode()
            self.stepper.apply_copies(copies)
            m.blocks_in_use = sched.pool.blocks_in_use
            m.peak_blocks_in_use = max(m.peak_blocks_in_use, m.blocks_in_use)
        active = sched.active_slot_ids()
        m.steps += 1
        m.slot_steps += self.n_slots
        m.active_slot_steps += len(active)
        m.peak_active_slots = max(m.peak_active_slots, len(active))
        if not active:
            self._trace_step_end(m, 0, len(finished))
            return finished
        t0 = time.monotonic()
        uids, counts = sched.decode_folds(active)
        nxt, ok = self._launch("decode", lambda: self.stepper.decode(
            sched.last_token, sched.pos,
            sched.table_arr if self.paged else None, uids, counts))
        m.compute_positions += self.n_slots
        good = [s for s in active if ok[s]]
        for s in active:
            if not ok[s]:                        # non-finite logits: contain
                sched.quarantine_slot(s, finished)
        if good:
            sched.commit_decode(good, nxt, finished)
        m.decode_time_s += time.monotonic() - t0
        if self.paged:
            # refresh after completions freed their tables (the pre-decode
            # sample above is the high-water mark)
            m.blocks_in_use = sched.pool.blocks_in_use
        self._trace_step_end(m, len(active), len(finished))
        return finished

    def _trace_step_end(self, m, n_active: int, n_finished: int) -> None:
        """Per-step engine 'tick' event — the timeline's heartbeat (fault
        firings are traced at the source, ``FaultInjector._fire``)."""
        tr = self.tracer
        if not tr.enabled:
            return
        tr.event("step", "tick", "engine", step=m.steps, active=n_active,
                 finished=n_finished, queue=self.sched.queue_depth,
                 degradation=self.sched.degradation.level)

    def run_to_completion(self, max_steps: int = 10_000
                          ) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for _ in range(max_steps):
            out.update(self.step())
            if not self.busy:
                break
        return out
