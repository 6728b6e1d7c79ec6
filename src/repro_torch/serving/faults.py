"""Deterministic fault-injection plane for the serving stack (DESIGN.md §14).

Production serving treats partial failure as the common case: a NaN logit,
a transient device-step error, a pool-exhaustion storm, or a stalled step
must degrade one session or one step — never the server. This module makes
those failures *injectable and replayable*: a :class:`FaultPlan` is a
seeded, step-indexed list of :class:`FaultEvent`\\ s, and a
:class:`FaultInjector` threads them into the serving loop through three
narrow hooks:

* ``check_launch(op)`` — raises :class:`TransientStepError` before a
  prefill/decode/verify launch (the facade's bounded-backoff retry loop is
  the consumer). The raise happens *before* any device mutation, so a
  retried launch is bitwise the launch that would have run fault-free.
* ``poison_mask(op, n)`` — rows of the next decode batch / admission group
  whose logits the device layer overwrites with NaN *inside the jit*, so
  detection exercises the real non-finite scan, not a host shortcut.
* ``storms()`` / ``delay_s()`` / ``drafter_fails()`` — step-scoped chaos
  the facade applies to the scheduler: seize pool blocks for a few steps
  (forcing preemption/degradation), advance the virtual clock (latency
  spike → deadline pressure), or make the speculative drafter throw.

Everything here is pure host code (numpy only, no torch): a plan is data,
``FaultPlan.seeded`` draws it from one ``default_rng`` in a fixed order,
and :func:`FaultPlan.fingerprint` is the replay-determinism receipt — the
same (trace seed, plan seed) pair replays the same chaos bit-exactly under
the virtual clock (`benchmarks/chaos.py` gates on it).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: every kind a FaultEvent may carry; FaultPlan validates against this.
FAULT_KINDS = ("nan_logits", "step_error", "pool_storm", "slow_step",
               "drafter_error")


class TransientStepError(RuntimeError):
    """An injected (or real, if a backend wraps its errors) *transient*
    device-step failure: the launch never happened, no state moved, and
    retrying the identical launch is safe and bitwise-equivalent."""


class StepFault(RuntimeError):
    """A step failure that exhausted the retry budget. The scheduler state
    is still consistent (the failed launch mutated nothing), so the caller
    may cancel sessions, snapshot, or restart — but this step did not run."""

    def __init__(self, op: str, attempts: int, last: Exception):
        self.op = op
        self.attempts = attempts
        self.last = last
        super().__init__(
            f"{op} launch failed {attempts} attempts (last: {last})")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled injection. Only the fields its ``kind`` names matter:

    ``nan_logits``     poison row ``slot`` of the ``op`` launch's logits
                       (``op`` = "decode" slot id | "prefill" group row).
    ``step_error``     the first ``attempts`` launches of ``op`` this step
                       raise :class:`TransientStepError` ("any" = all ops).
    ``pool_storm``     seize up to ``blocks`` pool blocks for ``duration``
                       steps (freed automatically at the release step).
    ``slow_step``      the step takes ``delay_s`` extra virtual seconds.
    ``drafter_error``  the speculative drafter raises this step.
    """

    step: int
    kind: str
    slot: int = 0
    op: str = "decode"
    attempts: int = 1
    blocks: int = 0
    duration: int = 1
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"fault kind {self.kind!r} not in {FAULT_KINDS}")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")


class FaultPlan:
    """An immutable, step-sorted chaos schedule with a stable fingerprint."""

    def __init__(self, events: Sequence[FaultEvent]):
        self.events: Tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.step, e.kind, e.slot, e.op)))

    def __len__(self) -> int:
        return len(self.events)

    def events_at(self, step: int) -> List[FaultEvent]:
        return [e for e in self.events if e.step == step]

    @property
    def last_step(self) -> int:
        return self.events[-1].step if self.events else -1

    def fingerprint(self) -> str:
        """sha256 over every field of every event — the replay receipt
        recorded next to the trace fingerprint in chaos reports."""
        h = hashlib.sha256()
        for e in self.events:
            h.update(f"{e.step}|{e.kind}|{e.slot}|{e.op}|{e.attempts}|"
                     f"{e.blocks}|{e.duration}|{e.delay_s!r}\n".encode())
        return h.hexdigest()

    # -- (de)serialization: --fault-plan files and snapshot sidecars --------
    def to_json(self) -> Dict[str, Any]:
        return {"version": 1,
                "events": [dataclasses.asdict(e) for e in self.events]}

    @classmethod
    def from_json(cls, data: Dict[str, Any]) -> "FaultPlan":
        return cls([FaultEvent(**e) for e in data.get("events", [])])

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(json.load(f))

    # -- seeded construction ------------------------------------------------
    @classmethod
    def seeded(cls, seed: int, *, horizon: int, n_slots: int = 4,
               nan: int = 1, transient: int = 1, storms: int = 1,
               slow: int = 1, drafter: int = 0,
               storm_blocks: int = 8, storm_duration: int = 4,
               max_attempts: int = 2, delay_s: float = 3.0) -> "FaultPlan":
        """Draw a chaos schedule over steps ``[horizon/8, horizon)`` from
        ONE ``default_rng(seed)`` in a fixed order (nan, transient, storm,
        slow, drafter) — same seed, same plan, byte for byte."""
        if horizon < 2:
            raise ValueError(f"horizon must be >= 2, got {horizon}")
        rng = np.random.default_rng(seed)
        lo = max(1, horizon // 8)
        hi = max(lo + 1, horizon)
        events: List[FaultEvent] = []
        for _ in range(nan):
            events.append(FaultEvent(
                step=int(rng.integers(lo, hi)), kind="nan_logits",
                slot=int(rng.integers(0, n_slots)),
                op=str(rng.choice(["decode", "prefill"]))))
        for _ in range(transient):
            events.append(FaultEvent(
                step=int(rng.integers(lo, hi)), kind="step_error",
                op=str(rng.choice(["prefill", "decode"])),
                attempts=int(rng.integers(1, max_attempts + 1))))
        for _ in range(storms):
            events.append(FaultEvent(
                step=int(rng.integers(lo, hi)), kind="pool_storm",
                blocks=storm_blocks, duration=storm_duration))
        for _ in range(slow):
            events.append(FaultEvent(
                step=int(rng.integers(lo, hi)), kind="slow_step",
                delay_s=float(delay_s)))
        for _ in range(drafter):
            events.append(FaultEvent(
                step=int(rng.integers(lo, hi)), kind="drafter_error"))
        return cls(events)


class FaultInjector:
    """Stateful executor of one :class:`FaultPlan` against one server run.

    The facade calls :meth:`begin_step` once per engine step; the stepper
    hooks (:meth:`check_launch`, :meth:`poison_mask`) then consult the
    step's active events. ``fired`` accumulates what actually triggered —
    the chaos bench's receipt that the plan executed, not just parsed.
    """

    def __init__(self, plan: FaultPlan, tracer=None):
        self.plan = plan
        self.step = -1
        self._active: List[FaultEvent] = []
        self._attempts: Dict[int, int] = {}      # event index -> raises so far
        self.fired: List[Tuple[int, str]] = []   # (step, kind) log
        self._fired_keys = set()
        # Structured tracing (DESIGN §15): every firing lands on the
        # timeline the moment it happens — the obs pass asserts the trace
        # and ``fired`` never diverge (no silent fault effects). Import is
        # lazy-free: obs.trace is stdlib-only, faults stays host-side.
        if tracer is None:
            from repro_torch.obs.trace import get_tracer
            tracer = get_tracer()
        self.tracer = tracer

    def _fire(self, ev: FaultEvent) -> None:
        key = (self.step, id(ev))
        if key not in self._fired_keys:
            self._fired_keys.add(key)
            self.fired.append((self.step, ev.kind))
            tr = self.tracer
            if tr.enabled:
                tr.event("fault", ev.kind, "engine", step=self.step,
                         op=ev.op, slot=ev.slot)

    def begin_step(self, step: int) -> List[FaultEvent]:
        self.step = step
        self._active = self.plan.events_at(step)
        self._attempts = {}
        return self._active

    # -- facade-side hooks --------------------------------------------------
    def storms(self) -> List[FaultEvent]:
        out = [e for e in self._active if e.kind == "pool_storm"]
        for e in out:
            self._fire(e)
        return out

    def delay_s(self) -> float:
        total = 0.0
        for e in self._active:
            if e.kind == "slow_step":
                total += e.delay_s
                self._fire(e)
        return total

    def drafter_fails(self) -> bool:
        for e in self._active:
            if e.kind == "drafter_error":
                self._fire(e)
                return True
        return False

    # -- stepper-side hooks -------------------------------------------------
    def check_launch(self, op: str) -> None:
        """Raise TransientStepError while a matching step_error event has
        raise budget left; each raise consumes one of its ``attempts``, so
        the facade's retry loop eventually gets a clean launch."""
        for i, ev in enumerate(self._active):
            if ev.kind != "step_error" or ev.op not in ("any", op):
                continue
            if self._attempts.get(i, 0) < ev.attempts:
                self._attempts[i] = self._attempts.get(i, 0) + 1
                self._fire(ev)
                raise TransientStepError(
                    f"injected {op} fault at step {self.step} "
                    f"(raise {self._attempts[i]}/{ev.attempts})")

    def poison_mask(self, op: str, n: int) -> Optional[np.ndarray]:
        """[n] bool mask of rows to poison for this ``op`` launch, or None
        when the step injects nothing (the common case stays zero-cost)."""
        mask = None
        for ev in self._active:
            if ev.kind == "nan_logits" and ev.op == op and 0 <= ev.slot < n:
                if mask is None:
                    mask = np.zeros(n, bool)
                mask[ev.slot] = True
                self._fire(ev)
        return mask

    def report(self) -> Dict[str, Any]:
        counts: Dict[str, int] = {}
        for _, kind in self.fired:
            counts[kind] = counts.get(kind, 0) + 1
        return {"plan_events": len(self.plan), "fired": len(self.fired),
                "by_kind": counts,
                "fingerprint": self.plan.fingerprint()}
