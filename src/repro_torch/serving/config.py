"""Typed serving configuration surface (DESIGN.md §16).

Three frozen dataclasses replace the sprawl of keyword arguments that had
accreted on :class:`~repro_torch.serving.batching.ContinuousBatcher` and
:class:`~repro_torch.serving.api.StreamingServer`:

* :class:`SLOSpec` — a *per-request* service-level objective: soft latency
  targets (TTFT/TPOT, drive scheduling priority and attainment accounting)
  plus hard deadlines (kill the request when blown — the earlier
  ``ttft_deadline_s``/``deadline_s`` flags are now a thin mapping onto this
  one object rather than a parallel mechanism).
* :class:`SchedulerConfig` — host-side admission/scheduling policy: slot
  geometry, bucketed-vs-chunked prefill, chunk sizing, SLO budgeting.
* :class:`ServeConfig` — the full engine surface: scheduler policy plus
  cache kind, sampling, speculation, retry policy and queue bounds.
  ``from_flags()`` builds one from an ``argparse`` namespace (used by
  ``launch/serve.py`` and ``examples/``); ``from_kwargs()`` maps the legacy
  flat keyword set onto the config (the facade's deprecation shim).

Everything here is plain data — validation raises ``ValueError`` before any
device or scheduler state exists.  Live objects (drafter, clock, fault
plan, degradation policy, tracer) stay constructor arguments on the facade:
they are behavior, not configuration, and don't serialize.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

__all__ = [
    "SLOSpec", "SLOAttainment", "SchedulerConfig", "ServeConfig",
]


# ---------------------------------------------------------------------------
# Per-request SLOs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Service-level objective attached to one request.

    Targets are *soft*: the scheduler uses them for earliest-deadline-first
    chunk ordering and the TPOT throttle, and attainment (met/missed) is
    reported per class — a missed target never kills a request.  Deadlines
    are *hard*: a request whose deadline expires is failed and its slot
    reclaimed (scheduler ``expire_deadlines``), exactly the earlier deadline semantics.

    ``priority`` sorts before deadlines (higher = more urgent); ``tenant``
    names the fairness/attainment class (empty string = default class).
    """

    ttft_target_ms: Optional[float] = None
    tpot_target_ms: Optional[float] = None
    priority: int = 0
    tenant: str = ""
    ttft_deadline_ms: Optional[float] = None
    deadline_ms: Optional[float] = None

    def validate(self) -> "SLOSpec":
        for name in ("ttft_target_ms", "tpot_target_ms",
                     "ttft_deadline_ms", "deadline_ms"):
            v = getattr(self, name)
            if v is not None and (not isinstance(v, (int, float))
                                  or v <= 0.0):
                raise ValueError(f"SLOSpec.{name} must be > 0, got {v!r}")
        if not isinstance(self.priority, int):
            raise ValueError(f"SLOSpec.priority must be int, "
                             f"got {self.priority!r}")
        if (self.ttft_target_ms is not None
                and self.ttft_deadline_ms is not None
                and self.ttft_target_ms > self.ttft_deadline_ms):
            raise ValueError("ttft_target_ms exceeds ttft_deadline_ms "
                             "(target must be at or inside the hard "
                             "deadline)")
        return self

    # -- seconds views (scheduler-internal unit) --
    @property
    def ttft_target_s(self) -> Optional[float]:
        return None if self.ttft_target_ms is None \
            else self.ttft_target_ms / 1e3

    @property
    def tpot_target_s(self) -> Optional[float]:
        return None if self.tpot_target_ms is None \
            else self.tpot_target_ms / 1e3

    @property
    def ttft_deadline_s(self) -> Optional[float]:
        return None if self.ttft_deadline_ms is None \
            else self.ttft_deadline_ms / 1e3

    @property
    def deadline_s(self) -> Optional[float]:
        return None if self.deadline_ms is None else self.deadline_ms / 1e3

    def attainment(self, ttft_s: Optional[float], tpot_s: Optional[float]
                   ) -> Optional["SLOAttainment"]:
        """Score measured latencies against the targets (None = no
        targets to score)."""
        if self.ttft_target_ms is None and self.tpot_target_ms is None:
            return None
        ttft_met = tpot_met = None
        if self.ttft_target_ms is not None and ttft_s is not None:
            ttft_met = bool(ttft_s <= self.ttft_target_s)
        if self.tpot_target_ms is not None and tpot_s is not None:
            tpot_met = bool(tpot_s <= self.tpot_target_s)
        return SLOAttainment(ttft_s=ttft_s, ttft_target_s=self.ttft_target_s,
                             ttft_met=ttft_met, tpot_s=tpot_s,
                             tpot_target_s=self.tpot_target_s,
                             tpot_met=tpot_met)

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SLOSpec":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class SLOAttainment:
    """Measured latency vs. target for one finished request.

    ``None`` in a ``*_met`` slot means that dimension had no target or no
    measurement (e.g. a single-token response has no TPOT).
    """

    ttft_s: Optional[float] = None
    ttft_target_s: Optional[float] = None
    ttft_met: Optional[bool] = None
    tpot_s: Optional[float] = None
    tpot_target_s: Optional[float] = None
    tpot_met: Optional[bool] = None

    @property
    def met(self) -> bool:
        """True iff every dimension that was scored hit its target."""
        return (self.ttft_met is not False) and (self.tpot_met is not False)


# ---------------------------------------------------------------------------
# Scheduler policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Host-side admission/scheduling policy (pure numpy scheduler knobs).

    ``chunked_prefill`` switches admission from bucketed whole-prompt
    prefill (DESIGN.md §7) to the §16 mixed-step path: prompts stream into
    their slots ``chunk_size`` positions at a time, interleaved with decode
    in one jitted launch, with at most ``chunk_budget`` prefill positions
    granted per step across all slots.
    """

    n_slots: int = 4
    max_len: int = 64
    eos_id: Optional[int] = None
    stop_ids: Tuple[int, ...] = ()
    admit_k: Optional[int] = None
    min_bucket: int = 8
    request_history: int = 1024
    reserve_blocks: int = 1
    chunked_prefill: bool = False
    chunk_size: int = 16
    chunk_budget: int = 32

    def validate(self) -> "SchedulerConfig":
        if self.n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {self.n_slots}")
        if self.max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {self.max_len}")
        if self.admit_k is not None and self.admit_k < 1:
            raise ValueError(f"admit_k must be >= 1, got {self.admit_k}")
        if self.min_bucket < 1:
            raise ValueError(f"min_bucket must be >= 1, "
                             f"got {self.min_bucket}")
        if self.reserve_blocks < 0:
            raise ValueError("reserve_blocks must be >= 0")
        if self.chunked_prefill:
            if self.chunk_size < 1:
                raise ValueError(f"chunk_size must be >= 1, "
                                 f"got {self.chunk_size}")
            if self.chunk_budget < self.chunk_size:
                raise ValueError(
                    f"chunk_budget ({self.chunk_budget}) must be >= "
                    f"chunk_size ({self.chunk_size}) — a step must be able "
                    f"to grant at least one full chunk")
        return self


# ---------------------------------------------------------------------------
# Full engine surface
# ---------------------------------------------------------------------------

# Legacy flat kwargs -> (dataclass, field) for the deprecation shim.
_SCHED_KEYS = ("n_slots", "max_len", "eos_id", "stop_ids", "admit_k",
               "min_bucket", "request_history", "reserve_blocks",
               "chunked_prefill", "chunk_size", "chunk_budget")
_SERVE_KEYS = ("cache_kind", "block_size", "n_blocks", "prefix_sharing",
               "backend", "temperature", "top_k", "seed", "spec_k",
               "max_queue", "max_step_retries", "retry_backoff_s")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Everything the serving engine needs that is plain data.

    Live collaborators (drafter, clock, fault plan, degradation policy,
    tracer) remain explicit constructor arguments on the facade.
    """

    scheduler: SchedulerConfig = dataclasses.field(
        default_factory=SchedulerConfig)
    cache_kind: str = "dense"
    block_size: int = 16
    n_blocks: Optional[int] = None
    prefix_sharing: bool = True
    backend: str = "auto"
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    spec_k: int = 0
    max_queue: Optional[int] = None
    max_step_retries: int = 4
    retry_backoff_s: float = 0.25

    def validate(self) -> "ServeConfig":
        self.scheduler.validate()
        if self.cache_kind not in ("dense", "paged"):
            raise ValueError(f"cache_kind must be 'dense' or 'paged', "
                             f"got {self.cache_kind!r}")
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, "
                             f"got {self.block_size}")
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        if self.spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        if self.max_queue is not None and self.max_queue < 0:
            raise ValueError("max_queue must be >= 0")
        if self.max_step_retries < 0:
            raise ValueError("max_step_retries must be >= 0")
        if self.retry_backoff_s < 0.0:
            raise ValueError("retry_backoff_s must be >= 0")
        sc = self.scheduler
        if sc.chunked_prefill:
            if self.cache_kind != "paged":
                raise ValueError("chunked_prefill requires "
                                 "cache_kind='paged' (chunks commit "
                                 "through the paged verify-window scatter)")
            if self.spec_k > 0:
                raise ValueError("chunked_prefill and speculative decoding "
                                 "(spec_k > 0) are mutually exclusive — "
                                 "both own the per-step verify window")
        return self

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_kwargs(cls, **kw: Any) -> "ServeConfig":
        """Map the legacy flat keyword set onto a config (deprecation
        shim target — unknown keys raise ``TypeError`` like a normal
        signature would)."""
        sched = {k: kw.pop(k) for k in _SCHED_KEYS if k in kw}
        serve = {k: kw.pop(k) for k in _SERVE_KEYS if k in kw}
        if kw:
            raise TypeError(f"unknown serving kwargs: {sorted(kw)}")
        return cls(scheduler=SchedulerConfig(**sched), **serve).validate()

    @classmethod
    def from_flags(cls, args: Any) -> "ServeConfig":
        """Build from an ``argparse`` namespace (``launch/serve.py``
        flag names; missing attributes fall back to defaults)."""
        def g(name: str, default: Any) -> Any:
            return getattr(args, name, default)

        sched = SchedulerConfig(
            n_slots=g("slots", 4),
            max_len=g("max_len", 64),
            admit_k=g("admit_k", None),
            min_bucket=g("min_bucket", 8),
            chunked_prefill=bool(g("chunked", False)),
            chunk_size=g("chunk_size", 16),
            chunk_budget=g("chunk_budget", 32),
        )
        return cls(
            scheduler=sched,
            cache_kind="paged" if g("paged", False) else "dense",
            block_size=g("block_size", 16),
            n_blocks=g("n_blocks", None),
            backend=g("backend", "auto"),
            temperature=g("temperature", 0.0),
            top_k=g("top_k", 0),
            seed=g("seed", 0),
            spec_k=g("spec_k", 0),
            max_queue=g("max_queue", None),
        ).validate()
