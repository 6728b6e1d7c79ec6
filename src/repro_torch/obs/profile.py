"""Opt-in kernel profiling: predicted-against-measured roofline drift.

The port's counterpart of ``repro.obs.profile``, in the same two halves:

1. **Collection** (cheap): while a profiler is active, ``kernels/ops.py``
   calls :meth:`KernelProfiler.note_dispatch` at each dispatch (and at
   each launch a dry run on meta tensors would make, backend
   ``"meta"``) with the launch's static facts (shape, sparsity, backend, the
   :class:`~repro_torch.kernels.schedule.Schedule` picked, and the H100
   roofline's predicted time, ``schedule.predicted``). One record per
   unique launch, with its dispatch count. The port dispatches on every
   eager call, and once per CUDA-graph capture: a replay runs what the
   capture recorded and is not a dispatch, just as the reference counts
   jit traces, not calls.

2. **Measurement** (explicit, after the run): :meth:`measure` replays each
   unique launch on synthetic Tiled-CSL weights of its shape and
   sparsity (per-expert stacks for the expert-batched kinds), with the
   schedule pinned. On the card it times them with CUDA events, each
   call after an L2 flush (``schedule._cuda_us``), the weights coming
   from DRAM as in the decode loop; on the CPU it times the plain version
   with the host clock, which says nothing of the card. Each row gets
   ``drift = measured / predicted``.

The drift feeds the autotune cache as a staleness signal
(:meth:`apply_staleness`): an entry whose stored ``measured_us`` is off
by more than ``tol`` from a fresh measurement is invalidated, so
``select`` falls back to the analytic pick.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import schedule as schedule_mod

__all__ = ["KernelLaunch", "KernelProfiler", "active", "profiled",
           "render_drift_table", "set_profiler"]

# Zeroed before each timed call: larger than the H100's 50 MB L2.
_FLUSH_WORDS = 2 ** 25


@dataclasses.dataclass(frozen=True)
class KernelLaunch:
    """Static facts of one unique SpMM dispatch. ``experts`` is an
    expert-batched launch's stack size; ``epilogue`` and ``dtype`` (of
    B) are what the first dispatch of the shape ran."""

    kind: str                     # "spmm" | "spmm_grouped" | "spmm_batched"
    m: int
    k: int
    n: int
    sparsity: float
    group: int
    max_nnz: int
    m_tb: int
    k_tb: int
    backend: str                  # "cuda" | "torch"
    schedule: schedule_mod.Schedule
    predicted_s: float            # roofline effective_s for this schedule
    experts: int = 1
    epilogue: str = "none"
    dtype: str = "bfloat16"

    @property
    def cache_key(self) -> str:
        return schedule_mod.cache_key(
            self.m, self.k, self.n, self.sparsity, group=self.group,
            backend=self.backend, m_tb=self.m_tb, k_tb=self.k_tb,
            experts=self.experts)


class KernelProfiler:
    """Collects unique kernel launches, measures them, reports drift."""

    def __init__(self) -> None:
        self.launches: Dict[str, KernelLaunch] = {}   # key -> record
        self.dispatch_counts: Dict[str, int] = {}

    def note_dispatch(self, kind: str, m: int, k: int, n: int,
                      sparsity: float, group: int, max_nnz: int,
                      m_tb: int, k_tb: int, backend: str,
                      sched: schedule_mod.Schedule, *, experts: int = 1,
                      epilogue: str = "none", dtype: str = "bfloat16",
                      binary: bool = False) -> None:
        terms = schedule_mod.predicted(
            m, k, n, sparsity, sched, group=group, max_nnz=max_nnz,
            b_dtype_bytes=getattr(torch, dtype).itemsize, binary=binary,
            experts=experts)
        rec = KernelLaunch(kind, m, k, n, round(float(sparsity), 4), group,
                           max_nnz, m_tb, k_tb, backend, sched,
                           terms.effective_s, experts, epilogue, dtype)
        key = f"{kind}:{rec.cache_key}_ntb{sched.n_tb}_sk{sched.split_k}"
        self.launches.setdefault(key, rec)
        self.dispatch_counts[key] = self.dispatch_counts.get(key, 0) + 1

    # -- measurement --------------------------------------------------------
    def measure(self, reps: int = 2, seed: int = 0) -> List[Dict[str, Any]]:
        """Time each unique launch on its own; returns drift-table rows.

        Runs after the profiled work, with this profiler inactive, so its
        own launches are not recorded. A ``"cuda"`` launch runs on the
        card, one untimed call and then ``reps`` calls between CUDA
        events, each after an L2 flush; a ``"torch"`` launch runs the
        plain version on the CPU under the host clock."""
        if not self.launches:
            return []
        from repro_torch.core import tiled_csl
        from repro_torch.kernels import ops   # ops imports this module

        prev = set_profiler(None)
        try:
            rows: List[Dict[str, Any]] = []
            flush = None
            weights: Dict[tuple, Any] = {}    # one per shape, all its N
            for key in sorted(self.launches):
                rec = self.launches[key]
                if rec.backend == "meta":      # a dry run's: nothing ran
                    continue
                on_card = rec.backend == "cuda"
                dev = torch.device("cuda" if on_card else "cpu")
                if on_card and flush is None:
                    flush = torch.empty(_FLUSH_WORDS, dtype=torch.int32,
                                        device=dev)
                rng = np.random.default_rng(seed)
                wkey = (rec.kind, rec.m, rec.k, rec.group, rec.experts,
                        rec.sparsity, rec.m_tb, rec.k_tb, rec.backend)
                if wkey not in weights:
                    weights[wkey] = _synthetic(tiled_csl, rec, rng, dev)
                t = weights[wkey]
                if rec.kind == "spmm_batched":
                    b_shape = (rec.experts, rec.k, rec.n)
                    run = ops.spmm_batched
                else:
                    b_shape = (rec.k, rec.n)
                    run = (ops.spmm_grouped if rec.kind == "spmm_grouped"
                           else ops.spmm)
                b = torch.from_numpy(rng.standard_normal(b_shape).astype(
                    np.float32)).to(dev, getattr(torch, rec.dtype))
                kw = ({} if rec.kind == "spmm_batched"
                      else dict(epilogue=rec.epilogue))

                def fn(t=t, b=b, run=run, rec=rec, kw=kw):
                    return run(t, b, backend=rec.backend,
                               n_tb=rec.schedule.n_tb,
                               split_k=rec.schedule.split_k, **kw)
                if on_card:
                    measured_us = schedule_mod._cuda_us(fn, reps, flush)
                else:
                    fn()                                 # warm
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        fn()
                    measured_us = (time.perf_counter() - t0) / reps * 1e6
                predicted_us = rec.predicted_s * 1e6
                rows.append({
                    "key": key, "kind": rec.kind,
                    "m": rec.m, "k": rec.k, "n": rec.n,
                    "sparsity": rec.sparsity, "group": rec.group,
                    "experts": rec.experts, "epilogue": rec.epilogue,
                    "dtype": rec.dtype, "backend": rec.backend,
                    "schedule": rec.schedule.as_dict(),
                    "dispatches": self.dispatch_counts.get(key, 0),
                    "timing": "cuda_events" if on_card else "host_clock",
                    "predicted_us": predicted_us,
                    "measured_us": measured_us,
                    "drift": (measured_us / predicted_us
                              if predicted_us > 0 else None),
                })
            return rows
        finally:
            set_profiler(prev)

    # -- staleness feedback -------------------------------------------------
    def apply_staleness(self, cache: schedule_mod.ScheduleCache,
                        rows: List[Dict[str, Any]],
                        tol: float = 0.5) -> List[str]:
        """Invalidate autotune-cache entries whose stored timing drifted.

        For each measured row whose shape has a cache entry carrying
        ``measured_us``, compare stored against fresh: a relative gap
        beyond ``tol`` means the entry was tuned on a world that no longer
        exists (another machine, another kernel revision), so it is
        dropped and ``select()`` stops trusting it. Returns the
        invalidated cache keys.
        """
        dropped: List[str] = []
        by_cache_key = {}
        for row in rows:
            launch = self.launches.get(row["key"])
            if launch is not None:
                by_cache_key.setdefault(launch.cache_key, row)
        for ckey, row in sorted(by_cache_key.items()):
            ent = cache.entry(ckey)
            if not ent or "measured_us" not in ent:
                continue
            stored = float(ent["measured_us"])
            fresh = float(row["measured_us"])
            if stored <= 0:
                continue
            gap = abs(fresh - stored) / stored
            if gap > tol:
                cache.invalidate(ckey)
                row["stale_cache_entry"] = {
                    "key": ckey, "stored_us": stored, "rel_gap": gap}
                dropped.append(ckey)
        return dropped

    def drift_report(self, reps: int = 2,
                     cache: Optional[schedule_mod.ScheduleCache] = None,
                     tol: float = 0.5) -> Dict[str, Any]:
        """measure() + optional staleness pass, as one JSON-able report."""
        rows = self.measure(reps=reps)
        stale = (self.apply_staleness(cache, rows, tol=tol)
                 if cache is not None else [])
        return {"rows": rows, "stale_keys": stale,
                "n_unique_launches": len(rows)}


def _synthetic(tiled_csl, rec: KernelLaunch, rng, dev):
    """Tiled-CSL weights of ``rec``'s shape at its sparsity: a plain
    matrix, a group of ``group`` or a stack of ``experts``."""
    n_mats = rec.experts if rec.kind == "spmm_batched" else rec.group
    dense = rng.standard_normal((n_mats, rec.m, rec.k)).astype(np.float32)
    dense[rng.random(dense.shape) < rec.sparsity] = 0.0
    dense_t = torch.from_numpy(dense).to(dev)
    if rec.kind == "spmm_batched":
        return tiled_csl.encode_stack(dense_t, rec.m_tb, rec.k_tb)
    if rec.kind == "spmm_grouped":
        return tiled_csl.encode_group(list(dense_t), rec.m_tb, rec.k_tb)
    return tiled_csl.encode(dense_t[0], rec.m_tb, rec.k_tb)


def render_drift_table(rows: List[Dict[str, Any]]) -> str:
    """Fixed-width drift table for CLI output."""
    if not rows:
        return "(no schedulable kernel launches recorded)"
    hdr = (f"{'kind':<14}{'m':>6}{'k':>6}{'n':>6}  {'schedule':<18}"
           f"{'pred_us':>10} {'meas_us':>10} {'drift':>10}  stale")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        s = r["schedule"]
        sched = f"ntb{s['n_tb']}/sk{s['split_k']}"
        drift = f"{r['drift']:.2f}x" if r["drift"] is not None else "n/a"
        stale = "YES" if r.get("stale_cache_entry") else ""
        lines.append(f"{r['kind']:<14}{r['m']:>6}{r['k']:>6}{r['n']:>6}  "
                     f"{sched:<18}{r['predicted_us']:>10.1f} "
                     f"{r['measured_us']:>10.1f} {drift:>10}  {stale}")
    return "\n".join(lines)


# Process-wide active profiler (None: collection off; the dispatch site
# in ops.py pays one module-attribute check).
_PROFILER: Optional[KernelProfiler] = None


def active() -> Optional[KernelProfiler]:
    return _PROFILER


def set_profiler(prof: Optional[KernelProfiler]) -> Optional[KernelProfiler]:
    global _PROFILER
    prev, _PROFILER = _PROFILER, prof
    return prev


class profiled:
    """Context manager: activate ``prof`` for the dynamic extent."""

    def __init__(self, prof: KernelProfiler) -> None:
        self.prof = prof
        self._prev: Optional[KernelProfiler] = None

    def __enter__(self) -> KernelProfiler:
        self._prev = set_profiler(self.prof)
        return self.prof

    def __exit__(self, *exc) -> None:
        set_profiler(self._prev)
