"""Shape-aware schedule selection for the port's LSCD SpMM kernels.

The counterpart of the analytic ``repro.kernels.schedule.select``. The
decode hot path is a skinny product (N = tokens in flight): with one N
tile the only launch parallelism is Mt, too few blocks for 132 SMs, so
the N tile and the split-K factor are chosen per (M, K, N, sparsity) —
``sparse_linear`` hands the activation's N through ``ops`` on every call,
so the same weights get a split-K launch at decode and a single-pass one
at prefill. Candidates are scored with ``core.roofline.lscd_splitk_terms``
(H100 constants) after the launch contract (``analysis.contracts``) has
dropped those the kernels do not take; the N ladder keeps every tile the
kernels are built for. The words moved come from the encoding's own
``max_nnz``; the occupancy term is the launch's own resident blocks per
SM (``contracts.launch_resident``: four decode-body blocks at 0.8
sparsity), so a decode launch splits K until its blocks fill two rounds
of every SM's resident slots. On an H100 that picks S within 5% of the
fastest of S in {1, 2, 4, 8, 16} at the four OPT-30B decode shapes
(PERF.md, PR 13).

The measured mode is the reference's: :func:`autotune` times the port's
own kernels over the N tile x split grid with CUDA events and persists
the winner to a :class:`ScheduleCache` (a JSON file; the
``REPRO_SCHEDULE_CACHE`` environment variable names a default one) under
a shape + backend key. :func:`select` consults that cache first; a hit
counts only if it agrees with every pin and the launch contract takes
it, otherwise the analytic pick decides.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.analysis import contracts
from repro_torch.core import roofline
from repro_torch.kernels import ref, spmm

N_TB_LADDER = contracts.N_TB_OPTIONS
SPLIT_LADDER = (1, 2, 4, 8, 16)

_ENV_CACHE_VAR = "REPRO_SCHEDULE_CACHE"


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One launch: ``split_k == 1`` is the single-pass kernel."""

    m_tb: int
    k_tb: int
    n_tb: int
    split_k: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Schedule":
        return cls(m_tb=int(d["m_tb"]), k_tb=int(d["k_tb"]),
                   n_tb=int(d["n_tb"]), split_k=int(d["split_k"]))


def sparsity_from_max_nnz(max_nnz: int, m_tb: int, k_tb: int) -> float:
    """The sparsity a cache key names: ``max_nnz`` over the tile size
    bounds a tile's density, padding included. ``select`` and
    ``autotune`` both key the cache through this value, so a tuned entry
    is found again bit for bit."""
    return 1.0 - min(1.0, max_nnz / float(m_tb * k_tb))


def cache_key(m: int, k: int, n: int, sparsity: float, *, group: int = 1,
              backend: str = "cuda", m_tb: Optional[int] = None,
              k_tb: Optional[int] = None, experts: int = 1) -> str:
    """Stable JSON-cache key: shape + backend (+ pinned tile geometry),
    in the reference's format; an expert-batched launch adds its expert
    count."""
    tile = f"_mtb{m_tb}_ktb{k_tb}" if m_tb and k_tb else ""
    stack = f"_e{experts}" if experts > 1 else ""
    return (f"{backend}_m{m}_k{k}_n{n}_s{round(float(sparsity), 4)}"
            f"_g{group}{tile}{stack}")


def _read_entries(path: str) -> Dict[str, dict]:
    """Tolerant cache-file read: a missing, corrupt or schema-drifted file
    yields {} instead of raising. Shared by ``ScheduleCache.__init__`` and
    the merge step of ``save`` so their semantics cannot diverge."""
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            return {str(k): dict(v) for k, v in json.load(f).items()}
    except (json.JSONDecodeError, OSError, TypeError, ValueError,
            AttributeError):
        return {}


class ScheduleCache:
    """JSON-file persistence for measured autotune winners.

    Format: ``{key: {m_tb, k_tb, n_tb, split_k, measured_us?}}``. A
    missing or corrupt file starts empty; ``save`` merges with what is on
    disk (ours win on a key collision, invalidated keys stay dropped) and
    writes atomically (tmp + rename), so a crashed autotune run never
    truncates an existing cache.
    """

    def __init__(self, path: str):
        self.path = path
        self._data: Dict[str, dict] = _read_entries(path)
        self._dropped: set = set()     # invalidated keys

    def __len__(self) -> int:
        return len(self._data)

    def entry(self, key: str) -> Optional[dict]:
        """Raw cache record (incl. ``measured_us``), or None."""
        ent = self._data.get(key)
        return dict(ent) if ent else None

    def invalidate(self, key: str) -> bool:
        """Drop a stale entry. The drop survives ``save()``'s merge, so
        the next ``select()`` falls back to the analytic pick."""
        self._dropped.add(key)
        return self._data.pop(key, None) is not None

    def get(self, key: str) -> Optional[Schedule]:
        ent = self._data.get(key)
        if not ent:
            return None
        try:
            return Schedule.from_dict(ent)
        except (KeyError, TypeError, ValueError):
            return None   # schema-drifted entry: fall back to analytic

    def put(self, key: str, sched: Schedule,
            measured_us: Optional[float] = None) -> None:
        ent = sched.as_dict()
        if measured_us is not None:
            ent["measured_us"] = float(measured_us)
        self._dropped.discard(key)     # a fresh measurement un-drops it
        self._data[key] = ent

    def save(self) -> None:
        merged = _read_entries(self.path)
        merged.update(self._data)
        for key in self._dropped:      # invalidations beat the disk copy
            merged.pop(key, None)
        self._data = merged
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(merged, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)


_env_cache: Optional[ScheduleCache] = None


def _default_cache() -> Optional[ScheduleCache]:
    """The cache ``REPRO_SCHEDULE_CACHE`` names, or None when it is unset."""
    global _env_cache
    path = os.environ.get(_ENV_CACHE_VAR)
    if not path:
        return None
    if _env_cache is None or _env_cache.path != path:
        _env_cache = ScheduleCache(path)
    return _env_cache


def candidates(m: int, k: int, n: int, *, m_tb: int, k_tb: int,
               n_tb: Optional[int] = None,
               split_k: Optional[int] = None) -> Tuple[Schedule, ...]:
    kt = -(-k // k_tb)
    n_opts = (n_tb,) if n_tb else N_TB_LADDER
    s_opts = (split_k,) if split_k else tuple(s for s in SPLIT_LADDER
                                             if s <= kt)
    return tuple(Schedule(m_tb, k_tb, ntb, s) for ntb in n_opts
                 for s in s_opts)


def select(m: int, k: int, n: int, *, m_tb: int, k_tb: int, max_nnz: int,
           n_tb: Optional[int] = None, split_k: Optional[int] = None,
           group: int = 1, b_dtype_bytes: int = 2, binary: bool = False,
           backend: str = "cuda",
           cache: "Optional[ScheduleCache] | bool" = None,
           experts: int = 1) -> Schedule:
    """Pick the launch for one SpMM shape.

    A launch with both ``n_tb`` and ``split_k`` pinned is checked and
    kept. Otherwise a measured entry wins (``cache``, or the
    ``REPRO_SCHEDULE_CACHE`` file when ``cache`` is None or True; False
    ignores both) if it agrees with every pin and the launch contract
    takes it; else the analytic pick (:func:`select_analytic`) decides.
    ``backend`` names the kernels the entry was measured on; ``experts``
    is the stack count of an expert-batched launch (one schedule for all
    E experts, where the reference's vmap picks one per expert: here
    the experts share the grid)."""
    if n_tb is None or split_k is None:
        if cache is False:
            cache = None
        elif cache is None or cache is True:   # an empty cache is falsy too
            cache = _default_cache()
        if cache is not None:
            hit = cache.get(cache_key(
                m, k, n, sparsity_from_max_nnz(max_nnz, m_tb, k_tb),
                group=group, backend=backend, m_tb=m_tb, k_tb=k_tb,
                experts=experts))
            if hit is not None and (hit.m_tb, hit.k_tb) == (m_tb, k_tb) \
                    and (n_tb is None or hit.n_tb == n_tb) \
                    and (split_k is None or hit.split_k == split_k) \
                    and not contracts.check_launch(
                        m, k, n, m_tb=hit.m_tb, k_tb=hit.k_tb,
                        n_tb=hit.n_tb, split_k=hit.split_k, group=group,
                        binary=binary, b_dtype_bytes=b_dtype_bytes,
                        max_nnz=max_nnz, experts=experts):
                return hit
    return select_analytic(m, k, n, m_tb=m_tb, k_tb=k_tb, max_nnz=max_nnz,
                           n_tb=n_tb, split_k=split_k, group=group,
                           b_dtype_bytes=b_dtype_bytes, binary=binary,
                           experts=experts)


def _terms(m: int, k: int, n: int, sched: Schedule, *, max_nnz: int,
           group: int, b_dtype_bytes: int, binary: bool,
           experts: int) -> roofline.SplitKTerms:
    shape = dict(m_tb=sched.m_tb, k_tb=sched.k_tb, n_tb=sched.n_tb,
                 split_k=sched.split_k, group=group,
                 b_dtype_bytes=b_dtype_bytes)
    return roofline.lscd_splitk_terms(
        m, k, n, max_nnz=max_nnz, **shape,
        block_groups=contracts.block_groups(group, sched.n_tb,
                                            b_dtype_bytes, binary),
        resident=contracts.launch_resident(k, **shape, binary=binary,
                                           max_nnz=max_nnz),
        experts=experts)


def predicted(m: int, k: int, n: int, sparsity: float, sched: Schedule, *,
              group: int = 1, max_nnz: Optional[int] = None,
              b_dtype_bytes: int = 2, binary: bool = False,
              experts: int = 1) -> roofline.SplitKTerms:
    """The cost-model terms of one concrete schedule on the H100 roofline
    (``core.roofline``): the card's predicted time (``effective_s``), not
    the TPU's. They are the terms :func:`select_analytic` ranks its
    candidates by. ``max_nnz`` is the encoding's own; without it each
    tile is charged ``(1 - sparsity)`` of its positions."""
    if max_nnz is None:
        max_nnz = max(1, int(round(sched.m_tb * sched.k_tb
                                   * (1.0 - sparsity))))
    return _terms(m, k, n, sched, max_nnz=max_nnz, group=group,
                  b_dtype_bytes=b_dtype_bytes, binary=binary,
                  experts=experts)


@functools.lru_cache(maxsize=4096)
def select_analytic(m: int, k: int, n: int, *, m_tb: int, k_tb: int,
                    max_nnz: int, n_tb: Optional[int] = None,
                    split_k: Optional[int] = None, group: int = 1,
                    b_dtype_bytes: int = 2, binary: bool = False,
                    experts: int = 1) -> Schedule:
    """The analytic pick: least ``effective_s``, ties to fewer bytes, then
    smaller split, then larger N tile. Pinned fields are kept; a pinned
    launch the kernels do not take raises. ``binary``: a silu_mul/gelu_mul
    epilogue, which keeps the G=2 pair in one block; ``experts``: an
    expert-batched launch, whose E stacks fill the grid before any split
    (``roofline.lscd_splitk_terms``). Memoised, so a repeated dispatch is
    a dict hit."""
    best, best_key, rejected = None, None, []
    for cand in candidates(m, k, n, m_tb=m_tb, k_tb=k_tb, n_tb=n_tb,
                           split_k=split_k):
        bad = contracts.check_launch(m, k, n, m_tb=cand.m_tb, k_tb=cand.k_tb,
                                     n_tb=cand.n_tb, split_k=cand.split_k,
                                     group=group, binary=binary,
                                     b_dtype_bytes=b_dtype_bytes,
                                     experts=experts)
        if bad:
            rejected.extend(bad)
            continue
        t = _terms(m, k, n, cand, max_nnz=max_nnz, group=group,
                   b_dtype_bytes=b_dtype_bytes, binary=binary,
                   experts=experts)
        key = (t.effective_s, t.hbm_bytes, cand.split_k, -cand.n_tb)
        if best_key is None or key < best_key:
            best, best_key = cand, key
    if best is None:
        raise contracts.ScheduleContractError(
            f"no launchable schedule for ({m},{k},{n}) group={group} "
            f"experts={experts}: "
            + "; ".join(sorted(set(rejected))))
    return best


def _plain_launch(t, b, sched: Schedule, epilogue: str):
    """The plain version of one schedule: the split-K reference sums the
    same K slices the split-K kernels do."""
    grouped = t.group is not None
    if sched.split_k > 1:
        fn = ref.spmm_splitk_grouped_ref if grouped else ref.spmm_splitk_ref
        return fn(t, b, sched.split_k, out_dtype=b.dtype, epilogue=epilogue)
    fn = ref.spmm_grouped_ref if grouped else ref.spmm_ref
    return fn(t, b, out_dtype=b.dtype, epilogue=epilogue)


def autotune(t, n: int, *, backend: str = "cuda",
             cache: Optional[ScheduleCache] = None, reps: int = 10,
             epilogue: str = "none",
             splits: Optional[Sequence[int]] = None,
             n_tbs: Optional[Sequence[int]] = None, flush=None
             ) -> Tuple[Schedule, Dict[Schedule, float]]:
    """Measured schedule selection: time each (N tile, split) candidate
    and keep the fastest.

    ``t`` is an encoded (possibly grouped) TiledCSL, whose tile geometry
    is fixed. B is a bf16 ``[K, n]`` (the serving dtype) on ``t``'s
    device. ``backend="cuda"`` runs the port's kernels
    through ``ops`` with the candidate pinned and times each call with
    CUDA events (``reps`` calls after one untimed one; ``flush``, a device
    tensor, is zeroed before each so the weights come from DRAM as in the
    decode loop); ``"torch"`` times the candidate's plain version on the
    host clock, which ranks the plumbing, not the card. A candidate the
    launch contract refuses is never timed or stored, and a launch that
    fails raises. The winner is saved to ``cache`` (or the
    ``REPRO_SCHEDULE_CACHE`` file) under the shape + backend key, where
    :func:`select` finds it. Returns (winner, {schedule: µs})."""
    from repro_torch.kernels import ops   # ops imports this module
    if backend not in ("cuda", "torch"):
        raise ValueError(f"autotune backend {backend!r} not in "
                         "('cuda', 'torch')")
    m, k = t.shape
    group = t.group or 1
    binary = spmm.epilogue_kind(epilogue, groups=t.group) == "binary"
    sparsity = sparsity_from_max_nnz(t.max_nnz, t.m_tb, t.k_tb)
    dev = t.words.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    b = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
    run = ops.spmm_grouped if t.group is not None else ops.spmm

    kt = t.grid[1]
    split_opts = tuple(splits) if splits else tuple(
        s for s in SPLIT_LADDER if s <= kt)
    n_opts = tuple(n_tbs) if n_tbs else N_TB_LADDER
    timings: Dict[Schedule, float] = {}
    refused = []
    for ntb in n_opts:
        for s in split_opts:
            sched = Schedule(t.m_tb, t.k_tb, ntb, s)
            bad = contracts.check_launch(
                m, k, n, m_tb=t.m_tb, k_tb=t.k_tb, n_tb=ntb, split_k=s,
                group=group, binary=binary, max_nnz=t.max_nnz)
            if bad:
                refused.extend(bad)
                continue
            if backend == "cuda":
                def fn(sched=sched):
                    return run(t, b, backend="cuda", n_tb=sched.n_tb,
                               split_k=sched.split_k, epilogue=epilogue)
                timings[sched] = _cuda_us(fn, reps, flush)
            else:
                def fn(sched=sched):
                    return _plain_launch(t, b, sched, epilogue)
                fn()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                timings[sched] = (time.perf_counter() - t0) / reps * 1e6
    if not timings:
        raise contracts.ScheduleContractError(
            f"autotune({m},{k},{n}) group={group}: no launchable candidate: "
            + "; ".join(sorted(set(refused))))
    best = min(timings, key=timings.get)
    contracts.require_launch(
        m, k, n, m_tb=best.m_tb, k_tb=best.k_tb, n_tb=best.n_tb,
        split_k=best.split_k, group=group, binary=binary,
        max_nnz=t.max_nnz)
    if cache is None:           # not `or`: an empty cache is falsy
        cache = _default_cache()
    if cache is not None:
        cache.put(cache_key(m, k, n, sparsity, group=group, backend=backend,
                            m_tb=t.m_tb, k_tb=t.k_tb),
                  best, measured_us=timings[best])
        cache.save()
    return best, timings


def _cuda_us(fn, reps: int, flush) -> float:
    """Mean device time of one call of ``fn`` in µs: one untimed call,
    then ``reps`` calls each between two CUDA events (``flush`` zeroed
    before each, when given)."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(e) for a, e in pairs) / reps * 1e3
