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
The JAX package's measured autotune cache is not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

from repro_torch.analysis import contracts
from repro_torch.core import roofline

N_TB_LADDER = contracts.N_TB_OPTIONS
SPLIT_LADDER = (1, 2, 4, 8, 16)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One launch: ``split_k == 1`` is the single-pass kernel."""

    m_tb: int
    k_tb: int
    n_tb: int
    split_k: int


def candidates(m: int, k: int, n: int, *, m_tb: int, k_tb: int,
               n_tb: Optional[int] = None,
               split_k: Optional[int] = None) -> Tuple[Schedule, ...]:
    kt = -(-k // k_tb)
    n_opts = (n_tb,) if n_tb else N_TB_LADDER
    s_opts = (split_k,) if split_k else tuple(s for s in SPLIT_LADDER
                                             if s <= kt)
    return tuple(Schedule(m_tb, k_tb, ntb, s) for ntb in n_opts
                 for s in s_opts)


@functools.lru_cache(maxsize=4096)
def select(m: int, k: int, n: int, *, m_tb: int, k_tb: int, max_nnz: int,
           n_tb: Optional[int] = None, split_k: Optional[int] = None,
           group: int = 1, b_dtype_bytes: int = 2,
           binary: bool = False) -> Schedule:
    """Pick the launch for one SpMM shape: least ``effective_s``, ties to
    fewer bytes, then smaller split, then larger N tile. Pinned fields are
    kept; a pinned launch the kernels do not take raises. ``binary``: a
    silu_mul/gelu_mul epilogue, which keeps the G=2 pair in one block."""
    best, best_key, rejected = None, None, []
    for cand in candidates(m, k, n, m_tb=m_tb, k_tb=k_tb, n_tb=n_tb,
                           split_k=split_k):
        bad = contracts.check_launch(m, k, n, m_tb=cand.m_tb, k_tb=cand.k_tb,
                                     n_tb=cand.n_tb, split_k=cand.split_k,
                                     group=group, binary=binary,
                                     b_dtype_bytes=b_dtype_bytes)
        if bad:
            rejected.extend(bad)
            continue
        shape = dict(m_tb=cand.m_tb, k_tb=cand.k_tb, n_tb=cand.n_tb,
                     split_k=cand.split_k, group=group,
                     b_dtype_bytes=b_dtype_bytes)
        t = roofline.lscd_splitk_terms(
            m, k, n, max_nnz=max_nnz, **shape,
            block_groups=contracts.block_groups(
                group, cand.n_tb, b_dtype_bytes, binary),
            resident=contracts.launch_resident(k, **shape, binary=binary,
                                               max_nnz=max_nnz))
        key = (t.effective_s, t.hbm_bytes, cand.split_k, -cand.n_tb)
        if best_key is None or key < best_key:
            best, best_key = cand, key
    if best is None:
        raise contracts.ScheduleContractError(
            f"no launchable schedule for ({m},{k},{n}) group={group}: "
            + "; ".join(sorted(set(rejected))))
    return best
