"""Shared resource-budget tables of the port's static checkers.

The counterpart of ``repro.analysis.budgets``. Two tables, read by the
checkers, the tests and ``chip_smoke.py`` alike:

* :func:`smem_budget` — the shared memory one block of the CUDA kernels
  may use, in place of the reference's per-core VMEM budget. It is
  ``contracts.SMEM_BYTES_PER_BLOCK`` (the H100's 227 KB), which the launch
  contract (``contracts.check_launch``, rule KC-LAUNCH) checks every
  launch's footprint against; the plain PyTorch versions have no such
  contract.

* :data:`CAPTURE_BUDGETS` / :func:`capture_budget` — what each audited
  entry may accumulate, keyed by the reference's ``COMPILE_BUDGETS``
  names (rule TA-RETRACE). Where the reference jits, the port captures a
  CUDA graph: the decode, verify and mixed steps are shape-static and get
  one capture each; bucketed prefill runs eagerly at ``[admit_k, bucket]``
  shapes (``DeviceStepper.prefill_shapes``), at most the reference's
  ``ceil(log2(max_len))``; the SpMM dispatch keeps one schedule a shape
  (``ops.SCHEDULES``).
"""

from __future__ import annotations

import math
from typing import Optional

from repro_torch.analysis import contracts


def smem_budget(backend: str = "cuda") -> Optional[int]:
    """Shared memory one block may use for ``backend``; None for the plain
    PyTorch versions ("torch"), which launch no kernel of the port's.
    Unknown backends get the CUDA budget: a backend opts out explicitly."""
    return None if backend == "torch" else contracts.SMEM_BYTES_PER_BLOCK


def prefill_shape_budget(max_len: int, min_bucket: int = 8) -> int:
    """Prefill shapes bucketed admission may reach: ``ceil(log2(max_len))``,
    floor 1 (the reference's ``prefill_compile_budget``). Admission pads
    rows to ``admit_k`` and prompts to a power-of-two bucket
    (``engine.length_buckets``), so the shapes are the buckets."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    return max(1, math.ceil(math.log2(max_len)))


#: entry name -> its budget: captures of a step's CUDA graph, prefill
#: shapes, or schedules a SpMM shape. Callables take the keyword
#: parameters the entry needs (``max_len``); ints are flat caps.
CAPTURE_BUDGETS = {
    "batcher_prefill": prefill_shape_budget,
    "engine_prefill_buckets": prefill_shape_budget,
    "batcher_decode": 1,
    "engine_decode_step": 1,
    "batcher_verify": 1,
    "engine_verify_step": 1,
    "batcher_mixed": 1,
    "engine_mixed_step": 1,
    "spmm_dispatch": 1,
}


def capture_budget(entry: str, **params) -> int:
    """Most captures (shapes, schedules) entry ``entry`` may accumulate."""
    if entry not in CAPTURE_BUDGETS:
        raise KeyError(f"no capture budget registered for entry {entry!r}; "
                       f"known: {sorted(CAPTURE_BUDGETS)}")
    b = CAPTURE_BUDGETS[entry]
    return b(**params) if callable(b) else int(b)
