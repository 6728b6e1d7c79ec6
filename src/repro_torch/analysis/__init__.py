"""Static-analysis subsystem of the port: launch contracts, CUDA-source
checks, a dispatch-level step auditor, an AST lint and the metrics/trace
cross-check.

The counterpart of ``repro.analysis``, behind ``tools/torch_check.py``:

* :mod:`repro_torch.analysis.contracts` / :mod:`.kernel_pass` — the Hopper
  launch contracts (KC-LOC, KC-LAUNCH: tiles, split, shared memory,
  accumulators, grid and workspace), enforced inline by
  ``kernels.schedule`` / ``core.tiled_csl`` / the kernel wrappers and
  swept by the pass; f32 accumulation in the CUDA sources (KC-ACC) and
  declared-out call sites (KC-OUT).
* :mod:`.trace_audit` — a ``TorchDispatchMode`` census of the serving
  steps (TA-*): host syncs, large bf16->f32 copies, and the CUDA-graph
  capture, prefill-shape and schedule budgets.
* :mod:`.lint` — AST rules over ``serving/``/``models/`` (PK-*/PY-*,
  OB-SYNC): sampling-noise discipline, host-synchronising branches,
  batcher hazards, step hot-path syncs.
* :mod:`.obs_pass` — metrics counters against the trace events (OB-EVENT).

Findings and suppression: :mod:`.findings`; budget tables: :mod:`.budgets`.
"""

from repro_torch.analysis import budgets, contracts, findings  # noqa: F401
from repro_torch.analysis.contracts import (  # noqa: F401
    ScheduleContractError,
    check_launch,
    require_launch,
    require_tile_loc,
    tile_loc_ok,
)
from repro_torch.analysis.findings import (  # noqa: F401
    RULES,
    Allowlist,
    Finding,
)
