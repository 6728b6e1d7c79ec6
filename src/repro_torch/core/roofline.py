"""Schedule-level roofline of the LSCD SpMM on an NVIDIA H100.

The port keeps only the cost terms ``kernels/schedule.select`` needs, the
counterpart of ``repro.core.roofline.lscd_splitk_terms``, with the H100's
published peaks (NVIDIA data sheet, SXM part, dense rates) in place of
the TPU's.
"""

from __future__ import annotations

import dataclasses

# ---- H100 SXM constants -----------------------------------------------------
PEAK_FLOPS_BF16 = 989e12      # tensor cores, dense
HBM_BW = 3.35e12              # bytes/s
N_SMS = 132

# Rounds of resident blocks a launch needs on every SM before it stops
# losing time to SMs that run out of blocks early: decode blocks walk few
# K tiles each, and two rounds let the blocks that finish first be
# replaced (measured on an H100: PERF.md, PR 13).
LAUNCH_ROUNDS = 2


@dataclasses.dataclass
class SplitKTerms:
    """Roofline terms of one concrete LSCD schedule."""

    flops: float
    hbm_bytes: float
    utilization: float

    @property
    def step_time_s(self) -> float:
        return max(self.flops / PEAK_FLOPS_BF16, self.hbm_bytes / HBM_BW)

    @property
    def effective_s(self) -> float:
        return self.step_time_s / max(self.utilization, 1e-9)


def lscd_splitk_terms(m: int, k: int, n: int, *, m_tb: int, k_tb: int,
                      n_tb: int, split_k: int, max_nnz: int, group: int = 1,
                      b_dtype_bytes: int = 2, block_groups: int = 1,
                      resident: int = 1) -> SplitKTerms:
    """What the grid moves: A words (``max_nnz`` per tile, padding
    included) once per N tile, B once per M tile, C once, and the f32
    partials written and read once when ``split_k > 1``. Utilization: the
    launch's blocks (weights ``block_groups`` to a block) over
    ``LAUNCH_ROUNDS`` rounds of the ``resident`` blocks each SM holds at
    once; below that the achieved bandwidth is modelled as scaling with
    the block count, the skinny-decode failure mode split-K exists to
    fix."""
    if split_k < 1:
        raise ValueError(f"split_k must be >= 1, got {split_k}")
    mt = -(-m // m_tb)
    kt = -(-k // k_tb)
    nt = -(-n // n_tb)
    n_pad = nt * n_tb
    a_once = float(group) * mt * kt * (max_nnz * 4.0 + 4.0)
    b_once = float(b_dtype_bytes) * k * n_pad
    c_bytes = float(group) * b_dtype_bytes * m * n_pad
    partials = 8.0 * group * split_k * m * n_pad if split_k > 1 else 0.0
    bytes_ = nt * a_once + mt * b_once + c_bytes + partials
    blocks = mt * nt * split_k * (group // block_groups)
    util = min(1.0, blocks / float(LAUNCH_ROUNDS * resident * N_SMS))
    return SplitKTerms(flops=float(group) * 2.0 * m * k * n_pad,
                       hbm_bytes=bytes_, utilization=util)


def lscd_bound_s(words_bytes: float, nnz_bytes: float, b_bytes: float,
                 c_bytes: float, flops: float) -> tuple:
    """Least time for one LSCD call: each input read once, each output
    written once, over the memory rate, against its useful operations
    over the bf16 peak. Returns (seconds, "bytes" | "operations")."""
    t_mem = (words_bytes + nnz_bytes + b_bytes + c_bytes) / HBM_BW
    t_ops = flops / PEAK_FLOPS_BF16
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")
