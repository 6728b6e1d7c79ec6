"""Roofline model of the port on an NVIDIA H100.

The H100's published peaks (NVIDIA data sheet, SXM part, dense rates)
stand in place of the TPU's: 989e12 bf16 FLOP/s on the tensor cores,
3.35e12 B/s of HBM and 450e9 B/s of NVLink each way. It holds:

* the schedule-level cost terms ``kernels/schedule.select`` is fitted to
  (:func:`lscd_splitk_terms`, :class:`SplitKTerms`, ``LAUNCH_ROUNDS``),
  the counterpart of ``repro.core.roofline.lscd_splitk_terms``;
* the three-term roofline of a step (:class:`RooflineTerms`: compute,
  memory, collective) and the paper's analytic kernel model: the
  compute intensity of Eq. 1 and Eq. 2 (:func:`dense_gemm_ci`,
  :func:`lscd_ci`) and :func:`dense_gemm_terms`,
  :func:`lscd_kernel_terms`, :func:`lscd_grouped_terms`, as the
  reference's kernel, end-to-end and roofline reports use them;
* the dry run's cost and collective tallies (:func:`cost_dict`,
  :func:`collective_bytes`, :func:`from_cost_dict`), the counterparts of
  ``cost_analysis_dict``, ``parse_collective_bytes`` and
  ``from_cost_analysis``, read from what a dry run records instead of
  from compiled HLO.

Two bounds, for two questions:

* :func:`lscd_bound_s` is the least time of the useful work of one LSCD
  call: each input read once, each output written once, against the
  useful (sparse) operations. ``PERF.md``'s kernel table uses it.
* :func:`lscd_kernel_terms` is the paper's compute-as-dense model: the
  compressed A read once, with dense FLOPs. For OPT-30B's up projection
  (28672 x 7168, 0.8) at N = 1024 the first gives 0.085 ms (bound by
  operations, the sparse ones) and the second 2·28672·7168·1024 /
  989e12 = 0.426 ms, the dense GEMM's own bound.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Optional, Tuple

from repro_torch.kernels import spmm

# ---- H100 SXM constants -----------------------------------------------------
PEAK_FLOPS_BF16 = 989e12      # tensor cores, dense
HBM_BW = 3.35e12              # bytes/s
NVLINK_BW = 450e9             # bytes/s each way, to the host's other cards
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

    def as_dict(self) -> dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "utilization": self.utilization,
                "step_time_s": self.step_time_s,
                "effective_s": self.effective_s}


def lscd_splitk_terms(m: int, k: int, n: int, *, m_tb: int, k_tb: int,
                      n_tb: int, split_k: int, max_nnz: int, group: int = 1,
                      b_dtype_bytes: int = 2, block_groups: int = 1,
                      resident: int = 1, experts: int = 1) -> SplitKTerms:
    """What the grid moves: A words (``max_nnz`` per tile, padding
    included) once per N tile, B once per M tile, C once, and the f32
    partials written and read once when ``split_k > 1``. Utilization: the
    launch's blocks (weights ``block_groups`` to a block) over
    ``LAUNCH_ROUNDS`` rounds of the ``resident`` blocks each SM holds at
    once; below that the achieved bandwidth is modelled as scaling with
    the block count, the skinny-decode failure mode split-K exists to
    fix. An expert-batched launch (``experts`` E) moves all of that E
    times, each expert with its own B, and puts E times the blocks in
    flight: a grid the experts already fill gains nothing from a split
    but its partials' bytes."""
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
    bytes_ = experts * (nt * a_once + mt * b_once + c_bytes + partials)
    blocks = mt * nt * split_k * (group // block_groups) * experts
    util = min(1.0, blocks / float(LAUNCH_ROUNDS * resident * N_SMS))
    return SplitKTerms(flops=float(experts * group) * 2.0 * m * k * n_pad,
                       hbm_bytes=bytes_, utilization=util)


def lscd_bound_s(words_bytes: float, nnz_bytes: float, b_bytes: float,
                 c_bytes: float, flops: float) -> tuple:
    """Least time for one LSCD call: each input read once, each output
    written once, over the memory rate, against its useful operations
    over the bf16 peak. Returns (seconds, "bytes" | "operations")."""
    t_mem = (words_bytes + nnz_bytes + b_bytes + c_bytes) / HBM_BW
    t_ops = flops / PEAK_FLOPS_BF16
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def cost_dict(launches: Iterable[Mapping], *, aten_flops: float = 0.0,
              aten_bytes: float = 0.0) -> Dict[str, float]:
    """A dry run's per-rank costs: the aten ops' FLOPs and bytes (inputs
    read and outputs written, views free) plus each LSCD launch record's
    (``flops``, ``hbm_bytes``, ``predicted_s`` and ``count``: the
    schedule's roofline terms, times the launches)."""
    launches = list(launches)
    lscd_flops = sum(r["flops"] * r["count"] for r in launches)
    lscd_bytes = sum(r["hbm_bytes"] * r["count"] for r in launches)
    return {"flops": float(aten_flops + lscd_flops),
            "bytes accessed": float(aten_bytes + lscd_bytes),
            "aten_flops": float(aten_flops),
            "aten_bytes": float(aten_bytes),
            "lscd_flops": float(lscd_flops),
            "lscd_bytes": float(lscd_bytes),
            "lscd_predicted_s": float(sum(r["predicted_s"] * r["count"]
                                          for r in launches))}


def collective_bytes(records: Iterable[Tuple[str, str, int]], *,
                     by_axis: bool = False) -> Dict[str, float]:
    """Bytes a rank moves per collective kind (``"kind@axis"`` keys with
    ``by_axis``), from a dry mesh's ``(kind, axis, bytes)`` records: an
    all-reduce's operand, a gather's whole result, as the reference
    counts an HLO collective's result bytes."""
    out: Dict[str, float] = {}
    for kind, axis, nbytes in records:
        key = f"{kind}@{axis}" if by_axis else kind
        out[key] = out.get(key, 0.0) + float(nbytes)
    return out


# ---------------------------------------------------------------------------
# three-term roofline (compute / memory / collective)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RooflineTerms:
    """One step's roofline on ``chips`` H100s:

      compute_s    = flops / (chips * PEAK_FLOPS_BF16)
      memory_s     = hbm_bytes / (chips * HBM_BW)
      collective_s = collective_bytes / NVLINK_BW  (already per card)
    """

    flops: float                 # total FLOPs per step
    hbm_bytes: float             # total HBM bytes per step
    collective_bytes: float      # per-card collective bytes per step
    chips: int
    label: str = ""
    model_flops: float = 0.0     # the useful FLOPs
    collective_breakdown: Optional[Dict[str, float]] = None
    model_bytes: float = 0.0     # irreducible HBM bytes (weights + cache)

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS_BF16)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / NVLINK_BW

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """The largest of the three terms (they overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """model_flops / flops: the share of the FLOPs that are useful."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """The ideal time of the useful work, max(model_flops / peak,
        model_bytes / bandwidth), over ``step_time_s``; with
        ``model_bytes`` unknown (0), the compute ideal alone. Unlike the
        reference's, it is not capped at 1: a share above 1 shows that
        the FLOPs or bytes of the step were miscounted."""
        if self.step_time_s == 0:
            return 0.0
        ideal = max(self.model_flops / (self.chips * PEAK_FLOPS_BF16),
                    self.model_bytes / (self.chips * HBM_BW))
        return ideal / self.step_time_s

    def as_dict(self) -> dict:
        return {
            "label": self.label, "chips": self.chips,
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bound": self.bound,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "step_time_s": self.step_time_s,
            "collective_breakdown": self.collective_breakdown,
        }


def from_cost_dict(cost: Mapping, collective: Mapping[str, float],
                   chips: int, *, label: str = "",
                   model_flops: float = 0.0) -> RooflineTerms:
    """Roofline terms of a dry-run cell: ``cost`` is its per-rank
    :func:`cost_dict` (``flops``, ``bytes accessed``), ``collective`` its
    per-rank :func:`collective_bytes` by kind. FLOPs and bytes are
    multiplied by ``chips`` for the whole program, as the reference's
    ``from_cost_analysis`` does with its per-device module's costs."""
    return RooflineTerms(
        flops=float(cost.get("flops", 0.0)) * chips,
        hbm_bytes=float(cost.get("bytes accessed", 0.0)) * chips,
        collective_bytes=float(sum(collective.values())),
        chips=chips, label=label, model_flops=model_flops,
        collective_breakdown=dict(collective))


# ---------------------------------------------------------------------------
# analytic kernel roofline (the LSCD claim, paper Eq. 1 / Eq. 2)
# ---------------------------------------------------------------------------

def dense_gemm_ci(m: int, n: int) -> float:
    """Paper Eq. 1: CI = M·N / (M + N) FLOP per 2-byte element."""
    return (m * n) / (m + n)


def lscd_ci(m: int, n: int, sparsity: float) -> float:
    """Paper Eq. 2: CI under Load-as-Sparse, the index overhead left out
    (``lscd_kernel_terms`` counts the 32-bit words)."""
    return (m * n) / (m * (1.0 - sparsity) + n)


def dense_gemm_terms(m: int, k: int, n: int, *, chips: int = 1,
                     dtype_bytes: int = 2,
                     label: str = "dense") -> RooflineTerms:
    flops = 2.0 * m * k * n
    bytes_ = dtype_bytes * (m * k + k * n + m * n)
    return RooflineTerms(flops=flops, hbm_bytes=bytes_, collective_bytes=0.0,
                         chips=chips, label=label, model_flops=flops)


def lscd_kernel_terms(m: int, k: int, n: int, sparsity: float, *,
                      pad_overhead: float = 0.0, chips: int = 1,
                      label: str = "lscd") -> RooflineTerms:
    """The paper's compute-as-dense model of an LSCD call: A as nnz·4
    bytes of packed words (padding included through ``pad_overhead``), B
    and C dense bf16, dense FLOPs."""
    nnz = m * k * (1.0 - sparsity)
    a_bytes = nnz * 4.0 / max(1.0 - pad_overhead, 1e-9)
    bytes_ = a_bytes + 2.0 * (k * n + m * n)
    flops = 2.0 * m * k * n
    return RooflineTerms(flops=flops, hbm_bytes=bytes_, collective_bytes=0.0,
                         chips=chips, label=label, model_flops=flops)


def lscd_grouped_terms(m: int, k: int, n: int, sparsity: float, *,
                       group: int = 1, epilogue: str = "none",
                       fused: bool = True, pad_overhead: float = 0.0,
                       chips: int = 1, label: str = "lscd_grouped"
                       ) -> RooflineTerms:
    """G same-shape LSCD projections and their epilogue. ``fused``: one
    grouped launch, B read once, one C for a binary epilogue (the
    SwiGLU fusion) or G for a unary one. Not fused: G calls, each reading
    B and writing its C, and with an epilogue a separate pass that reads
    the G outputs back and writes the result."""
    binary = spmm.epilogue_kind(epilogue, groups=group) == "binary"
    nnz = m * k * (1.0 - sparsity)
    a_bytes = group * nnz * 4.0 / max(1.0 - pad_overhead, 1e-9)
    c_one = 2.0 * m * n                     # one bf16 [M, N] block
    if fused:
        b_bytes = 2.0 * k * n
        c_bytes = c_one if binary else group * c_one
    else:
        b_bytes = group * 2.0 * k * n
        c_bytes = group * c_one
        if epilogue != "none":
            c_bytes += group * c_one + (c_one if binary else group * c_one)
    flops = group * 2.0 * m * k * n
    return RooflineTerms(flops=flops, hbm_bytes=a_bytes + b_bytes + c_bytes,
                         collective_bytes=0.0, chips=chips, label=label,
                         model_flops=flops)


def fused_epilogue_saved_bytes(m: int, k: int, n: int, sparsity: float, *,
                               group: int = 1, epilogue: str = "none",
                               pad_overhead: float = 0.0) -> float:
    """HBM bytes per call the grouped fused launch saves against the
    unfused calls."""
    kw = dict(group=group, epilogue=epilogue, pad_overhead=pad_overhead)
    return (lscd_grouped_terms(m, k, n, sparsity, fused=False, **kw).hbm_bytes
            - lscd_grouped_terms(m, k, n, sparsity, fused=True,
                                 **kw).hbm_bytes)


def splitk_partials_bytes(m: int, n_pad: int, split_k: int) -> float:
    """The f32 partials ``[S, M, N]`` a split-K schedule writes and reads
    once each; none at ``split_k == 1``."""
    if split_k <= 1:
        return 0.0
    return 2.0 * 4.0 * split_k * m * n_pad


# Analytic per-tile stream length when no encoding is at hand: tile
# elements · (1 − s) · the imbalance of random unstructured masks at
# 128 x 128, padded to the pad quantum (the reference's figures).
_MAX_NNZ_IMBALANCE = 1.15
_PAD_QUANTUM_WORDS = 128


def analytic_max_nnz(m_tb: int, k_tb: int, sparsity: float) -> int:
    words = m_tb * k_tb * (1.0 - sparsity) * _MAX_NNZ_IMBALANCE
    q = _PAD_QUANTUM_WORDS
    return int(-(-words // q) * q) if words > 0 else q
