"""The port's roofline (``repro_torch.core.roofline``) against the
reference's (``repro.core.roofline``).

Every analytic function counts the same FLOPs and bytes as the
reference's, exactly, on a grid of shapes, sparsities, epilogues,
groups, splits and pad overheads; only the peaks differ: the port's
times are those counts over the H100's 989e12 bf16 FLOP/s, 3.35e12 B/s
of HBM and 450e9 B/s of NVLink. ``from_cost_dict`` reads a dry-run
cell's record as the reference's ``from_cost_analysis`` reads compiled
costs and HLO. ``schedule.select``'s picks, which the schedule-level
terms decide, are pinned on the shapes ``tests/test_torch_schedule.py``
uses.
"""

import itertools

import pytest

from repro.core import roofline as ref_roofline
from repro_torch import configs
from repro_torch.core import roofline
from repro_torch.kernels import schedule
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs
from repro_torch.models.config import ShapeConfig

SHAPES = [(128, 128, 8), (7168, 7168, 16), (28672, 7168, 1024),
          (7168, 28672, 1), (4096, 12288, 32), (200, 300, 7)]
SPARSITIES = [0.0, 0.5, 0.8, 0.95]


def _same_counts(got, want):
    assert got.flops == want.flops
    assert got.hbm_bytes == want.hbm_bytes
    assert got.collective_bytes == want.collective_bytes
    assert got.model_flops == want.model_flops
    assert (got.chips, got.label) == (want.chips, want.label)


def _on_h100(t):
    """The terms' times are the counts over the H100's peaks."""
    assert t.compute_s == t.flops / (t.chips * 989e12)
    assert t.memory_s == t.hbm_bytes / (t.chips * 3.35e12)
    assert t.collective_s == t.collective_bytes / 450e9
    assert t.step_time_s == max(t.compute_s, t.memory_s, t.collective_s)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_eq1_eq2_and_kernel_terms_match_reference(shape):
    m, k, n = shape
    assert roofline.dense_gemm_ci(m, n) == ref_roofline.dense_gemm_ci(m, n)
    for chips, dtype_bytes in ((1, 2), (4, 4)):
        got = roofline.dense_gemm_terms(m, k, n, chips=chips,
                                        dtype_bytes=dtype_bytes)
        _same_counts(got, ref_roofline.dense_gemm_terms(
            m, k, n, chips=chips, dtype_bytes=dtype_bytes))
        _on_h100(got)
    for s, pad in itertools.product(SPARSITIES, (0.0, 0.05, 0.2)):
        assert roofline.lscd_ci(m, n, s) == ref_roofline.lscd_ci(m, n, s)
        got = roofline.lscd_kernel_terms(m, k, n, s, pad_overhead=pad)
        _same_counts(got, ref_roofline.lscd_kernel_terms(
            m, k, n, s, pad_overhead=pad))
        _on_h100(got)


@pytest.mark.parametrize("epilogue", ["none", "silu", "gelu", "relu",
                                      "silu_mul", "gelu_mul"])
def test_grouped_terms_and_saved_bytes_match_reference(epilogue):
    groups = (2,) if epilogue.endswith("_mul") else (1, 2, 3)
    for (m, k, n), s, g, pad, fused in itertools.product(
            SHAPES, (0.5, 0.8), groups, (0.0, 0.1), (True, False)):
        kw = dict(group=g, epilogue=epilogue, pad_overhead=pad)
        got = roofline.lscd_grouped_terms(m, k, n, s, fused=fused, **kw)
        _same_counts(got, ref_roofline.lscd_grouped_terms(
            m, k, n, s, fused=fused, **kw))
        _on_h100(got)
        assert roofline.fused_epilogue_saved_bytes(m, k, n, s, **kw) == \
            ref_roofline.fused_epilogue_saved_bytes(m, k, n, s, **kw)


def test_grouped_terms_refuse_as_reference():
    with pytest.raises(ValueError, match="combines exactly 2 grouped"):
        roofline.lscd_grouped_terms(128, 128, 8, 0.8, group=3,
                                    epilogue="silu_mul")
    with pytest.raises(ValueError, match="unknown epilogue"):
        roofline.lscd_grouped_terms(128, 128, 8, 0.8, epilogue="tanh")


def test_splitk_partials_and_analytic_max_nnz_match_reference():
    for m, n_pad, s in itertools.product((128, 7168, 28672), (8, 16, 64),
                                         (1, 2, 3, 8, 16)):
        assert roofline.splitk_partials_bytes(m, n_pad, s) == \
            ref_roofline.splitk_partials_bytes(m, n_pad, s)
    for m_tb, k_tb, s in itertools.product((64, 128), (32, 64, 128),
                                           (0.0, 0.5, 0.8, 0.95, 1.0)):
        assert roofline.analytic_max_nnz(m_tb, k_tb, s) == \
            ref_roofline.analytic_max_nnz(m_tb, k_tb, s)


def test_bound_fraction_and_useful_ratio_by_hand():
    # Decode-like: 1e9 FLOPs of which 5e8 useful, 3.35e9 B on one card.
    t = roofline.RooflineTerms(flops=1e9, hbm_bytes=3.35e9,
                               collective_bytes=0.0, chips=1,
                               model_flops=5e8, model_bytes=1.675e9)
    assert t.bound == "memory" and t.step_time_s == 1e-3
    assert t.useful_flops_ratio == 0.5
    assert t.roofline_fraction == pytest.approx(0.5, rel=1e-12)
    # Compute-bound over 4 cards, with NVLink traffic under the compute:
    # 4 x 989e12 FLOPs take 1 s; 45e9 B of collectives 0.1 s.
    t = roofline.RooflineTerms(flops=4 * 989e12, hbm_bytes=1e9,
                               collective_bytes=45e9, chips=4,
                               model_flops=2 * 989e12)
    assert t.bound == "compute" and t.step_time_s == 1.0
    assert t.collective_s == pytest.approx(0.1, rel=1e-12)
    assert t.useful_flops_ratio == 0.5
    assert t.roofline_fraction == pytest.approx(0.5, rel=1e-12)
    d = t.as_dict()
    assert (d["bound"], d["step_time_s"], d["chips"]) == ("compute", 1.0, 4)


def test_two_bounds_at_opt30b_up():
    """The module docstring's figures: OPT-30B's up projection at
    N = 1024, 0.8. The useful-work bound (``lscd_bound_s``) against the
    paper's compute-as-dense model, whose time is the dense GEMM's."""
    m, k, n = 28672, 7168, 1024
    bound, by = roofline.lscd_bound_s(0.0, 0.0, 0.0, 0.0,
                                      2.0 * m * k * n * 0.2)
    assert by == "operations" and round(bound * 1e3, 3) == 0.085
    dense = roofline.lscd_kernel_terms(m, k, n, 0.8)
    assert dense.bound == "compute"
    assert round(dense.step_time_s * 1e3, 3) == 0.426
    assert dense.compute_s == roofline.dense_gemm_terms(m, k, n).compute_s


def _hlo_of(collective):
    """HLO lines whose result bytes are ``collective``'s, as the
    reference's parser reads them (u8 elements: one byte each)."""
    return "\n".join(f"  %c{i} = u8[{int(b)}]{{0}} {kind}(%x)"
                     for i, (kind, b) in enumerate(collective.items()))


def test_from_cost_dict_over_a_dry_run_cell():
    cfg = configs.smoke("tinyllama_1_1b")
    mesh = mesh_mod.DryMesh((2, 2), ("data", "model"))
    shape = ShapeConfig("decode_tiny", "decode", 64, 8)
    cell = specs.build_cell(cfg, shape, mesh, weight_mode="sparse_xla")
    ran = dryrun.execute(cell, mesh, train=False)
    cost, coll = ran["cost"], ran["collective_bytes"]
    assert cost["lscd_flops"] > 0 and coll["all-reduce"] > 0
    got = roofline.from_cost_dict(cost, coll, 4, label="cell",
                                  model_flops=123.0)
    want = ref_roofline.from_cost_analysis(cost, _hlo_of(coll), 4,
                                           label="cell", model_flops=123.0)
    _same_counts(got, want)
    assert got.collective_breakdown == want.collective_breakdown == coll
    assert got.flops == cost["flops"] * 4
    assert got.hbm_bytes == cost["bytes accessed"] * 4
    _on_h100(got)


def test_splitk_terms_as_dict():
    t = roofline.lscd_splitk_terms(7168, 7168, 16, m_tb=128, k_tb=128,
                                   n_tb=16, split_k=4, max_nnz=3456)
    d = t.as_dict()
    assert (d["flops"], d["hbm_bytes"], d["utilization"]) == \
        (t.flops, t.hbm_bytes, t.utilization)
    assert (d["step_time_s"], d["effective_s"]) == \
        (t.step_time_s, t.effective_s)


# (m, k, n, group) -> (m_tb, k_tb, n_tb, split_k): the analytic picks on
# the shapes of tests/test_torch_schedule.py, at its max_nnz 3456.
PICKS = {(7168, 7168, 16, 1): (128, 128, 16, 16),
         (256, 256, 16, 1): (128, 128, 64, 1),
         (7168, 7168, 16, 3): (128, 128, 16, 8),
         (128, 256, 8, 1): (128, 128, 64, 1)}


@pytest.mark.parametrize("shape", sorted(PICKS), ids=str)
def test_select_picks_unchanged(shape):
    m, k, n, g = shape
    got = schedule.select(m, k, n, group=g, m_tb=128, k_tb=128, max_nnz=3456,
                          cache=False)
    assert (got.m_tb, got.k_tb, got.n_tb, got.split_k) == PICKS[shape]
