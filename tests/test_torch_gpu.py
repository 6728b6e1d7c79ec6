"""The port's CUDA kernels against their plain versions, and the serving
stepper's decode, verify and mixed steps as CUDA graphs against their
eager runs, on the card.

Marked ``gpu``: each test skips where no CUDA device is present (the CPU
tier-1 run) and runs on the card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

The kernels build from ``src/repro_torch/kernels/csrc`` at first use.
Tolerances, as ``chip_smoke.py`` states them: f32 ``rtol=atol=1e-5``
(f32 sums in another order); bf16 ``rtol=8e-3`` (one bf16 ulp, 2^-7
relative) plus 1e-3 of the largest output, for the drift of the tensor
cores' truncating f32 accumulation. The plain versions run with
``allow_tf32 = False``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import pruning, tiled_csl
from repro_torch.analysis import contracts
from repro_torch.kernels import gemm, ops, ref, schedule, spmm
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.serving import engine, step

pytestmark = pytest.mark.gpu

GEOMS = [(128, 128), (64, 128), (128, 64)]
DTYPES = [torch.float32, torch.bfloat16]


def _assert_close(got, want):
    if want.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        atol = 1e-5 + 1e-3 * float(want.float().abs().max())
        torch.testing.assert_close(got, want, rtol=8e-3, atol=atol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weights(dev, groups, m_tb, k_tb):
    """``groups`` pruned 256x384 weights with an all-empty first tile."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ts = []
    for _ in range(groups):
        w = torch.randn((256, 384), generator=gen, device=dev)
        w[:m_tb, :k_tb] = 0.0
        ts.append(tiled_csl.encode(pruning.prune(w, 0.8), m_tb=m_tb,
                                   k_tb=k_tb))
    return ts, gen


@pytest.mark.parametrize("split_k", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", GEOMS)
def test_spmm_kernels_match_plain(cuda, geom, dtype, split_k):
    (t,), gen = _weights(cuda, 1, *geom)
    b = (0.1 * torch.randn((384, 7), generator=gen, device=cuda)).to(dtype)
    bias = torch.randn((256,), generator=gen, device=cuda)
    name = "lscd_spmm_splitk" if split_k > 1 else "lscd_spmm"
    before = spmm.launch_counts()[name]
    got = ops.spmm(t, b, backend="cuda", split_k=split_k, epilogue="gelu",
                   bias=bias)
    want = ref.spmm_splitk_ref(t, b, split_k, out_dtype=dtype,
                               epilogue="gelu", bias=bias)
    _assert_close(got, want)
    assert spmm.launch_counts()[name] == before + 1


@pytest.mark.parametrize("split_k", [1, 3])
@pytest.mark.parametrize("groups,epilogue", [(3, "none"), (2, "silu_mul"),
                                             (2, "gelu_mul")])
@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_kernels_match_plain(cuda, dtype, groups, epilogue, split_k):
    ts, gen = _weights(cuda, groups, 128, 128)
    t = tiled_csl.group_stack(ts)
    b = (0.1 * torch.randn((384, 16), generator=gen, device=cuda)).to(dtype)
    bias = torch.randn((groups, 256), generator=gen, device=cuda)
    got = ops.spmm_grouped(t, b, backend="cuda", split_k=split_k,
                           epilogue=epilogue, bias=bias)
    want = ref.spmm_splitk_grouped_ref(t, b, split_k, out_dtype=dtype,
                                       epilogue=epilogue, bias=bias)
    _assert_close(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_splitk_s1_bitmatches_single_pass(cuda, dtype):
    ts, gen = _weights(cuda, 2, 128, 128)
    b = (0.1 * torch.randn((384, 8), generator=gen, device=cuda)).to(dtype)
    bias = torch.randn((2, 256), generator=gen, device=cuda)
    one = spmm.lscd_spmm(ts[0], b, n_tb=8, epilogue="gelu", bias=bias[0])
    s1 = spmm.lscd_spmm_splitk(ts[0], b, n_tb=8, split_k=1, epilogue="gelu",
                               bias=bias[0])
    assert torch.equal(one, s1)
    g = tiled_csl.group_stack(ts)
    one = spmm.lscd_spmm_grouped(g, b, n_tb=8, epilogue="silu_mul", bias=bias)
    s1 = spmm.lscd_spmm_splitk_grouped(g, b, n_tb=8, split_k=1,
                                       epilogue="silu_mul", bias=bias)
    assert torch.equal(one, s1)


# ---- the pipelined body (bf16, n_tb >= 64) and the dense GEMM -------------

PIPE_N_TB = [64, 128]


@pytest.mark.parametrize("n_tb", PIPE_N_TB)
@pytest.mark.parametrize("epilogue", ["none", "silu", "gelu", "relu"])
@pytest.mark.parametrize("geom", GEOMS)
def test_pipelined_single_pass_matches_plain(cuda, geom, epilogue, n_tb):
    """Ragged N through ops (padded to n_tb), an empty first tile, bias."""
    (t,), gen = _weights(cuda, 1, *geom)
    b = (0.1 * torch.randn((384, n_tb + 5), generator=gen,
                           device=cuda)).to(torch.bfloat16)
    bias = torch.randn((256,), generator=gen, device=cuda)
    got = ops.spmm(t, b, backend="cuda", n_tb=n_tb, split_k=1,
                   epilogue=epilogue, bias=bias)
    _assert_close(got, ref.spmm_ref(t, b, out_dtype=torch.bfloat16,
                                    epilogue=epilogue, bias=bias))
    b = b[:, :n_tb].contiguous()
    got = spmm.lscd_spmm(t, b, n_tb=n_tb, epilogue=epilogue)
    _assert_close(got, ref.spmm_ref(t, b, out_dtype=torch.bfloat16,
                                    epilogue=epilogue))


@pytest.mark.parametrize("n_tb", PIPE_N_TB)
@pytest.mark.parametrize("groups,epilogue", [(3, "none"), (3, "gelu"),
                                             (2, "relu"), (2, "silu_mul"),
                                             (2, "gelu_mul")])
@pytest.mark.parametrize("geom", GEOMS)
def test_pipelined_grouped_matches_plain(cuda, geom, groups, epilogue, n_tb):
    binary = epilogue.endswith("_mul")
    if contracts.check_launch(256, 384, 2 * n_tb, m_tb=geom[0], k_tb=geom[1],
                              n_tb=n_tb, split_k=1, group=groups,
                              binary=binary):
        pytest.skip("the contract refuses this tile (registers)")
    ts, gen = _weights(cuda, groups, *geom)
    t = tiled_csl.group_stack(ts)
    b = (0.1 * torch.randn((384, 2 * n_tb), generator=gen,
                           device=cuda)).to(torch.bfloat16)
    bias = torch.randn((groups, 256), generator=gen, device=cuda)
    got = spmm.lscd_spmm_grouped(t, b, n_tb=n_tb, epilogue=epilogue,
                                 bias=bias)
    _assert_close(got, ref.spmm_grouped_ref(t, b, out_dtype=torch.bfloat16,
                                            epilogue=epilogue, bias=bias))


@pytest.mark.parametrize("n_tb", PIPE_N_TB)
@pytest.mark.parametrize("split_k", [2, 3])
def test_pipelined_splitk_matches_plain(cuda, n_tb, split_k):
    ts, gen = _weights(cuda, 3, 128, 128)
    b = (0.1 * torch.randn((384, n_tb), generator=gen,
                           device=cuda)).to(torch.bfloat16)
    bias = torch.randn((3, 256), generator=gen, device=cuda)
    got = spmm.lscd_spmm_splitk(ts[0], b, n_tb=n_tb, split_k=split_k,
                                epilogue="gelu", bias=bias[0])
    _assert_close(got, ref.spmm_splitk_ref(ts[0], b, split_k,
                                           out_dtype=torch.bfloat16,
                                           epilogue="gelu", bias=bias[0]))
    g = tiled_csl.group_stack(ts)
    got = spmm.lscd_spmm_splitk_grouped(g, b, n_tb=n_tb, split_k=split_k,
                                        bias=bias)
    _assert_close(got, ref.spmm_splitk_grouped_ref(
        g, b, split_k, out_dtype=torch.bfloat16, bias=bias))


@pytest.mark.parametrize("n_tb", PIPE_N_TB)
def test_pipelined_splitk_s1_bitmatches_single_pass(cuda, n_tb):
    ts, gen = _weights(cuda, 3, 128, 128)
    b = (0.1 * torch.randn((384, 2 * n_tb), generator=gen,
                           device=cuda)).to(torch.bfloat16)
    bias = torch.randn((3, 256), generator=gen, device=cuda)
    one = spmm.lscd_spmm(ts[0], b, n_tb=n_tb, epilogue="gelu", bias=bias[0])
    s1 = spmm.lscd_spmm_splitk(ts[0], b, n_tb=n_tb, split_k=1,
                               epilogue="gelu", bias=bias[0])
    assert torch.equal(one, s1)
    g3 = tiled_csl.group_stack(ts)
    one = spmm.lscd_spmm_grouped(g3, b, n_tb=n_tb, epilogue="silu",
                                 bias=bias)
    s1 = spmm.lscd_spmm_splitk_grouped(g3, b, n_tb=n_tb, split_k=1,
                                       epilogue="silu", bias=bias)
    assert torch.equal(one, s1)
    if n_tb == 64:                       # the pair fits at 64 only
        g2 = tiled_csl.group_stack(ts[:2])
        one = spmm.lscd_spmm_grouped(g2, b, n_tb=n_tb, epilogue="silu_mul",
                                     bias=bias[:2])
        s1 = spmm.lscd_spmm_splitk_grouped(g2, b, n_tb=n_tb, split_k=1,
                                           epilogue="silu_mul",
                                           bias=bias[:2])
        assert torch.equal(one, s1)


def test_pipelined_all_empty_weight_gives_bias(cuda):
    z = tiled_csl.encode(torch.zeros((128, 256), device=cuda))
    b = torch.randn((256, 128), device=cuda).to(torch.bfloat16)
    bias = torch.randn((128,), device=cuda)
    got = spmm.lscd_spmm(z, b, n_tb=128, bias=bias)
    assert torch.equal(got, bias.to(torch.bfloat16)[:, None].expand(128, 128))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", [(128, 128, 128), (64, 128, 64),
                                  (128, 64, 128)])
def test_dense_gemm_matches_plain(cuda, geom, dtype, out_dtype):
    m_tb, k_tb, n_tb = geom
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    a = torch.randn((256, 384), generator=gen, device=cuda).to(dtype)
    b = torch.randn((384, 256), generator=gen, device=cuda).to(dtype)
    before = gemm.launch_counts()["dense_gemm"]
    got = gemm.dense_gemm(a, b, m_tb=m_tb, k_tb=k_tb, n_tb=n_tb,
                          out_dtype=out_dtype)
    assert gemm.launch_counts()["dense_gemm"] == before + 1
    want = gemm.dense_gemm_ref(a, b, out_dtype=out_dtype)
    if dtype == torch.float32 and out_dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    else:   # bf16 products or a bf16 cast: the bf16 tolerance
        atol = 1e-5 + 1e-3 * float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                                   atol=atol)


def _gemm_close(got, want):
    atol = 1e-5 + 1e-3 * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                               atol=atol)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", [(128, 128, 256), (64, 64, 256),
                                  (128, 64, 256)])
def test_dense_gemm_n256_matches_plain(cuda, geom, out_dtype):
    """The 128 x 256 tile (m64n256 wgmma, setmaxnreg) and its 64-row
    variant, bf16 inputs, f32 and bf16 outputs."""
    m_tb, k_tb, n_tb = geom
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    a = torch.randn((256, 384), generator=gen, device=cuda).bfloat16()
    b = torch.randn((384, 512), generator=gen, device=cuda).bfloat16()
    got = gemm.dense_gemm(a, b, m_tb=m_tb, k_tb=k_tb, n_tb=n_tb,
                          out_dtype=out_dtype)
    assert got.dtype == out_dtype
    _gemm_close(got, gemm.dense_gemm_ref(a, b, out_dtype=out_dtype))


@pytest.mark.parametrize("n_tb", [128, 256])
def test_dense_gemm_persistent_walk(cuda, n_tb):
    """More output tiles than the card has SMs: each persistent block walks
    several tiles, its ring carried from one to the next."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(6)
    a = torch.randn((2048, 1024), generator=gen, device=cuda).bfloat16()
    b = torch.randn((1024, 2048), generator=gen, device=cuda).bfloat16()
    tiles = (2048 // 128) * (2048 // n_tb)
    if n_tb == 128:
        assert tiles > torch.cuda.get_device_properties(
            cuda).multi_processor_count
    got = gemm.dense_gemm(a, b, n_tb=n_tb, out_dtype=torch.bfloat16)
    _gemm_close(got, gemm.dense_gemm_ref(a, b, out_dtype=torch.bfloat16))


@pytest.mark.parametrize("n_tb", [128, 256])
@pytest.mark.parametrize("k", [64, 576])
def test_dense_gemm_k_edges(cuda, k, n_tb):
    """K of a single 64-deep stage, and K = 9 stages, a multiple of neither
    ring depth (4 at n_tb = 256, 7 at 128), over several tiles a block."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    a = torch.randn((4096, k), generator=gen, device=cuda).bfloat16()
    b = torch.randn((k, 1024), generator=gen, device=cuda).bfloat16()
    got = gemm.dense_gemm(a, b, k_tb=64, n_tb=n_tb)
    _gemm_close(got, gemm.dense_gemm_ref(a, b))


def test_dense_gemm_refuses_unaligned_b(cuda):
    """A tensor map needs a 16-byte aligned base: the wrapper raises."""
    a = torch.zeros((128, 128), device=cuda, dtype=torch.bfloat16)
    b = torch.zeros((128 * 256 + 8,), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        gemm.dense_gemm(a, b[1:1 + 128 * 256].view(128, 256), n_tb=256)
    # the C entry itself: the tensor map's encode fails, the launch returns
    # its error and never runs
    from repro_torch.kernels import build
    out = torch.empty((128, 256), device=cuda)
    rc = build.entry("dense_gemm")(
        a.data_ptr(), b.data_ptr() + 2, out.data_ptr(), 128, 128, 256, 128,
        128, 256, 1, torch.cuda.current_stream(cuda).cuda_stream)
    assert rc != 0


def test_dense_gemm_equals_spmm_on_same_matrix(cuda):
    (t,), gen = _weights(cuda, 1, 128, 128)
    b = (0.1 * torch.randn((384, 128), generator=gen,
                           device=cuda)).to(torch.bfloat16)
    dense = gemm.dense_gemm(tiled_csl.decode(t).to(torch.bfloat16), b,
                            out_dtype=torch.bfloat16)
    sparse = spmm.lscd_spmm(t, b, n_tb=128)
    _assert_close(sparse, dense)


# ---- the decode body (bf16, n_tb <= 32) -----------------------------------

DECODE_N_TB = [8, 16, 32]


def _decode_weights(dev, groups, m_tb, k_tb, dense_tile):
    """``groups`` pruned 256 x 8-K-tile weights, with: an empty tile in the
    middle of the second K half (m tile 1, K tile 5); K tiles 2 and 3 empty
    in every row, so at S = 4 the second K slice has no live step; and,
    with ``dense_tile``, one fully dense tile (max_nnz = m_tb * k_tb)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    k = 8 * k_tb
    ts = []
    for _ in range(groups):
        w = pruning.prune(torch.randn((256, k), generator=gen, device=dev),
                          0.8)
        w[m_tb:2 * m_tb, 5 * k_tb:6 * k_tb] = 0.0
        w[:, 2 * k_tb:4 * k_tb] = 0.0
        if dense_tile:
            w[:m_tb, 6 * k_tb:7 * k_tb] = 1.0 + torch.rand(
                (m_tb, k_tb), generator=gen, device=dev)
        ts.append(tiled_csl.encode(w, m_tb=m_tb, k_tb=k_tb))
    return ts, gen


def _decode_b(gen, dev, k, n):
    return (0.1 * torch.randn((k, n), generator=gen,
                              device=dev)).to(torch.bfloat16)


@pytest.mark.parametrize("dense_tile", [False, True])
@pytest.mark.parametrize("n_cols", [1, 2])          # N = n_cols * n_tb
@pytest.mark.parametrize("n_tb", DECODE_N_TB)
@pytest.mark.parametrize("geom", GEOMS)
def test_decode_body_splitk_matches_plain(cuda, geom, n_tb, n_cols,
                                          dense_tile):
    """Ragged nnz (not a multiple of 4), an empty tile mid-slice, a K slice
    with no live step (S = 4), a dense tile; B one N tile wide (one copy)
    or two (a copy per row)."""
    (t,), gen = _decode_weights(cuda, 1, *geom, dense_tile)
    assert bool((t.nnz % 4 != 0).any())
    assert t.max_nnz == (geom[0] * geom[1] if dense_tile else t.max_nnz)
    b = _decode_b(gen, cuda, t.shape[1], n_cols * n_tb)
    bias = torch.randn((256,), generator=gen, device=cuda)
    for s in (1, 2, 4):
        got = spmm.lscd_spmm_splitk(t, b, n_tb=n_tb, split_k=s,
                                    epilogue="gelu", bias=bias)
        _assert_close(got, ref.spmm_splitk_ref(
            t, b, s, out_dtype=torch.bfloat16, epilogue="gelu", bias=bias))


@pytest.mark.parametrize("dense_tile", [False, True])
@pytest.mark.parametrize("n_tb", DECODE_N_TB)
@pytest.mark.parametrize("geom", GEOMS)
def test_decode_body_grouped_matches_plain(cuda, geom, n_tb, dense_tile):
    """G=3 unary (the weight in the grid) and G=2 silu_mul (the pair in one
    block), single pass and split-K."""
    ts, gen = _decode_weights(cuda, 3, *geom, dense_tile)
    b = _decode_b(gen, cuda, ts[0].shape[1], 2 * n_tb)
    bias = torch.randn((3, 256), generator=gen, device=cuda)
    for g, epi in ((tiled_csl.group_stack(ts), "gelu"),
                   (tiled_csl.group_stack(ts[:2]), "silu_mul")):
        gb = bias[:g.group]
        got = spmm.lscd_spmm_grouped(g, b, n_tb=n_tb, epilogue=epi, bias=gb)
        _assert_close(got, ref.spmm_grouped_ref(
            g, b, out_dtype=torch.bfloat16, epilogue=epi, bias=gb))
        for s in (2, 4):
            got = spmm.lscd_spmm_splitk_grouped(g, b, n_tb=n_tb, split_k=s,
                                                epilogue=epi, bias=gb)
            _assert_close(got, ref.spmm_splitk_grouped_ref(
                g, b, s, out_dtype=torch.bfloat16, epilogue=epi, bias=gb))


@pytest.mark.parametrize("dense_tile", [False, True])
@pytest.mark.parametrize("n_tb", DECODE_N_TB)
@pytest.mark.parametrize("geom", GEOMS)
def test_decode_body_s1_bitmatches_single_pass(cuda, geom, n_tb, dense_tile):
    ts, gen = _decode_weights(cuda, 3, *geom, dense_tile)
    b = _decode_b(gen, cuda, ts[0].shape[1], n_tb)
    bias = torch.randn((3, 256), generator=gen, device=cuda)
    one = spmm.lscd_spmm(ts[0], b, n_tb=n_tb, epilogue="gelu", bias=bias[0])
    s1 = spmm.lscd_spmm_splitk(ts[0], b, n_tb=n_tb, split_k=1,
                               epilogue="gelu", bias=bias[0])
    assert torch.equal(one, s1)
    for g, epi in ((tiled_csl.group_stack(ts), "silu"),
                   (tiled_csl.group_stack(ts[:2]), "silu_mul")):
        gb = bias[:g.group]
        one = spmm.lscd_spmm_grouped(g, b, n_tb=n_tb, epilogue=epi, bias=gb)
        s1 = spmm.lscd_spmm_splitk_grouped(g, b, n_tb=n_tb, split_k=1,
                                           epilogue=epi, bias=gb)
        assert torch.equal(one, s1)


def test_decode_body_refuses_unaligned_words(cuda):
    """The decode body copies whole 16-byte chunks of a tile's words: an
    encoding whose max_nnz is not a multiple of 4 is refused before any
    launch, and nothing falls back."""
    w = pruning.prune(torch.randn((128, 256), device=cuda), 0.8)
    t = tiled_csl.encode(w, pad_quantum=1)
    t = tiled_csl.pad_max_nnz(t, t.max_nnz + (1 if t.max_nnz % 4 == 0
                                              else 0))
    b = _decode_b(torch.Generator(device=cuda), cuda, 256, 8)
    before = spmm.launch_counts()["lscd_spmm_splitk"]
    with pytest.raises(contracts.ScheduleContractError, match="max_nnz"):
        spmm.lscd_spmm_splitk(t, b, n_tb=8, split_k=2)
    assert spmm.launch_counts()["lscd_spmm_splitk"] == before


# ---------------------------------------------------------------------------
# the expert-batched kernels (MoE stacks)
# ---------------------------------------------------------------------------

def _expert_stack(dev, experts, m_tb=128, k_tb=128):
    """An expert stack of ``experts`` pruned 256x384 weights: expert 0 has
    an all-empty first tile, expert 1 is all zeros, the rest differ in
    density, so the stack pads every expert to one max_nnz."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    ws = []
    for e in range(experts):
        w = torch.randn((256, 384), generator=gen, device=dev)
        if e == 0:
            w[:m_tb, :k_tb] = 0.0
        if e == 1:
            w.zero_()
        ws.append(pruning.prune(w, 0.6 + 0.05 * (e % 4)))
    t = tiled_csl.encode_stack(torch.stack(ws), m_tb=m_tb, k_tb=k_tb)
    return t, gen


BATCHED_N_TB = [8, 16, 32, 64, 128]


@pytest.mark.parametrize("split_k", [1, 2, 3])
@pytest.mark.parametrize("n_tb", BATCHED_N_TB)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", GEOMS)
def test_batched_kernels_match_plain(cuda, geom, dtype, n_tb, split_k):
    """C[e] = A[e] @ B[e] for five experts in one launch (one partials
    launch and one reduce at S > 1), every body (decode, pipelined, f32
    first), ragged N, against the loop of plain versions."""
    t, gen = _expert_stack(cuda, 5, *geom)
    n = 2 * n_tb - 3 if n_tb > 8 else 13
    b = (0.1 * torch.randn((5, 384, n), generator=gen, device=cuda)).to(dtype)
    name = "lscd_spmm_splitk_batched" if split_k > 1 else "lscd_spmm_batched"
    bad = contracts.check_launch(256, 384, n, m_tb=geom[0], k_tb=geom[1],
                                 n_tb=n_tb, split_k=split_k,
                                 b_dtype_bytes=b.element_size(),
                                 max_nnz=t.max_nnz, experts=5)
    if bad:
        pytest.skip("; ".join(bad))
    before = spmm.launch_counts()[name]
    got = ops.spmm_batched(t, b, backend="cuda", n_tb=n_tb, split_k=split_k)
    want = ref.spmm_splitk_batched_ref(t, b, split_k, out_dtype=dtype)
    _assert_close(got, want)
    assert spmm.launch_counts()[name] == before + 1
    assert torch.equal(got[1], torch.zeros_like(got[1]))   # all-zero expert


@pytest.mark.parametrize("n_tb", [8, 32, 64])
def test_batched_equals_per_expert_kernel(cuda, n_tb):
    """The batched launch runs each expert through the single-weight
    kernel's body: bit-equal to one ``lscd_spmm``/``lscd_spmm_splitk``
    launch per expert, single pass and split-K."""
    t, gen = _expert_stack(cuda, 4)
    b = torch.randn((4, 384, 2 * n_tb), generator=gen,
                    device=cuda).to(torch.bfloat16)
    for split_k in (1, 3):
        got = ops.spmm_batched(t, b, backend="cuda", n_tb=n_tb,
                               split_k=split_k)
        for e in range(4):
            one = ops.spmm(tiled_csl.expert_slice(t, e), b[e].contiguous(),
                           backend="cuda", n_tb=n_tb, split_k=split_k)
            assert torch.equal(got[e], one), (e, split_k)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_batched_kernels_at_a_ranks_expert_count(cuda, dtype):
    """A stack of 8 experts cut over a model axis of 4 (expert
    parallelism: ``sharding.shard_tiled_csl``, E/4 = 2 experts a rank,
    each keeping the stack's ``max_nnz``): each rank's batched launch at
    decode N = 2, single pass and split-K, equals the plain version on
    its shard and, bit for bit, the whole stack's launch on those
    experts; f32 B (the row-parallel partial's operand under tensor
    parallelism inside each expert) runs the first body."""
    from repro_torch.distributed import sharding
    t, gen = _expert_stack(cuda, 8)
    b = (0.1 * torch.randn((8, 384, 2), generator=gen,
                           device=cuda)).to(dtype)
    spec = ("model", None, None, None)
    for split_k in (1, 2):
        whole = ops.spmm_batched(t, b, backend="cuda", n_tb=8,
                                 split_k=split_k)
        for r in range(4):
            mine = sharding.shard_tiled_csl(t, spec, {"model": 4},
                                            coords={"model": r})
            assert mine.experts == 2 and mine.max_nnz == t.max_nnz
            bs = b[2 * r:2 * r + 2].contiguous()
            got = ops.spmm_batched(mine, bs, backend="cuda", n_tb=8,
                                   split_k=split_k)
            _assert_close(got, ref.spmm_splitk_batched_ref(
                mine, bs, split_k, out_dtype=dtype))
            assert torch.equal(got, whole[2 * r:2 * r + 2])


def test_batched_refusals(cuda):
    """The grouped and single-weight entries refuse an expert stack; the
    batched ones refuse a plain weight and a B of the wrong expert
    count; nothing launches."""
    t, gen = _expert_stack(cuda, 3)
    b = torch.randn((3, 384, 8), generator=gen,
                    device=cuda).to(torch.bfloat16)
    before = spmm.launch_counts()
    with pytest.raises(ValueError, match="expert stack"):
        ops.spmm_grouped(t, b[0], backend="cuda")
    with pytest.raises(ValueError, match="expert stack"):
        spmm.lscd_spmm(t, b[0], n_tb=8)
    with pytest.raises(ValueError, match="expert stack"):
        ops.spmm_batched(tiled_csl.expert_slice(t, 0), b, backend="cuda")
    with pytest.raises(ValueError, match="E=3"):
        spmm.lscd_spmm_batched(t, b[:2], n_tb=8)
    assert spmm.launch_counts() == before


# ---------------------------------------------------------------------------
# the serving stepper's decode step as a CUDA graph
# ---------------------------------------------------------------------------

def _stepper_pair(dev, paged, temperature=0.0, params_cfg=None, **extra):
    """Two steppers over one sparse smoke model (OPT-30B smoke, 0.8, unless
    ``params_cfg`` gives another (params, cfg)), one graphed and one eager,
    each with one prompt prefilled into every slot (dense) or every
    slot's own blocks (paged). ``extra`` goes to both steppers
    (``spec_k``, ``chunk_size``)."""
    if params_cfg is None:
        cfg = configs.smoke("opt_30b")
        params, _ = serve.build(cfg, seed=0, sparsity=0.8, device=dev)
    else:
        params, cfg = params_cfg
    n_slots, max_len, block = 4, 32, 8
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (n_slots, 8))
    lens = np.array([8, 5, 7, 3])
    kw = dict(n_slots=n_slots, max_len=max_len, temperature=temperature,
              top_k=8 if temperature else 0, seed=3, **extra)
    tables = None
    if paged:
        kw.update(physical_blocks=1 + n_slots * (max_len // block),
                  block_size=block)
        tables = 1 + np.arange(n_slots * 4).reshape(n_slots, 4)
    out = []
    for graph in (True, False):
        st = step.DeviceStepper(params, cfg, graph=graph, **kw)
        targets = tables[:, :1] if paged else np.arange(n_slots)
        logits = st.prefill(tokens, targets, lens)
        first, ok = st.sample_admitted(logits, np.arange(n_slots), lens * 0)
        assert ok.all()
        out.append(st)
    return out, first, lens, tables


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("paged", [False, True])
def test_graphed_decode_bit_equals_eager(cuda, paged, temperature):
    """Six decode steps, slots at different positions: the replayed graph
    gives the eager step's tokens, and both leave bit-identical caches."""
    (graphed, eager), first, lens, tables = _stepper_pair(cuda, paged,
                                                          temperature)
    toks = {id(graphed): first, id(eager): first}
    for i in range(6):
        for st in (graphed, eager):
            tok, ok = st.decode(toks[id(st)], lens + i, tables,
                                np.arange(4), np.full(4, i + 1))
            assert ok.all()
            toks[id(st)] = tok
        assert np.array_equal(toks[id(graphed)], toks[id(eager)])
    for a, b in zip(graphed.cache, eager.cache):
        for name in ("k", "v"):
            assert torch.equal(a[name], b[name])
    assert graphed.graph and not eager.graph


def test_graph_replays_are_counted(cuda):
    """``launch_counts()`` counts what ran: the capture's own recording is
    taken back out, each replay adds the graph's launches, and a graphed
    step counts what an eager step counts."""
    (graphed, eager), first, lens, _ = _stepper_pair(cuda, False)
    graphed.decode(first, lens, None, None, None)        # warm-up + capture
    per_step = graphed.graph_launches
    assert per_step and sum(per_step.values()) > 0
    spmm.reset_launch_counts()
    for i in range(3):
        graphed.decode(first, lens + 1 + i, None, None, None)
    assert spmm.launch_counts() == {k: 3 * per_step.get(k, 0)
                                    for k in spmm.KERNELS}
    spmm.reset_launch_counts()
    eager.decode(first, lens, None, None, None)
    assert spmm.launch_counts() == {k: per_step.get(k, 0)
                                    for k in spmm.KERNELS}


def test_failed_capture_raises_and_never_falls_back(cuda):
    """A step that syncs with the host cannot be captured: the capture
    raises, the counts keep nothing of it, and the stepper stays without
    a graph."""
    (graphed, _), first, lens, _ = _stepper_pair(cuda, False)
    step_fn = graphed._decode_step

    def syncing_step():
        out = step_fn()
        int(out[0][0])                    # a host read inside the capture
        return out

    graphed._decode_step = syncing_step
    before = spmm.launch_counts()
    with pytest.raises(RuntimeError):
        graphed.decode(first, lens, None, None, None)
    assert "decode" not in graphed._graphs and not graphed.captures["decode"]
    after = spmm.launch_counts()
    # only the eager warm-up's launches remain counted
    assert all(after[k] >= before[k] for k in spmm.KERNELS)
    torch.cuda.synchronize()


def _paged_leaves(st):
    """The stepper's pool leaves without the trash block (block 0), whose
    bytes are never read unmasked and may differ where several rejected
    columns write one trash position."""
    return [layer[n][1:] for layer in st.cache for n in sorted(layer)]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_graphed_verify_and_mixed_equal_eager(cuda, temperature):
    """Three verify windows (drafts of 3, 2, 1 and 0 tokens) and two mixed
    steps (a decode slot, a full and a partial chunk, an idle slot): the
    replayed graphs give the eager steps' tokens and accept counts, leave
    bit-identical real blocks, are captured once each, and count their
    launches at every replay."""
    (graphed, eager), first, lens, tables = _stepper_pair(
        cuda, True, temperature, spec_k=3, chunk_size=4)
    vocab = graphed.cfg.vocab
    rng = np.random.default_rng(1)
    uids, pos, last = np.arange(4), lens.copy(), first
    for i in range(3):
        tokens = np.concatenate(
            [last[:, None], rng.integers(0, vocab, (4, 3))], axis=1)
        dl = np.array([3, 2, 1, 0])
        spmm.reset_launch_counts()
        outs = [st.verify(tokens, pos, tables, dl, uids, np.full(4, i))
                for st in (graphed, eager)]
        assert np.array_equal(outs[0][0], outs[1][0])
        assert np.array_equal(outs[0][1], outs[1][1])
        if i:           # a replay counts what an eager step counts
            per = graphed.graph_launches_of("verify")
            assert per and spmm.launch_counts() == {
                k: 2 * per.get(k, 0) for k in spmm.KERNELS}
        tgt, n_acc = outs[0]
        last, pos = tgt[np.arange(4), n_acc], pos + n_acc + 1
    for i in range(2):
        n_tok = np.array([1, 4, 2, 0])
        tokens = rng.integers(0, vocab, (4, 4))
        tokens[:, 0] = np.where(n_tok == 1, last, tokens[:, 0])
        tokens[np.arange(4)[None, :] >= n_tok[:, None]] = 0
        outs = [st.mixed(tokens, pos, tables, n_tok, uids, np.full(4, 9 + i))
                for st in (graphed, eager)]
        assert np.array_equal(outs[0][0], outs[1][0])
        assert outs[0][1].all() and outs[1][1].all()
        last, pos = outs[0][0], pos + n_tok
    for a, b in zip(_paged_leaves(graphed), _paged_leaves(eager)):
        assert torch.equal(a, b)
    assert graphed.captures == {"decode": 0, "verify": 1, "mixed": 1}
    assert not any(eager.captures.values())


def test_commit_verify_window_on_card_leaves_rejected_blocks():
    """``commit_verify_window`` on the card writes the committed columns'
    K/V and leaves every other position of every real block
    bit-identical; a window running past its table goes to the trash."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cfg = configs.smoke("opt_30b")
    n_phys, block, W = 13, 4, 4
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cache = [{n: torch.randn((n_phys, block, cfg.n_kv, cfg.head_dim),
                             generator=gen, device=dev).to(torch.bfloat16)
              for n in ("k", "v")} for _ in range(cfg.n_layers)]
    fresh = [{n: torch.randn((3, W, cfg.n_kv, cfg.head_dim), generator=gen,
                             device=dev).to(torch.bfloat16)
              for n in ("k", "v")} for _ in range(cfg.n_layers)]
    before = [{n: t.clone() for n, t in layer.items()} for layer in cache]
    tables = (1 + torch.arange(12, device=dev)).reshape(3, 4)
    pos = torch.tensor([5, 2, 13], device=dev)
    commit = torch.tensor([[1, 1, 1, 1], [1, 1, 0, 0], [1, 1, 1, 1]],
                          dtype=torch.bool, device=dev)
    transformer.commit_verify_window(cfg, cache, fresh, tables, pos, commit)
    torch.cuda.synchronize()
    keep = torch.ones((n_phys, block), dtype=torch.bool)
    keep[0] = False
    for b in range(3):
        for j in range(W):
            p = int(pos[b]) + j
            if commit[b, j] and p // block < 4:
                phys, off = int(tables[b, p // block]), p % block
                keep[phys, off] = False
                for layer, fr in zip(cache, fresh):
                    for n in ("k", "v"):
                        assert torch.equal(layer[n][phys, off], fr[n][b, j])
    assert int((~keep[1:]).sum()) == 4 + 2 + 3      # slot 2: 13..15 only
    keep = keep.to(dev)
    for layer, old in zip(cache, before):
        for n in ("k", "v"):
            assert torch.equal(layer[n][keep], old[n][keep])


# ---------------------------------------------------------------------------
# the schedule autotune and the layer-by-layer build, on the card
# ---------------------------------------------------------------------------

def test_serve_step_takes_a_0d_position(cuda):
    """A 0-d position tensor is broadcast to every row of the batch."""
    cfg = configs.smoke("opt_30b")
    params, _ = serve.build(cfg, seed=0, sparsity=0.8, device=cuda)
    prompts = serve.make_prompts(cfg, 3, 8, 0, cuda)
    with torch.inference_mode():
        outs = []
        for pos in (torch.tensor(8, device=cuda), 8):
            _, cache = engine.prefill(params, prompts, cfg, 10)
            logits, _ = engine.serve_step(params, cache, prompts[:, :1], pos,
                                          cfg)
            outs.append(logits)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("grouped", [False, True])
def test_autotune_cuda_persists_a_winner_select_finds(cuda, tmp_path,
                                                      grouped):
    """``autotune`` times the CUDA kernels (CUDA events) over the contract
    -valid candidates, persists the fastest under the ``cuda`` key, and
    ``select`` (so ``ops``) returns it; the tuned launch matches the
    plain version."""
    ts, gen = _weights(cuda, 3 if grouped else 1, 128, 128)
    t = tiled_csl.group_stack(ts) if grouped else ts[0]
    cache = schedule.ScheduleCache(str(tmp_path / "tuned.json"))
    best, timings = schedule.autotune(t, 16, cache=cache, reps=3)
    assert best == min(timings, key=timings.get)
    assert all(not contracts.check_launch(
        256, 384, 16, m_tb=128, k_tb=128, n_tb=s.n_tb, split_k=s.split_k,
        group=t.group or 1, max_nnz=t.max_nnz) for s in timings)
    assert len(schedule.ScheduleCache(cache.path)) == 1
    got = schedule.select(256, 384, 16, m_tb=128, k_tb=128,
                          max_nnz=t.max_nnz, group=t.group or 1,
                          cache=cache)
    assert got == best
    b = (0.1 * torch.randn((384, 16), generator=gen, device=cuda)).to(
        torch.bfloat16)
    run = ops.spmm_grouped if grouped else ops.spmm
    plain = ref.spmm_grouped_ref if grouped else ref.spmm_ref
    _assert_close(run(t, b, backend="cuda", n_tb=best.n_tb,
                      split_k=best.split_k), plain(t, b, out_dtype=b.dtype))


def _layer_f32_bytes(cfg) -> int:
    d, f = cfg.d_model, cfg.d_ff
    return 4 * (4 * d * d + 2 * d * f)


def test_layered_build_bit_equal_at_full_width(cuda):
    """Two OPT-30B layers at full width: the layer-by-layer build equals
    ``init_model`` + ``sparsify_params`` + ``group_projections`` on the
    card, word for word."""
    cfg = dataclasses.replace(configs.get("opt_30b"), n_layers=2)
    got, _ = serve.build(cfg, seed=5, sparsity=0.8, device=cuda)
    want = transformer.init_model(cfg, seed=5, device=cuda)
    want = pruning.group_projections(pruning.sparsify_params(
        want, 0.8,
        should_sparsify=lambda n: any(k in n for k in serve.SPARSE_NAMES)))
    for a, b in zip(want["layers"], got["layers"]):
        for part, leaf in (("attn", "wqkv"), ("attn", "wo"), ("mlp", "up"),
                           ("mlp", "down")):
            ta, tb = a[part][leaf]["w"], b[part][leaf]["w"]
            assert torch.equal(ta.words, tb.words)
            assert torch.equal(ta.nnz, tb.nnz)
    assert torch.equal(want["embed"]["table"].to(torch.bfloat16),
                       got["embed"]["table"])


def test_layered_build_peak_memory_at_12_layers(cuda):
    """Twelve OPT-30B-width layers: the build's peak allocated bytes stay
    below the encoded model plus two layers' f32 weights (a whole-tree
    build would hold all twelve in f32, 29.6 GB)."""
    cfg = dataclasses.replace(configs.get("opt_30b"), n_layers=12)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    params, rep = serve.build(cfg, seed=0, sparsity=0.8, device=cuda)
    peak = torch.cuda.max_memory_allocated(cuda) - base
    assert rep["max_memory_allocated"] - base == peak
    assert peak <= rep["weight_bytes"] + 2 * _layer_f32_bytes(cfg), (
        peak, rep["weight_bytes"])
    assert rep["n_tiled_csl"] == 12 * 4
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (minicpm3) on the card
# ---------------------------------------------------------------------------

# Every MLA factor in Tiled-CSL as well as the launchers' list: the
# reference's default_should_sparsify, lm_head aside.
MLA_SPARSE = serve.SPARSE_NAMES + ("'w_dq'", "'w_uq'", "'w_dkv'", "'w_ukv'")
LAYER_TOL = dict(rtol=3e-2, atol=3e-2)   # one bf16 layer, kernels vs plain


def _all_factors_csl(params):
    return pruning.group_projections(pruning.sparsify_params(
        params, 0.8, should_sparsify=lambda n: any(k in n
                                                   for k in MLA_SPARSE)))


def test_mla_layer_all_factors_csl_matches_plain_at_full_width(cuda):
    """One minicpm3 layer at full width with every factor (and the MLP) in
    Tiled-CSL: prefill (N = 512), decode at a 0-d and at per-slot
    positions (N = 8), paged decode and a W = 4 verify window (N = 32)
    through the kernels against the same layer on the plain versions;
    each of the four LSCD kernels launches."""
    cfg = dataclasses.replace(configs.get("minicpm3_4b"), n_layers=1)
    params = _all_factors_csl(transformer.init_model(cfg, seed=0,
                                                     device=cuda))
    layer = params["layers"][0]
    for n in ("w_dq", "w_uq", "w_dkv", "w_ukv", "wo"):
        assert isinstance(layer["attn"][n]["w"], tiled_csl.TiledCSL)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    B, S, blk = 8, 64, 16

    def x_of(*shape):
        return torch.randn(shape + (cfg.d_model,), generator=gen,
                           device=cuda).to(torch.bfloat16)

    def both(mode, x, **kw):
        outs = []
        for backend in ("cuda", "torch"):
            cache = kw.get("cache")
            if cache is not None:
                kw["cache"] = {n: t.clone() for n, t in cache.items()}
            y, out = transformer.block_apply(layer, x, cfg, mode=mode,
                                             backend=backend, **kw)
            outs.append((y, out))
        _assert_layer_close(outs[0][0], outs[1][0])
        return outs[1][1]

    spmm.reset_launch_counts()
    positions = torch.arange(S, device=cuda)[None].expand(B, S)
    with torch.inference_mode():
        cache = both("prefill", x_of(B, S), positions=positions,
                     cache=transformer.init_cache(cfg, B, 2 * S,
                                                  device=cuda)[0])
        both("decode", x_of(B, 1), cache=cache,
             pos=torch.tensor(S, device=cuda))
        per_slot = torch.arange(B, device=cuda) + S - B
        both("decode", x_of(B, 1), cache=cache, pos=per_slot)
        nblk = 2 * S // blk
        pool = {n: torch.cat([torch.zeros_like(t[:1, :blk]),
                              t.reshape(B * nblk, blk, t.shape[-1])])
                for n, t in cache.items()}
        tables = 1 + torch.arange(B * nblk, device=cuda).reshape(B, nblk)
        both("decode", x_of(B, 1), cache=pool, pos=per_slot,
             block_tables=tables)
        both("verify", x_of(B, 4), cache=pool, pos=per_slot,
             block_tables=tables)
    counts = spmm.launch_counts()
    assert all(counts[k] > 0 for k in spmm.WEIGHT_KERNELS), counts


def _assert_layer_close(got, want):
    torch.testing.assert_close(got.float(), want.float(), **LAYER_TOL)


def _mla_smoke(dev):
    cfg = configs.smoke("minicpm3_4b")
    return _all_factors_csl(transformer.init_model(cfg, seed=0,
                                                   device=dev)), cfg


@pytest.mark.parametrize("paged", [False, True])
def test_mla_graphed_decode_equals_eager(cuda, paged):
    """A minicpm3 smoke model with every factor Tiled-CSL (``w_ukv``
    decoded inside the captured step): six graphed decode steps give the
    eager steps' tokens and leave bit-identical latent caches."""
    (graphed, eager), first, lens, tables = _stepper_pair(
        cuda, paged, params_cfg=_mla_smoke(cuda))
    toks = {id(graphed): first, id(eager): first}
    for i in range(6):
        for st in (graphed, eager):
            tok, ok = st.decode(toks[id(st)], lens + i, tables,
                                np.arange(4), np.full(4, i + 1))
            assert ok.all()
            toks[id(st)] = tok
        assert np.array_equal(toks[id(graphed)], toks[id(eager)])
    for a, b in zip(graphed.cache, eager.cache):
        assert sorted(a) == ["ckv", "krope"]
        for name in a:
            assert torch.equal(a[name], b[name])
    assert graphed.captures["decode"] == 1


def test_mla_graphed_verify_equals_eager(cuda):
    """Verify windows over the paged latent pool (drafts of 3, 2, 1 and 0
    tokens): the replayed graph gives the eager step's tokens and accept
    counts and leaves bit-identical real blocks."""
    (graphed, eager), first, lens, tables = _stepper_pair(
        cuda, True, params_cfg=_mla_smoke(cuda), spec_k=3)
    vocab = graphed.cfg.vocab
    rng = np.random.default_rng(1)
    uids, pos, last = np.arange(4), lens.copy(), first
    for i in range(3):
        tokens = np.concatenate(
            [last[:, None], rng.integers(0, vocab, (4, 3))], axis=1)
        dl = np.array([3, 2, 1, 0])
        outs = [st.verify(tokens, pos, tables, dl, uids, np.full(4, i))
                for st in (graphed, eager)]
        assert np.array_equal(outs[0][0], outs[1][0])
        assert np.array_equal(outs[0][1], outs[1][1])
        tgt, n_acc = outs[0]
        last, pos = tgt[np.arange(4), n_acc], pos + n_acc + 1
    for a, b in zip(_paged_leaves(graphed), _paged_leaves(eager)):
        assert torch.equal(a, b)
    assert graphed.captures["verify"] == 1


@pytest.mark.parametrize("window", [None, 8])
def test_hybrid_graphed_decode_equals_eager(cuda, window):
    """A recurrentgemma smoke model (MLP and attention Tiled-CSL), its own
    32-position window or an 8-position one that the decode wraps: six
    graphed decode steps give the eager steps' tokens and leave
    bit-identical caches, the RG-LRU state advanced once a step."""
    cfg = configs.smoke("recurrentgemma_9b")
    if window:
        cfg = dataclasses.replace(cfg, local_window=window)
    params, _ = serve.build(cfg, seed=0, sparsity=0.8, device=cuda)
    (graphed, eager), first, lens, tables = _stepper_pair(
        cuda, False, params_cfg=(params, cfg))
    toks = {id(graphed): first, id(eager): first}
    for i in range(6):
        for st in (graphed, eager):
            tok, ok = st.decode(toks[id(st)], lens + i, tables,
                                np.arange(4), np.full(4, i + 1))
            assert ok.all()
            toks[id(st)] = tok
        assert np.array_equal(toks[id(graphed)], toks[id(eager)])
    for a, b in zip(graphed.cache, eager.cache):
        assert sorted(a) == sorted(b)
        for name in a:
            assert torch.equal(a[name], b[name]), name
    assert graphed.captures["decode"] == 1


@pytest.mark.parametrize("paged", [False, True])
def test_moe_graphed_decode_equals_eager(cuda, paged):
    """A qwen3-moe smoke model with its expert stacks, attention and no
    router in Tiled-CSL, capacity factor 1.0 (tokens dropped): six
    graphed decode steps give the eager steps' tokens and caches, and a
    replay launches the batched kernels."""
    cfg = dataclasses.replace(configs.smoke("qwen3_moe_30b_a3b"),
                              capacity_factor=1.0)
    params, _ = serve.build(cfg, seed=0, sparsity=0.8, device=cuda)
    assert params["layers"][0]["moe"]["gate"].stack
    (graphed, eager), first, lens, tables = _stepper_pair(
        cuda, paged, params_cfg=(params, cfg))
    toks = {id(graphed): first, id(eager): first}
    for i in range(6):
        for st in (graphed, eager):
            tok, ok = st.decode(toks[id(st)], lens + i, tables,
                                np.arange(4), np.full(4, i + 1))
            assert ok.all()
            toks[id(st)] = tok
        assert np.array_equal(toks[id(graphed)], toks[id(eager)])
    for a, b in zip(graphed.cache, eager.cache):
        for name in ("k", "v"):
            assert torch.equal(a[name], b[name])
    per = graphed.graph_launches
    assert any(per.get(k, 0) for k in spmm.BATCHED_KERNELS), per


# ---------------------------------------------------------------------------
# the SSM, vlm and audio families
# ---------------------------------------------------------------------------

def test_ssm_graphed_decode_equals_eager(cuda):
    """A mamba2 smoke model: six graphed decode steps give the eager
    steps' tokens and leave bit-identical state and conv leaves, the
    state advanced once a step (the capture's warm-up restores it)."""
    cfg = configs.smoke("mamba2_130m")
    params, _ = serve.build(cfg, seed=0, sparsity=0.8, device=cuda)
    (graphed, eager), first, lens, tables = _stepper_pair(
        cuda, False, params_cfg=(params, cfg))
    toks = {id(graphed): first, id(eager): first}
    for i in range(6):
        for st in (graphed, eager):
            tok, ok = st.decode(toks[id(st)], lens + i, tables,
                                np.arange(4), np.full(4, i + 1))
            assert ok.all()
            toks[id(st)] = tok
        assert np.array_equal(toks[id(graphed)], toks[id(eager)])
    for a, b in zip(graphed.cache, eager.cache):
        assert sorted(a) == ["conv", "state"]
        for name in a:
            assert torch.equal(a[name], b[name]), name
    assert graphed.captures["decode"] == 1


@pytest.mark.parametrize("L", [1, 255, 256, 257])
def test_ssm_full_width_prefill_equals_token_by_token(cuda, L):
    """One mamba2-130m block at full width in f32 on the card: the chunked
    prefill's final state and conv cache equal the same input fed token
    by token through ``ssm_decode``, within 1e-4 relative."""
    from repro_torch.models import ssm
    cfg = dataclasses.replace(configs.get("mamba2_130m"), n_layers=1,
                              dtype="float32")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    p = ssm.init_ssm(gen, cfg, cuda)
    x = torch.randn((2, L, cfg.d_model), generator=gen, device=cuda)
    _, whole = ssm.ssm_block(p, x, cfg, cache=ssm.init_ssm_cache(cfg, 2, cuda))
    steps = ssm.init_ssm_cache(cfg, 2, cuda)
    for t in range(L):
        _, steps = ssm.ssm_decode(p, x[:, t:t + 1], steps, cfg)
    for name in ("state", "conv"):
        torch.testing.assert_close(whole[name], steps[name], rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2_vl_2b", "musicgen_large"])
def test_one_full_width_layer_matches_plain(cuda, arch):
    """One layer of qwen2-vl-2b (M-RoPE, GQA with bias, SwiGLU) and of
    musicgen-large (MHA, LayerNorm, GELU with biases, 4 codebooks) at
    full width, Tiled-CSL at 0.8: prefill (8 x 64 positions) and one
    decode step (N = 8) through the kernels, which must launch an
    ungrouped and a grouped LSCD kernel, against the plain versions
    (bf16, 3e-2)."""
    cfg = dataclasses.replace(configs.get(arch), n_layers=1)
    params, _ = serve.build(cfg, seed=0, sparsity=0.8, device=cuda)
    prompts = serve.make_prompts(cfg, 8, 64, 0, cuda)
    before = spmm.launch_counts()
    out = {}
    for backend in ("cuda", "torch"):
        last, cache = engine.prefill(params, prompts, cfg, 66,
                                     backend=backend)
        tok = torch.argmax(last, dim=-1)[..., None]
        step, _ = engine.serve_step(params, cache, tok, 64, cfg,
                                    backend=backend)
        out[backend] = (last.float(), step.float())
    ran = {k: n - before[k] for k, n in spmm.launch_counts().items()}
    # select splits or not by shape, so which of each pair runs varies
    assert ran["lscd_spmm"] + ran["lscd_spmm_splitk"] > 0, ran
    assert ran["lscd_spmm_grouped"] + ran["lscd_spmm_splitk_grouped"] > 0, ran
    for got, want in zip(out["cuda"], out["torch"]):
        torch.testing.assert_close(got, want, rtol=3e-2, atol=3e-2)


# ---------------------------------------------------------------------------
# training, checkpoints and the kernel profiler on the card
# ---------------------------------------------------------------------------

def test_train_step_on_card_matches_cpu(cuda):
    """One f32 step of tinyllama smoke (TF32 off) on the card against the
    CPU from the same params and batch: loss within 1e-5 relative, each
    gradient leaf within one bf16 ulp (2^-8) of its largest value, since
    both round attention's K/V (and their cotangents) to bf16."""
    from repro_torch.training import data, optimizer, train_loop
    cfg = dataclasses.replace(configs.smoke("tinyllama_1_1b"),
                              dtype="float32")
    params = transformer.init_model(cfg, seed=0, device="cpu")
    card = optimizer.tree_map(lambda t: t.to(cuda), params)
    batch = data.SyntheticLM(cfg.vocab, 33, 4, seed=0).next_batch()
    want = train_loop.value_and_grad(params, train_loop.batch_to(batch,
                                                                 "cpu"), cfg)
    got = train_loop.value_and_grad(card, train_loop.batch_to(batch, cuda),
                                    cfg)
    assert abs(float(got[0]) - float(want[0])) <= 1e-5 * abs(float(want[0]))
    flat = dict(_flat(want[2]))
    for path, g in _flat(got[2]):
        w = flat[path]
        assert float((g.cpu() - w).abs().max()) <= \
            2.0 ** -8 * float(w.abs().max()), path


def _flat(tree):
    from repro_torch.distributed import fault_tolerance as ft
    return ft.flatten_with_paths(tree)


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    from repro_torch.distributed import fault_tolerance as ft
    tree = {"w": torch.randn(64, 32, device=cuda),
            "h": torch.randn(16, device=cuda).to(torch.bfloat16),
            "n": [torch.arange(5, device=cuda, dtype=torch.int32)]}
    mgr = ft.CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, tree)
    mgr.wait()
    got, meta = mgr.restore({k: (v if k != "n" else [torch.zeros_like(
        v[0])]) for k, v in tree.items()}, device=cuda)
    assert meta["step"] == 1
    for (p, a), (_, b) in zip(_flat(got), _flat(tree)):
        assert a.device.type == "cuda" and a.dtype == b.dtype, p
        assert torch.equal(a, b), p


def test_profiler_times_card_launches_with_cuda_events(cuda):
    from repro_torch.obs import profile as obs_profile
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    t = pruning.sparsify_matrix(torch.randn(512, 1024, generator=gen,
                                            device=cuda), 0.8)
    b = torch.randn(1024, 8, generator=gen, device=cuda).to(torch.bfloat16)
    before = spmm.launch_counts()
    with obs_profile.profiled(obs_profile.KernelProfiler()) as prof:
        ops.spmm(t, b)
    ran = {k: n - before[k] for k, n in spmm.launch_counts().items()}
    assert sum(ran.values()) >= 1
    rows = prof.measure(reps=3)
    assert len(rows) == 1 and rows[0]["backend"] == "cuda"
    assert rows[0]["timing"] == "cuda_events" and rows[0]["measured_us"] > 0


def test_trained_checkpoint_served_on_card_keeps_its_masks(cuda, tmp_path):
    from repro_torch.launch import train as train_launch
    d = str(tmp_path / "ck")
    out = train_launch.main(["--arch", "tinyllama_1_1b", "--smoke",
                             "--steps", "2", "--batch", "2", "--seq", "16",
                             "--sparsity", "0.8", "--ckpt-dir", d],
                            device=cuda)
    counts = train_launch.mask_counts(out["masks"])
    rep = serve.main(["--arch", "tinyllama_1_1b", "--smoke", "--ckpt", d,
                      "--sparsity", "0.8", "--requests", "2", "--slots", "2",
                      "--max-new", "3", "--profile-kernels"], device=cuda)
    wo = rep["server"].batcher.params["layers"][0]["attn"]["wo"]["w"]
    assert int(wo.nnz.sum()) == counts["['layers'][0]['attn']['wo']['w']"]
    rows = rep["drift"]["rows"]
    assert rows and all(r["timing"] == "cuda_events" for r in rows)


def test_mesh_1x2_decode_step_matches_unsharded_at_full_width(cuda):
    """Two ranks sharing the card over gloo (``launch.mesh.run_world``)
    serve a 2-layer OPT-30B at full width, tensor-parallel over a 1x2
    mesh at sparsity 0.8 (every projection's LSCD launch on its shard):
    the first decode step's logits match the unsharded model's within
    the bf16 model-logits tolerance (3e-2, ``chip_smoke.LOGITS_TOL``)."""
    import torch_mesh_worlds
    from repro_torch.launch import mesh as mesh_mod
    cfg = dataclasses.replace(configs.get("opt_30b"), n_layers=2)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (4, 16))
    params, _ = serve.build(cfg, sparsity=0.8, device=cuda)
    p = torch.from_numpy(prompt).long().to(cuda)
    with torch.inference_mode():
        last, cache = engine.prefill(params, p, cfg, 17)
        tok = torch.argmax(last, -1)[:, None]
        want, _ = engine.serve_step(params, cache, tok, 16, cfg)
    want = want.float().cpu().numpy()
    del params, cache
    torch.cuda.empty_cache()
    got = mesh_mod.run_world(torch_mesh_worlds.decode_step_logits, (1, 2),
                             device="cuda",
                             args=("opt_30b", 2, 0.8, prompt))
    for g in got:
        np.testing.assert_array_equal(g, got[0])
    np.testing.assert_allclose(got[0], want, rtol=3e-2, atol=3e-2)


def test_mesh_1x2_sequence_sharded_decode_at_full_width(cuda):
    """Two ranks sharing the card over gloo serve a 2-layer tinyllama at
    full width and sparsity 0.8 on a 1x2 mesh with a cache of 64
    positions, laid out by ``cache_shardings`` with the sequence over
    ``model`` (two blocks of 32; the 40-token prompt crosses into the
    second): the first decode step, whose partial softmaxes combine over
    the ranks, matches the unsharded model's logits within the bf16
    model-logits tolerance (3e-2)."""
    import torch_mesh_worlds
    from repro_torch.launch import mesh as mesh_mod
    cfg = dataclasses.replace(configs.get("tinyllama_1_1b"), n_layers=2)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (4, 40))
    params, _ = serve.build(cfg, sparsity=0.8, device=cuda)
    p = torch.from_numpy(prompt).long().to(cuda)
    with torch.inference_mode():
        last, cache = engine.prefill(params, p, cfg, 64)
        tok = torch.argmax(last, -1)[:, None]
        want, _ = engine.serve_step(params, cache, tok, 40, cfg)
    want = want.float().cpu().numpy()
    del params, cache
    torch.cuda.empty_cache()
    got = mesh_mod.run_world(torch_mesh_worlds.decode_step_logits, (1, 2),
                             device="cuda",
                             args=("tinyllama_1_1b", 2, 0.8, prompt, 64,
                                   True))
    for logits, seq in got:
        assert seq == "model"
        np.testing.assert_array_equal(logits, got[0][0])
    np.testing.assert_allclose(got[0][0], want, rtol=3e-2, atol=3e-2)


def test_mesh_1x2_mla_decode_step_matches_unsharded_at_full_width(cuda):
    """Two ranks sharing the card over gloo serve a 2-layer minicpm3 at
    full width and sparsity 0.8 on a 1x2 mesh: its 40 heads split over
    ``model``, the latents whole on each rank, ``wo`` and the MLP in
    Tiled-CSL launched on each rank's shard (the MLP's 50-tile leaves
    whole, as the rule leaves them): the first decode step matches the
    unsharded model's logits within the bf16 model-logits tolerance
    (3e-2)."""
    import torch_mesh_worlds
    from repro_torch.launch import mesh as mesh_mod
    cfg = dataclasses.replace(configs.get("minicpm3_4b"), n_layers=2)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, (4, 16))
    params, _ = serve.build(cfg, sparsity=0.8, device=cuda)
    p = torch.from_numpy(prompt).long().to(cuda)
    with torch.inference_mode():
        last, cache = engine.prefill(params, p, cfg, 18)
        tok = torch.argmax(last, -1)[:, None]
        want, _ = engine.serve_step(params, cache, tok, 16, cfg)
    want = want.float().cpu().numpy()
    del params, cache
    torch.cuda.empty_cache()
    got = mesh_mod.run_world(torch_mesh_worlds.decode_step_logits, (1, 2),
                             device="cuda",
                             args=("minicpm3_4b", 2, 0.8, prompt, 18))
    for g in got:
        np.testing.assert_array_equal(g, got[0])
    np.testing.assert_allclose(got[0], want, rtol=3e-2, atol=3e-2)


def test_dry_run_allocates_nothing_on_the_card(cuda):
    """The dry run of that cell (1x2, 64 positions, four rows) and of
    tinyllama's decode_32k on the 16x16 production mesh runs on meta
    tensors: the card's allocated memory is the same before and after,
    and the cell's per-rank cache bytes are the layout's."""
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.config import ShapeConfig
    cfg = dataclasses.replace(configs.get("tinyllama_1_1b"), n_layers=2)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    mesh = mesh_mod.DryMesh((1, 2), ("data", "model"))
    cell = specs.build_cell(cfg, ShapeConfig("d", "decode", 64, 4), mesh,
                            weight_mode="sparse_xla")
    ran = dryrun.execute(cell, mesh, train=False)
    rec = dryrun.run_cell("tinyllama_1_1b", "decode_32k", multi_pod=False,
                          mesh=mesh_mod.make_production_mesh())
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
    assert ran["lscd"] and rec["status"] == "ok"
    # 2 layers x K and V x [4 rows, 32 positions, 4 KV heads, 64] bf16
    assert cell.arg_bytes()["cache"] == 2 * 2 * 4 * 32 * 4 * 64 * 2
