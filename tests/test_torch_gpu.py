"""The port's CUDA kernels against their plain versions, and the serving
stepper's decode step as a CUDA graph against its eager run, on the card.

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
# the serving stepper's decode step as a CUDA graph
# ---------------------------------------------------------------------------

def _stepper_pair(dev, paged, temperature=0.0):
    """Two steppers over one sparse smoke model (OPT-30B smoke, 0.8), one
    graphed and one eager, each with one prompt prefilled into every
    slot (dense) or every slot's own blocks (paged)."""
    cfg = configs.smoke("opt_30b")
    params, _ = serve.build(cfg, seed=0, sparsity=0.8, device=dev)
    n_slots, max_len, block = 4, 32, 8
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (n_slots, 8))
    lens = np.array([8, 5, 7, 3])
    kw = dict(n_slots=n_slots, max_len=max_len, temperature=temperature,
              top_k=8 if temperature else 0, seed=3)
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
    assert graphed._graph is None
    after = spmm.launch_counts()
    # only the eager warm-up's launches remain counted
    assert all(after[k] >= before[k] for k in spmm.KERNELS)
    torch.cuda.synchronize()


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
