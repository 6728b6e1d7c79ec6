"""The port's CUDA kernels against their plain versions, on the card.

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

import pytest
import torch

from repro_torch.core import pruning, tiled_csl
from repro_torch.analysis import contracts
from repro_torch.kernels import gemm, ops, ref, spmm

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


def test_dense_gemm_equals_spmm_on_same_matrix(cuda):
    (t,), gen = _weights(cuda, 1, 128, 128)
    b = (0.1 * torch.randn((384, 128), generator=gen,
                           device=cuda)).to(torch.bfloat16)
    dense = gemm.dense_gemm(tiled_csl.decode(t).to(torch.bfloat16), b,
                            out_dtype=torch.bfloat16)
    sparse = spmm.lscd_spmm(t, b, n_tb=128)
    _assert_close(sparse, dense)
