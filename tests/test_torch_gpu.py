"""The four LSCD CUDA kernels against their plain versions, on the card.

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
from repro_torch.kernels import ops, ref, spmm

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
