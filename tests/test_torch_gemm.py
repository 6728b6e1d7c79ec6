"""The port's dense GEMM baseline against the reference, on the CPU.

Seeded numpy inputs go through ``repro.kernels.gemm.dense_gemm`` (the
Pallas kernel in interpret mode, as the JAX package's own tests run it)
and through ``repro_torch.kernels.gemm.dense_gemm`` with
``backend="torch"``, its plain version. Tolerance ``rtol=1e-5,
atol=1e-4``: both are f32 sums over K = 384, taken in different orders.
bf16 inputs are rounded once from the same f32 arrays on both sides, so
the products are exact and the tolerance stays that of the f32 sum. The
CUDA kernel itself is held against the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gemm as ref_gemm
from repro_torch.analysis import contracts
from repro_torch.core import pruning, tiled_csl
from repro_torch.kernels import gemm, ops

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-4)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _ab(seed, m=256, k=384, n=128):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k), dtype=np.float32),
            rng.standard_normal((k, n), dtype=np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dense_gemm_matches_reference(dtype):
    a, b = _ab(21)
    jdt, tdt = DTYPES[dtype]
    want = ref_gemm.dense_gemm(jnp.asarray(a, jdt), jnp.asarray(b, jdt),
                               interpret=True)
    got = gemm.dense_gemm(torch.from_numpy(a).to(tdt),
                          torch.from_numpy(b).to(tdt), backend="torch")
    assert got.dtype == torch.float32 and got.shape == (256, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dense_gemm_bf16_out_matches_reference():
    a, b = _ab(23)
    want = ref_gemm.dense_gemm(jnp.asarray(a, jnp.bfloat16),
                               jnp.asarray(b, jnp.bfloat16),
                               out_dtype=jnp.bfloat16, interpret=True)
    got = gemm.dense_gemm(torch.from_numpy(a).to(torch.bfloat16),
                          torch.from_numpy(b).to(torch.bfloat16),
                          out_dtype=torch.bfloat16, backend="torch")
    assert got.dtype == torch.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    g = got.float().numpy()
    # One bf16 ulp where the two f32 sums round to neighbouring values.
    assert np.all(np.abs(g - w) <= np.abs(w) * 2.0 ** -7 + 1e-30)


@pytest.mark.parametrize("geom", [(128, 128, 128), (64, 128, 64),
                                  (128, 64, 128)])
def test_dense_gemm_geometries_match_reference(geom):
    m_tb, k_tb, n_tb = geom
    a, b = _ab(24 + m_tb + k_tb)
    want = ref_gemm.dense_gemm(jnp.asarray(a), jnp.asarray(b), m_tb=m_tb,
                               k_tb=k_tb, n_tb=n_tb, interpret=True)
    got = gemm.dense_gemm(torch.from_numpy(a), torch.from_numpy(b),
                          m_tb=m_tb, k_tb=k_tb, n_tb=n_tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("geom,dtype", [((128, 128, 256), "bf16"),
                                        ((64, 64, 256), "bf16"),
                                        ((64, 128, 256), "f32")])
def test_dense_gemm_n256_matches_reference(geom, dtype):
    """The 256-column tile of the Hopper kernel, as the JAX kernel takes
    any n_tb that divides N."""
    m_tb, k_tb, n_tb = geom
    a, b = _ab(31 + m_tb, n=512)
    jdt, tdt = DTYPES[dtype]
    want = ref_gemm.dense_gemm(jnp.asarray(a, jdt), jnp.asarray(b, jdt),
                               m_tb=m_tb, k_tb=k_tb, n_tb=n_tb,
                               interpret=True)
    got = gemm.dense_gemm(torch.from_numpy(a).to(tdt),
                          torch.from_numpy(b).to(tdt), m_tb=m_tb, k_tb=k_tb,
                          n_tb=n_tb, backend="torch")
    assert got.shape == (256, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sparse_equals_dense_on_same_matrix():
    """LSCD SpMM and the dense baseline agree on one pruned matrix: the
    kernel-level comparison the paper's dense bars rest on."""
    rng = np.random.default_rng(22)
    w = torch.from_numpy(rng.standard_normal((256, 256), dtype=np.float32))
    t = tiled_csl.encode(pruning.prune(w, 0.8))
    b = torch.from_numpy(rng.standard_normal((256, 128), dtype=np.float32))
    dense = gemm.dense_gemm(tiled_csl.decode(t), b)
    sparse = ops.spmm(t, b, out_dtype=torch.float32)
    np.testing.assert_allclose(sparse.numpy(), dense.numpy(), **TOL)


@pytest.mark.parametrize("shape", [(200, 384, 128), (256, 300, 128),
                                   (256, 384, 100)])
def test_untiled_shapes_raise(shape):
    m, k, n = shape
    with pytest.raises(ValueError, match="not tile-aligned"):
        gemm.dense_gemm(torch.zeros(m, k), torch.zeros(k, n))


def test_mismatched_operands_raise():
    with pytest.raises(ValueError, match="do not chain"):
        gemm.dense_gemm(torch.zeros(128, 128), torch.zeros(256, 128))
    with pytest.raises(ValueError, match="share a dtype"):
        gemm.dense_gemm(torch.zeros(128, 128),
                        torch.zeros(128, 128, dtype=torch.bfloat16))


def test_raw_kernel_refuses_cpu_tensors_without_counting():
    gemm.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        gemm.dense_gemm_kernel(torch.zeros(128, 128), torch.zeros(128, 128))
    with pytest.raises(ValueError, match="CUDA"):
        gemm.dense_gemm(torch.zeros(128, 128), torch.zeros(128, 128),
                        backend="cuda")
    gemm.dense_gemm(torch.zeros(128, 128), torch.zeros(128, 128))
    assert gemm.launch_counts() == {"dense_gemm": 0}


def test_gemm_contract():
    assert not contracts.check_gemm(256, 384, 128, m_tb=128, k_tb=128,
                                    n_tb=128)
    assert contracts.check_gemm(256, 384, 128, m_tb=128, k_tb=128, n_tb=32)
    assert contracts.check_gemm(256, 384, 128, m_tb=256, k_tb=128, n_tb=128)
    for geom in [(m, k, n) for m in contracts.M_TB_OPTIONS
                 for k in contracts.K_TB_OPTIONS
                 for n in contracts.GEMM_N_TB_OPTIONS]:
        for dtype_bytes in (2, 4):
            assert contracts.gemm_smem_bytes(*geom, dtype_bytes) <= \
                contracts.SMEM_BYTES_PER_BLOCK


def test_dense_gemm_source_carries_its_note():
    text = (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
            / "dense_gemm.cu").read_text()
    text = re.sub(r"\s*\n//\s*", " ", text)
    assert "Replaces the TPU kernel repro/kernels/gemm.py:dense_gemm" in text
    assert "Bound on an H100" in text


def test_gemm_contract_n256():
    """128 x 256 x 64 stages: 16 KB of A and 32 KB of B, four of them with
    their two mbarriers each, beside 32 KB of epilogue staging; 128
    accumulators a consumer thread."""
    assert contracts.gemm_stages(128, 256) == 4
    assert contracts.gemm_smem_bytes(128, 128, 256) == (
        contracts.PIPE_SMEM_ALIGN + 32768 + 4 * (16384 + 32768 + 16))
    assert contracts.gemm_stages(128, 128) == 6
    assert contracts.gemm_acc_per_thread(128, 256) == 128 == \
        contracts.GEMM_MAX_ACC
    assert contracts.gemm_acc_per_thread(64, 256) == 64
    assert not contracts.check_gemm(256, 384, 512, m_tb=128, k_tb=128,
                                    n_tb=256)
    assert not contracts.check_gemm(256, 384, 512, m_tb=64, k_tb=64,
                                    n_tb=256, dtype_bytes=4)
    # the f32 CUDA-core tile would hold 128 accumulators a thread
    found = contracts.check_gemm(256, 384, 512, m_tb=128, k_tb=128,
                                 n_tb=256, dtype_bytes=4)
    assert found and "accumulators" in found[0]
    assert contracts.check_gemm(256, 384, 512, m_tb=128, k_tb=128, n_tb=512)
    assert contracts.check_gemm(256, 384, 384, m_tb=128, k_tb=128, n_tb=256)
    for m_tb in contracts.M_TB_OPTIONS:
        for n_tb in contracts.GEMM_N_TB_OPTIONS:
            assert contracts.gemm_stages(m_tb, n_tb) >= 4
            assert contracts.gemm_acc_per_thread(m_tb, n_tb) <= \
                contracts.GEMM_MAX_ACC


def test_dense_gemm_refuses_f32_n256_at_128_rows():
    a = torch.zeros(128, 128)
    with pytest.raises(ValueError, match="accumulators"):
        gemm.dense_gemm(a, torch.zeros(128, 256), n_tb=256)
    got = gemm.dense_gemm(a.to(torch.bfloat16),
                          torch.zeros(128, 256, dtype=torch.bfloat16),
                          n_tb=256)
    assert got.shape == (128, 256)
