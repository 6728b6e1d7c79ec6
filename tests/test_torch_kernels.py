"""The port's plain SpMM versions and CPU ops against the reference.

Seeded numpy inputs go through ``repro.kernels.ref`` / ``repro.kernels.ops``
(``backend="xla"``) and through ``repro_torch.kernels.ref`` /
``repro_torch.kernels.ops`` on the CPU. Tolerance: f32 ``rtol=atol=1e-5``
(both are f32 matmuls, summed in different orders); a bf16 output may
differ by one bf16 ulp where an f32 sum lands near a rounding boundary.
The schedule and launch-contract checks are plain Python and run here too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tiled_csl as ref_csl
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.analysis import contracts
from repro_torch.core import tiled_csl
from repro_torch.kernels import ops, ref, schedule, spmm

UNARY = ["none", "silu", "gelu", "relu"]
TOL = dict(rtol=1e-5, atol=1e-5)
PAD = 4096


def _pair(rng, m=256, k=384, sparsity=0.8, groups=None, m_tb=128, k_tb=128):
    """(reference TiledCSL, port TiledCSL) of the same seeded matrices.

    One pad quantum for every test keeps the reference's array shapes, and
    so its compiled ops, the same across tests."""
    enc = dict(m_tb=m_tb, k_tb=k_tb, pad_quantum=PAD)
    def mat():
        a = rng.standard_normal((m, k)).astype(np.float32)
        a[rng.random((m, k)) < sparsity] = 0.0
        a[:m_tb, :k_tb] = 0.0                       # an empty tile
        return a
    if groups is None:
        a = mat()
        return (ref_csl.encode(a, **enc),
                tiled_csl.encode(torch.from_numpy(a), **enc))
    mats = [mat() for _ in range(groups)]
    return (ref_csl.encode_group(mats, **enc),
            tiled_csl.encode_group([torch.from_numpy(a) for a in mats], **enc))


def _inputs(rng, k, n, bias_shape):
    # B scaled so accumulators are O(1): products of binary epilogues then
    # stay on the scale the 1e-5 tolerance is stated for.
    b = (0.1 * rng.standard_normal((k, n))).astype(np.float32)
    bias = (rng.standard_normal(bias_shape).astype(np.float32)
            if bias_shape else None)
    return b, bias


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("n", [1, 7, 16])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("epilogue", UNARY)
def test_spmm_matches_reference(epilogue, with_bias, n):
    rng = np.random.default_rng(hash((epilogue, with_bias, n)) % 2 ** 31)
    rt, pt = _pair(rng)
    b, bias = _inputs(rng, 384, n, (256,) if with_bias else None)
    want = np.asarray(ref_ref.spmm_ref(rt, _j(b), epilogue=epilogue,
                                       bias=_j(bias)))
    got = ref.spmm_ref(pt, _t(b), epilogue=epilogue, bias=_t(bias))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want_ops = np.asarray(ref_ops.spmm(rt, _j(b), backend="xla",
                                       epilogue=epilogue, bias=_j(bias)))
    got_ops = ops.spmm(pt, _t(b), epilogue=epilogue, bias=_t(bias))
    assert got_ops.shape == (256, n)
    np.testing.assert_allclose(got_ops.numpy(), want_ops, **TOL)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("groups,epilogue", [(2, e) for e in UNARY]
                         + [(3, e) for e in UNARY]
                         + [(2, "silu_mul"), (2, "gelu_mul")])
def test_grouped_matches_reference(groups, epilogue, with_bias):
    rng = np.random.default_rng(hash((groups, epilogue, with_bias)) % 2 ** 31)
    rt, pt = _pair(rng, groups=groups)
    b, bias = _inputs(rng, 384, 7, (groups, 256) if with_bias else None)
    want = np.asarray(ref_ref.spmm_grouped_ref(rt, _j(b), epilogue=epilogue,
                                               bias=_j(bias)))
    got = ref.spmm_grouped_ref(pt, _t(b), epilogue=epilogue, bias=_t(bias))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want_ops = np.asarray(ref_ops.spmm_grouped(
        rt, _j(b), backend="xla", epilogue=epilogue, bias=_j(bias)))
    got_ops = ops.spmm_grouped(pt, _t(b), epilogue=epilogue, bias=_t(bias))
    np.testing.assert_allclose(got_ops.numpy(), want_ops, **TOL)


@pytest.mark.parametrize("n", [1, 7, 16])
@pytest.mark.parametrize("split_k", [1, 2, 3])
def test_splitk_matches_reference(split_k, n):
    """Kt = 3: S=2 leaves a ragged last slice, S=3 one tile per slice."""
    rng = np.random.default_rng(100 + 10 * split_k + n)
    rt, pt = _pair(rng)
    b, bias = _inputs(rng, 384, n, (256,))
    want = np.asarray(ref_ref.spmm_splitk_ref(rt, _j(b), split_k,
                                              epilogue="gelu", bias=_j(bias)))
    got = ref.spmm_splitk_ref(pt, _t(b), split_k, epilogue="gelu",
                              bias=_t(bias))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("split_k", [1, 2, 3])
@pytest.mark.parametrize("groups,epilogue", [(3, "none"), (2, "relu"),
                                             (2, "silu_mul"),
                                             (2, "gelu_mul")])
def test_splitk_grouped_matches_reference(groups, epilogue, split_k):
    rng = np.random.default_rng(hash((groups, epilogue, split_k)) % 2 ** 31)
    rt, pt = _pair(rng, groups=groups, m_tb=64)
    b, bias = _inputs(rng, 384, 16, (groups, 256))
    want = np.asarray(ref_ref.spmm_splitk_grouped_ref(
        rt, _j(b), split_k, epilogue=epilogue, bias=_j(bias)))
    got = ref.spmm_splitk_grouped_ref(pt, _t(b), split_k, epilogue=epilogue,
                                      bias=_t(bias))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("geom", [(64, 128), (128, 64)])
def test_tile_geometries_match_reference(geom):
    rng = np.random.default_rng(7 + geom[0])
    rt, pt = _pair(rng, m_tb=geom[0], k_tb=geom[1])
    b, bias = _inputs(rng, 384, 16, (256,))
    want = np.asarray(ref_ref.spmm_ref(rt, _j(b), epilogue="silu",
                                       bias=_j(bias)))
    got = ops.spmm(pt, _t(b), epilogue="silu", bias=_t(bias))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _bf16_ulp_close(got: torch.Tensor, want: np.ndarray):
    g = got.to(torch.float32).numpy()
    w = torch.from_numpy(want.copy()).to(torch.bfloat16).to(torch.float32).numpy()
    ulp = np.abs(w) * 2.0 ** -7 + 1e-30
    assert np.all(np.abs(g - w) <= ulp), np.max(np.abs(g - w) / ulp)


def test_bf16_output_within_one_ulp():
    rng = np.random.default_rng(11)
    rt, pt = _pair(rng, groups=2)
    b, bias = _inputs(rng, 384, 7, (2, 256))
    bb = torch.from_numpy(b).to(torch.bfloat16)
    want = np.asarray(ref_ref.spmm_grouped_ref(
        rt, jnp.asarray(bb.to(torch.float32).numpy()), epilogue="silu_mul",
        bias=_j(bias)))
    got = ops.spmm_grouped(pt, bb, epilogue="silu_mul", bias=_t(bias))
    assert got.dtype == torch.bfloat16
    _bf16_ulp_close(got, want)


def test_epilogue_registry():
    assert spmm.epilogue_kind("gelu") == "unary"
    assert spmm.epilogue_kind("silu_mul", groups=2) == "binary"
    with pytest.raises(ValueError, match="exactly 2"):
        spmm.epilogue_kind("silu_mul", groups=3)
    with pytest.raises(ValueError, match="unknown epilogue"):
        spmm.epilogue_kind("swish")
    x = torch.linspace(-4, 4, 17)
    np.testing.assert_allclose(
        spmm.apply_epilogue("gelu", x).numpy(),
        np.asarray(jnp.asarray(x.numpy()) * 0.5 * (1 + jnp.tanh(
            0.7978845608028654 * (jnp.asarray(x.numpy())
                                  + 0.044715 * jnp.asarray(x.numpy()) ** 3)))),
        rtol=1e-6, atol=1e-6)
    assert set(spmm.EPILOGUE_CODES) == set(spmm._EPILOGUES) | set(
        spmm._BINARY_EPILOGUES)


def test_spmm_diff_grads():
    rng = np.random.default_rng(5)
    _, pt = _pair(rng)
    b = torch.from_numpy(rng.standard_normal((384, 4)).astype(np.float32))
    b.requires_grad_(True)
    bias = torch.zeros(256, requires_grad=True)
    y = ops.spmm_diff(pt, b, bias=bias)
    g = torch.from_numpy(rng.standard_normal((256, 4)).astype(np.float32))
    y.backward(g)
    a = tiled_csl.decode(pt)
    np.testing.assert_allclose(b.grad.numpy(), (a.T @ g).numpy(), **TOL)
    np.testing.assert_allclose(bias.grad.numpy(), g.sum(1).numpy(), **TOL)
    with pytest.raises(ValueError, match="fused"):
        ops.spmm_diff(pt, b, epilogue="gelu")


def test_unknown_backend_raises():
    _, pt = _pair(np.random.default_rng(0))
    with pytest.raises(ValueError, match="unknown backend"):
        ops.spmm(pt, torch.zeros(384, 2), backend="xla")


# ---- schedule and launch contracts (plain Python) -------------------------

OPT = {"wqkv": (7168, 7168, 3), "wo": (7168, 7168, 1),
       "up": (28672, 7168, 1), "down": (7168, 28672, 1)}


# The split the cost model picks at N = 8: the fastest of S in {1, 2, 4,
# 8, 16} on an H100, or within 5% of it (up: S = 4 measured 2% faster).
DECODE_SPLIT = {"wqkv": 8, "wo": 16, "up": 8, "down": 16}


@pytest.mark.parametrize("name", sorted(OPT))
def test_schedule_decode_splits_prefill_does_not(name):
    m, k, g = OPT[name]
    mnz = 3456                         # 0.8 sparsity, padded per tile
    dec = schedule.select(m, k, 8, m_tb=128, k_tb=128, max_nnz=mnz, group=g)
    pre = schedule.select(m, k, 1024, m_tb=128, k_tb=128, max_nnz=mnz,
                          group=g)
    assert dec.split_k == DECODE_SPLIT[name] and dec.n_tb == 8
    assert pre.split_k == 1
    for s in (dec, pre):
        assert not contracts.check_launch(m, k, 8, m_tb=s.m_tb, k_tb=s.k_tb,
                                          n_tb=s.n_tb, split_k=s.split_k,
                                          group=g)


def test_launch_contract_rules():
    ok = dict(m_tb=128, k_tb=128, n_tb=128, split_k=1)
    assert not contracts.check_launch(256, 256, 128, group=1, **ok)
    assert contracts.check_launch(256, 256, 128, group=3, b_dtype_bytes=4,
                                  **ok)                           # registers
    assert contracts.check_launch(256, 256, 8, m_tb=128, k_tb=128, n_tb=24,
                                  split_k=1)
    assert contracts.check_launch(256, 256, 8, m_tb=128, k_tb=128, n_tb=8,
                                  split_k=3)                      # > Kt
    assert contracts.check_launch(256, 1024, 8, m_tb=256, k_tb=256, n_tb=8,
                                  split_k=1)                      # KC-LOC
    assert contracts.smem_bytes(128, 128, 128) <= \
        contracts.SMEM_BYTES_PER_BLOCK
    with pytest.raises(contracts.ScheduleContractError):
        schedule.select(256, 256, 8, m_tb=128, k_tb=128, max_nnz=3456, n_tb=8,
                        split_k=5)


def test_pipelined_body_contract():
    """bf16 with n_tb >= 64 runs the pipelined body: one weight per block
    (G=3 at 128x128 fits), the binary pair in one block (only up to 64
    accumulators per thread), a bounded live-step list."""
    ok = dict(m_tb=128, k_tb=128, split_k=1)
    assert contracts.pipelined(64) and contracts.pipelined(128)
    assert not contracts.pipelined(32)
    assert not contracts.pipelined(128, b_dtype_bytes=4)
    assert not contracts.check_launch(256, 256, 128, n_tb=128, group=3, **ok)
    assert contracts.check_launch(256, 256, 128, n_tb=128, group=2,
                                  binary=True, **ok)
    assert not contracts.check_launch(256, 256, 128, n_tb=64, group=2,
                                      binary=True, **ok)
    assert not contracts.check_launch(256, 256, 128, n_tb=32, group=3,
                                      **ok)                  # first body
    assert contracts.check_launch(256, 256, 128, n_tb=128, group=3,
                                  binary=True, **ok)
    # Kt = 2049 single-pass steps overflow the list; S = 2 halves them.
    k = 2049 * 64
    bad = contracts.check_launch(128, k, 128, m_tb=128, k_tb=64, n_tb=128,
                                 split_k=1)
    assert any("steps" in p for p in bad)
    assert not contracts.check_launch(128, k, 128, m_tb=128, k_tb=64,
                                      n_tb=128, split_k=2)


@pytest.mark.parametrize("geom", [(m, k, n) for m in (64, 128)
                                  for k in (64, 128)
                                  for n in contracts.N_TB_OPTIONS])
@pytest.mark.parametrize("b_dtype_bytes", [2, 4])
def test_smem_within_block_budget(geom, b_dtype_bytes):
    assert contracts.smem_bytes(*geom, b_dtype_bytes) <= \
        contracts.SMEM_BYTES_PER_BLOCK


@pytest.mark.parametrize("name", sorted(OPT))
def test_schedule_prefill_takes_wide_tiles(name):
    """At prefill the pipelined body's wide N tile is admissible for
    every projection, the grouped q/k/v included."""
    m, k, g = OPT[name]
    pre = schedule.select(m, k, 1024, m_tb=128, k_tb=128, max_nnz=3456,
                          group=g)
    assert pre.n_tb >= contracts.PIPE_MIN_N_TB and pre.split_k == 1
    f32 = schedule.select(m, k, 1024, m_tb=128, k_tb=128, max_nnz=3456,
                          group=g, b_dtype_bytes=4)
    assert not contracts.check_launch(m, k, 1024, m_tb=128, k_tb=128,
                                      n_tb=f32.n_tb, split_k=f32.split_k,
                                      group=g, b_dtype_bytes=4)


def test_schedule_binary_pair_fits_registers():
    sel = schedule.select(5632, 2048, 1024, m_tb=128, k_tb=128, max_nnz=3456,
                          group=2, binary=True)
    assert not contracts.check_launch(5632, 2048, 1024, m_tb=128, k_tb=128,
                                      n_tb=sel.n_tb, split_k=sel.split_k,
                                      group=2, binary=True)
    assert contracts.pipe_acc_per_thread(128, sel.n_tb, 2) <= \
        contracts.MAX_ACC_PER_THREAD


# ---- the decode body's shared memory, ring and occupancy -----------------

@pytest.mark.parametrize("n_tb", [8, 16, 32])
@pytest.mark.parametrize("geom", [(m, k) for m in contracts.M_TB_OPTIONS
                                  for k in contracts.K_TB_OPTIONS])
def test_decode_ring_fits_every_max_nnz(geom, n_tb):
    """Every max_nnz an encoding can have, up to a dense tile, gets a ring
    of at least one slot whose footprint fits the 227 KB a block may use,
    with the longest step list and the shortest."""
    m_tb, k_tb = geom
    for mnz in range(128, m_tb * k_tb + 1, 128):
        for steps in (1, contracts.MAX_PIPE_STEPS):
            depth = contracts.decode_ring_depth(m_tb, k_tb, n_tb, mnz, steps)
            assert 1 <= depth <= contracts.DECODE_MAX_RING
            smem = contracts.decode_smem_bytes(m_tb, k_tb, n_tb, mnz, depth,
                                               steps)
            assert smem <= contracts.SMEM_BYTES_PER_BLOCK
            assert contracts.smem_bytes(m_tb, k_tb, n_tb, 2, mnz,
                                        steps) == smem
            # the rule takes the deepest ring that keeps the most blocks
            most = contracts.decode_resident(m_tb, k_tb, n_tb, mnz, 1, steps)
            assert contracts.decode_resident(m_tb, k_tb, n_tb, mnz, depth,
                                             steps) == most
            deeper = contracts.decode_smem_bytes(m_tb, k_tb, n_tb, mnz,
                                                 depth + 1, steps)
            assert (depth == contracts.DECODE_MAX_RING
                    or deeper > contracts.SMEM_BYTES_PER_BLOCK
                    or contracts.decode_resident(m_tb, k_tb, n_tb, mnz,
                                                 depth + 1, steps) < most)


def test_decode_footprint_and_occupancy():
    """At 0.8 sparsity (max_nnz 3584 at 128 x 128) one word slot keeps four
    blocks on an SM; a dense tile's 64 KB slot keeps two; an n_tb = 32
    block is held to two by its registers, so it takes a deeper ring."""
    steps = 14
    assert contracts.decode_smem_bytes(128, 128, 8, 3584, 1, steps) == (
        2 * 128 * 128 + 2 * 2 * 128 * 8 + 4 * 3584 + 8 + 4 * steps
        + contracts.DECODE_STATIC_SMEM)
    assert contracts.decode_ring_depth(128, 128, 8, 3584, steps) == 1
    assert contracts.decode_resident(128, 128, 8, 3584, 1, steps) == 4
    assert contracts.decode_resident(128, 128, 8, 3584, 2, steps) == 3
    dense = 128 * 128
    assert contracts.decode_ring_depth(128, 128, 8, dense, steps) == 1
    assert contracts.decode_resident(128, 128, 8, dense, 1, steps) == 2
    assert contracts.decode_ring_depth(128, 128, 32, 3584, steps) == 3
    assert contracts.decode_resident(128, 128, 32, 3584, 3, steps) == 2
    kw = dict(m_tb=128, k_tb=128, max_nnz=3584)
    assert contracts.launch_resident(28672, n_tb=8, split_k=16, **kw) == 4
    assert contracts.launch_resident(28672, n_tb=128, split_k=1, **kw) == 1


def test_decode_body_contract():
    """bf16 at n_tb <= 32 runs the decode body: max_nnz a multiple of 4
    (16-byte word copies), the weight in the grid (or the binary pair in a
    block), at most MAX_PIPE_STEPS steps; f32 keeps the first body."""
    assert contracts.body(8) == contracts.body(32) == "decode"
    assert contracts.body(64) == "pipelined"
    assert contracts.body(8, b_dtype_bytes=4) == "first"
    ok = dict(m_tb=128, k_tb=128, n_tb=8, split_k=1)
    assert not contracts.check_launch(256, 256, 8, max_nnz=3584, **ok)
    bad = contracts.check_launch(256, 256, 8, max_nnz=3583, **ok)
    assert any("max_nnz" in p for p in bad)
    assert not contracts.check_launch(256, 256, 8, max_nnz=3583,
                                      b_dtype_bytes=4, **ok)
    assert contracts.block_groups(3, 8) == 1
    assert contracts.block_groups(2, 8, binary=True) == 2
    assert contracts.block_groups(3, 8, b_dtype_bytes=4) == 3
    assert contracts.acc_per_thread(128, 32, 2) == 32
    k = 2049 * 64
    bad = contracts.check_launch(128, k, 8, m_tb=128, k_tb=64, n_tb=8,
                                 split_k=1)
    assert any("steps" in p for p in bad)
    assert not contracts.check_launch(128, k, 8, m_tb=128, k_tb=64, n_tb=8,
                                      split_k=2)


def test_wrapper_ring_depth():
    """The wrapper passes the contract's ring depth to the decode body and
    0 to the other bodies."""
    _, pt = _pair(np.random.default_rng(1))          # Kt = 3, max_nnz 4096
    assert spmm.ring_depth(pt, 8, 1, 1, "none") == \
        contracts.decode_ring_depth(128, 128, 8, pt.max_nnz, 3)
    assert spmm.ring_depth(pt, 16, 2, 1, "none") == \
        contracts.decode_ring_depth(128, 128, 16, pt.max_nnz, 2)
    assert spmm.ring_depth(pt, 8, 1, 2, "silu_mul") == \
        contracts.decode_ring_depth(128, 128, 8, pt.max_nnz, 6)
    assert spmm.ring_depth(pt, 64, 1, 1, "none") == 0
    assert spmm.ring_depth(pt, 8, 1, 1, "none", b_dtype_bytes=4) == 0


@pytest.mark.parametrize("resident", [1, 2, 4])
def test_roofline_occupancy_term(resident):
    """Utilization is the launch's blocks over LAUNCH_ROUNDS rounds of the
    resident blocks on every SM; weights in the grid count as blocks."""
    from repro_torch.core import roofline
    full = roofline.LAUNCH_ROUNDS * resident * roofline.N_SMS
    kw = dict(m_tb=128, k_tb=128, n_tb=8, max_nnz=3584, resident=resident)
    t = roofline.lscd_splitk_terms(7168, 28672, 8, split_k=1, **kw)
    assert t.utilization == pytest.approx(56 / full)
    t = roofline.lscd_splitk_terms(7168, 7168, 8, split_k=2, group=3, **kw)
    assert t.utilization == pytest.approx(min(1.0, 56 * 2 * 3 / full))
    t = roofline.lscd_splitk_terms(7168, 7168, 8, split_k=2, group=2,
                                   block_groups=2, **kw)
    assert t.utilization == pytest.approx(min(1.0, 56 * 2 / full))
    t = roofline.lscd_splitk_terms(28672, 7168, 8, split_k=16, **kw)
    assert t.utilization == 1.0
