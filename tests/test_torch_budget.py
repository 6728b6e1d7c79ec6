"""The port's HBM planner (``repro_torch.serving.budget``) against the
reference's (``repro.serving.budget``), which counts its weight term on
``jax.eval_shape`` structs, so full-size configs cost nothing to plan.

Every number must be equal: the weight bytes of each weight mode, the
bytes of a KV block, every ``Plan`` field, and the cases where the budget
cannot hold the deployment (``ValueError``). recurrentgemma's stack has
RG-LRU layers and mamba2's SSM layers, and so no paged cache: their
block bytes and every plan raise the reference's ``ValueError``. No
tensor is made.
"""

import functools
import itertools

import pytest

from repro import configs as ref_configs
from repro.serving import budget as ref_budget
from repro_torch import configs
from repro_torch.serving import budget

ARCHS = ("opt_30b", "opt_66b", "opt_175b", "tinyllama_1_1b", "minicpm3_4b",
         "deepseek_coder_33b", "qwen2_1_5b", "qwen2_moe_a2_7b",
         "qwen3_moe_30b_a3b", "recurrentgemma_9b", "mamba2_130m",
         "qwen2_vl_2b", "musicgen_large")
BUDGETS = (80e9, 320e9)
SMOKE_BUDGETS = (80e9, 2e6)
BLOCKS = (16, 128)
SPARSITIES = (0.8, 0.5)


@pytest.fixture(autouse=True)
def _memo_reference_weight_bytes(monkeypatch):
    """Each reference weight count traces the model once; the plans below
    ask for the same few counts many times, so they are remembered."""
    monkeypatch.setattr(ref_budget, "weight_bytes", _ref_weight_bytes)


@functools.lru_cache(maxsize=None)
def _ref_weight_bytes(cfg, mode="dense", sparsity=0.8):
    return _REF_WEIGHT_BYTES(cfg, mode, sparsity)


_REF_WEIGHT_BYTES = ref_budget.weight_bytes


def _pair(arch, smoke):
    if smoke:
        return ref_configs.smoke(arch), configs.smoke(arch)
    return ref_configs.get(arch), configs.get(arch)


def test_constants_match():
    assert budget.WEIGHT_MODES == ref_budget.WEIGHT_MODES
    assert budget.DEFAULT_WORKSPACE_FRAC == ref_budget.DEFAULT_WORKSPACE_FRAC
    assert configs.ARCH_IDS == list(ARCHS)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_weight_and_block_bytes_equal(arch, smoke):
    rcfg, pcfg = _pair(arch, smoke)
    for mode, s in itertools.product(budget.WEIGHT_MODES, SPARSITIES):
        assert budget.weight_bytes(pcfg, mode, s) == \
            ref_budget.weight_bytes(rcfg, mode, s), (mode, s)
    for block in BLOCKS:
        assert _or_error(budget.block_bytes, pcfg, block) == \
            _or_error(ref_budget.block_bytes, rcfg, block)


def _or_error(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return str(e)


def _plan_or_error(mod, cfg, **kw):
    try:
        return mod.plan(cfg, **kw), None
    except ValueError as e:
        return None, str(e)


@pytest.mark.parametrize("mode", budget.WEIGHT_MODES)
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_equal(arch, smoke, mode):
    rcfg, pcfg = _pair(arch, smoke)
    for hbm, block in itertools.product(
            SMOKE_BUDGETS if smoke else BUDGETS, BLOCKS):
        kw = dict(hbm_budget=hbm, weight_mode=mode, sparsity=0.8,
                  block=block)
        got, got_err = _plan_or_error(budget, pcfg, **kw)
        want, want_err = _plan_or_error(ref_budget, rcfg, **kw)
        assert got_err == want_err, kw
        if want is None:
            continue
        assert got.as_dict() == want.as_dict(), kw
        assert got.kv_positions == want.kv_positions
        for max_len in (512, 1024, 2048):
            assert got.n_dense_slots(max_len) == want.n_dense_slots(max_len)
        for prompt, new, max_len, ring in ((128, 64, 1024, None),
                                           (700, 300, 1024, None),
                                           (900, 200, 4096, 256)):
            assert got.worst_case_blocks(prompt, new, max_len, ring) == \
                want.worst_case_blocks(prompt, new, max_len, ring)
            assert got.can_serve(prompt, new, max_len, ring) == \
                want.can_serve(prompt, new, max_len, ring)


def test_cannot_hold_cases():
    """The deployments one 80 GB card cannot hold, as the reference says:
    OPT-66B dense, OPT-175B in any mode."""
    for arch, mode in (("opt_66b", "dense"), ("opt_175b", "dense"),
                       ("opt_175b", "sparse_pallas")):
        with pytest.raises(ValueError, match="cannot hold"):
            budget.plan(configs.get(arch), hbm_budget=80e9,
                        weight_mode=mode, block=16)
    p = budget.plan(configs.get("opt_30b"), hbm_budget=80e9,
                    weight_mode="sparse_pallas", block=16)
    d = budget.plan(configs.get("opt_30b"), hbm_budget=80e9,
                    weight_mode="dense", block=16)
    assert p.n_blocks > d.n_blocks
    assert p.n_dense_slots(1024) >= 32 > d.n_dense_slots(1024)


def test_workspace_override_and_unknown_mode():
    cfg = configs.get("opt_30b")
    rcfg = ref_configs.get("opt_30b")
    kw = dict(hbm_budget=80e9, weight_mode="sparse_xla", block=16,
              workspace_bytes=10**9)
    assert budget.plan(cfg, **kw).as_dict() == \
        ref_budget.plan(rcfg, **kw).as_dict()
    with pytest.raises(ValueError, match="weight mode"):
        budget.weight_bytes(cfg, "int4")
