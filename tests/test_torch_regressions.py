"""Pins for faults found in the port against the reference (ROADMAP.md,
queue 3).

1. A 0-d tensor ``pos`` at decode with batch > 1. ``_pos_vector`` called
   ``pos.reshape(batch)``, so ``engine.serve_step`` raised for a 0-d
   position at B = 3; the reference broadcasts it
   (``repro/models/attention.py``, ``pos.ndim == 0``). The port now
   broadcasts with ``expand`` and reads nothing back to the host. Held
   against the reference's ``serve_step`` with ``pos=jnp.array(n)`` in
   f32 (tolerance 1e-3, as ``test_torch_slice.py`` states it), and
   bit-equal to the same step with an int position, dense and paged.
2. Shared-prefix blocks rewritten by a later admission: see
   ``test_shared_prefix_blocks_are_not_rewritten``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import engine as ref_engine
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import attention, transformer
from repro_torch.serving import api, engine, paged_cache
from repro_torch.serving import scheduler as sched_mod
from repro_torch.serving.config import SchedulerConfig, ServeConfig
from torch_parity import models, prompt_of

F32_TOL = 1e-3


def test_pos_vector_broadcasts_a_0d_tensor():
    got = attention._pos_vector(torch.tensor(5), 3, "cpu")
    assert got.tolist() == [5, 5, 5] and got.dtype == torch.int64
    per_row = attention._pos_vector(torch.tensor([1, 2, 3]), 3, "cpu")
    assert per_row.tolist() == [1, 2, 3]
    assert attention._pos_vector(7, 2, "cpu").tolist() == [7, 7]
    with pytest.raises(RuntimeError):
        attention._pos_vector(torch.tensor([1, 2]), 3, "cpu")


@pytest.mark.parametrize("arch", ["opt_30b", "tinyllama_1_1b"])
def test_serve_step_0d_pos_matches_reference(arch):
    rcfg, jparams, pcfg, pparams = models(arch, 0.8, "float32")
    prompt = prompt_of(rcfg)                        # B = 3
    S = prompt.shape[1]
    jlast, jcache = ref_engine.prefill(jparams, jnp.asarray(prompt), rcfg,
                                       S + 2)
    tok = np.array(jnp.argmax(jlast, -1))[:, None]
    jstep, _ = ref_engine.serve_step(jparams, jcache, jnp.asarray(tok),
                                     jnp.array(S), rcfg)
    with torch.inference_mode():
        outs = []
        for pos in (torch.tensor(S), S):
            _, pcache = engine.prefill(pparams, torch.from_numpy(prompt).long(),
                                       pcfg, S + 2)
            step, _ = engine.serve_step(pparams, pcache,
                                        torch.from_numpy(tok).long(), pos,
                                        pcfg)
            outs.append(step.float())
    assert torch.equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0].numpy(),
                               np.asarray(jnp.asarray(jstep, jnp.float32)),
                               rtol=F32_TOL, atol=F32_TOL)


def test_paged_decode_0d_pos_equals_int_pos():
    _, _, pcfg, pparams = models("opt_30b", None, "float32")
    block, B, S = 4, 3, 6
    tables = torch.tensor([[1, 2, 0], [3, 4, 0], [5, 6, 0]])
    tok = torch.tensor([[1], [2], [3]])
    outs = []
    with torch.inference_mode():
        for pos in (torch.tensor(S), S):
            pool = transformer.init_paged_cache(pcfg, 8, block, device="cpu")
            for leaf in transformer._leaves(pool):
                leaf.copy_(torch.linspace(-1, 1, leaf.numel()
                                          ).reshape(leaf.shape))
            logits, _ = transformer.forward(
                pparams, {"tokens": tok}, pcfg, mode="decode", cache=pool,
                pos=pos, block_tables=tables)
            outs.append((logits, pool))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(transformer._leaves(outs[0][1]),
                    transformer._leaves(outs[1][1])):
        assert torch.equal(a, b)


def _paged_server(params, cfg):
    return api.StreamingServer(params, cfg, config=ServeConfig(
        scheduler=SchedulerConfig(n_slots=4, max_len=64, admit_k=2,
                                  min_bucket=8),
        cache_kind="paged", block_size=8))


def _spy(monkeypatch):
    """Record the physical blocks every prefill writes, and every plan's
    block map."""
    writes, plans = [], []
    scatter = transformer.scatter_cache_pages

    def spy_scatter(cfg, full, part, flat_blocks):
        writes.append(flat_blocks.tolist())
        return scatter(cfg, full, part, flat_blocks)
    monkeypatch.setattr(transformer, "scatter_cache_pages", spy_scatter)
    plan_admission = sched_mod.Scheduler.plan_admission

    def spy_plan(self):
        plan = plan_admission(self)
        if plan is not None:
            plans.append(plan)
        return plan
    monkeypatch.setattr(sched_mod.Scheduler, "plan_admission", spy_plan)
    return writes, plans


def _streams(params, cfg, prompts, new=6):
    server = _paged_server(params, cfg)
    for name, p in prompts.items():
        server.submit(api.GenerationRequest(p, new, session_id=name))
    return {r.session_id: r.tokens for r in server.run_until_drained()}


def test_shared_prefix_blocks_are_not_rewritten(monkeypatch):
    """Queue 3 item 2. Request A (16 tokens: two full blocks of 8) is
    admitted, then B (A's 16 tokens and 20 more, a larger bucket) maps
    A's two blocks as prefix hits. On the H100 B's prefill rewrote them
    with other bits (another prefill shape sums in another order) and A's
    stream changed. Now the plan still maps them for B (``targets``, as
    the reference), but the prefill writes those chunks to the trash
    block: A's blocks keep their bytes, and each stream equals its run
    alone."""
    cfg = dataclasses.replace(configs.smoke("opt_30b"), dtype="float32")
    params, _ = serve.build(cfg, seed=0, sparsity=0.8, device="cpu")
    rng = np.random.default_rng(4)
    a = rng.integers(0, cfg.vocab, 16).astype(np.int64)
    b = np.concatenate([a, rng.integers(0, cfg.vocab, 20).astype(np.int64)])
    alone = {**_streams(params, cfg, {"a": a}), **_streams(params, cfg,
                                                           {"b": b})}
    writes, plans = _spy(monkeypatch)
    server = _paged_server(params, cfg)
    server.submit(api.GenerationRequest(a, 6, session_id="a"))
    server.step()
    bt = server.batcher
    (slot_a,) = bt.sched.active_slot_ids()
    shared = list(bt.sched.tables[slot_a].blocks[:2])
    leaves = transformer._leaves(bt.stepper.cache)
    before = [leaf[shared].clone() for leaf in leaves]
    server.submit(api.GenerationRequest(b, 6, session_id="b"))
    server.step()
    plan_b = plans[-1]
    assert plan_b.bucket > plans[0].bucket
    assert plan_b.targets[0, :2].tolist() == shared          # mapped
    assert plan_b.write_targets()[0, :2].tolist() == [
        paged_cache.TRASH_BLOCK] * 2                           # not written
    assert not set(shared) & set(writes[-1])
    assert bt.metrics.prefix_hit_tokens == 16
    for x, leaf in zip(before, leaves):
        assert torch.equal(x, leaf[shared])
    got = {r.session_id: r.tokens for r in server.run_until_drained()}
    assert got == alone


def test_shared_prefix_in_one_group_is_written_once(monkeypatch):
    """Two requests with one 16-token prefix admitted in one group: the
    first row writes the two shared blocks, the second maps them and
    writes its chunks to the trash block."""
    cfg = configs.smoke("tinyllama_1_1b")
    params, _ = serve.build(cfg, seed=1, sparsity=0.8, device="cpu")
    rng = np.random.default_rng(5)
    pre = rng.integers(0, cfg.vocab, 16).astype(np.int64)
    prompts = {n: np.concatenate([pre, rng.integers(0, cfg.vocab, 5)])
               for n in ("x", "y")}
    writes, plans = _spy(monkeypatch)
    _streams(params, cfg, prompts, new=3)
    first = plans[0]
    assert len(first.group) == 2
    shared = first.targets[0, :2].tolist()
    assert first.targets[1, :2].tolist() == shared
    assert first.write_targets()[1, :2].tolist() == [
        paged_cache.TRASH_BLOCK] * 2
    assert all(writes[0].count(blk) == 1 for blk in shared)
