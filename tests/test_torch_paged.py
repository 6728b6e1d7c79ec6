"""The paged KV cache: the port's copies of ``BlockPool`` and
``Scheduler`` make the reference's decisions for the same calls; the
port's paged cache helpers write what the reference's write; and the
port's paged batcher gives the reference's greedy streams (smoke OPT-30B
and TinyLlama, f32, dense and at sparsity 0.8), preemption included, and
its own dense cache's streams. Sampled streams survive preemption.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import transformer as ref_tf
from repro.serving import batching as ref_batching
from repro.serving import paged_cache as ref_paged
from repro.serving import scheduler as ref_scheduler
from repro_torch import configs
from repro_torch.models import transformer
from repro_torch.serving import batching, paged_cache, scheduler
from torch_serving_parity import assert_streams_agree, f32_models, prompts_of

CASES = [("opt_30b", None), ("opt_30b", 0.8), ("tinyllama_1_1b", None),
         ("tinyllama_1_1b", 0.8)]


def _state(pool):
    return (pool.ref.tolist(), list(pool._free), dict(pool._key_of),
            {k: sorted(v) for k, v in pool._children.items()})


def _pool_script(mod):
    """The reference's pool tests as one call sequence; returns every
    result and the pool state after each call."""
    log = []
    pool = mod.BlockPool(8, 4)
    toks = np.arange(10)
    t1, h1 = pool.map_prompt(toks, 10)
    t2, h2 = pool.map_prompt(toks, 10)
    t3, h3 = pool.map_prompt(np.concatenate([[99], toks[1:]]), 10)
    log += [(t1.blocks, t1.n_shared, h1), (t2.blocks, t2.n_shared, h2),
            (t3.blocks, h3), _state(pool)]
    pool.free_table(t3)
    pool.free_table(t2)
    t4, h4 = pool.map_prompt(toks, 10)
    log += [(t4.blocks, h4), _state(pool)]
    t5 = pool.fork(t4)
    cow = pool.ensure_writable(t5, 2)
    log += [cow, t5.blocks, pool.ensure_writable(t5, 2),
            pool.ensure_writable(t4, 2), pool.ensure_capacity(t5, 3),
            t5.blocks, _state(pool)]
    for t in (t1, t4, t5):
        pool.free_table(t)
    pool.check_invariants()
    log += [pool.blocks_in_use, _state(pool)]
    small = mod.BlockPool(2, 4)
    a, _ = small.map_prompt(np.array([1, 2, 3, 4, 5, 6, 7, 8]), 8)
    small.free_table(a)
    b, hb = small.map_prompt(np.array([9, 9, 9, 9, 5, 6, 7, 8]), 8)
    log += [a.blocks, b.blocks, hb, _state(small)]
    small.free_table(b)
    with pytest.raises(mod.PoolExhausted):
        small.map_prompt(np.arange(12), 12)
    log += [small.blocks_in_use, b.padded(4).tolist(), _state(small)]
    return log


def test_pool_decisions_match_reference():
    assert _pool_script(paged_cache) == _pool_script(ref_paged)
    assert paged_cache.TRASH_BLOCK == ref_paged.TRASH_BLOCK == 0


def _fake_token(uid, count, vocab):
    return (int(uid) * 31 + int(count) * 7 + 1) % vocab


def _drive(mod, *, paged, n_blocks=None, block=4, max_len=32, n_slots=3,
           vocab=64, steps=200):
    """Run a scheduler as the batcher does, with a scripted stepper whose
    tokens are a function of (uid, token index); log every plan, copy,
    table and finished set."""
    max_blocks = -(-max_len // block)
    sched = mod.Scheduler(
        n_slots=n_slots, max_len=max_len, stop_ids=frozenset({5}),
        admit_k=2, buckets=(8, 16, 32), paged=paged, block_size=block,
        n_blocks=n_blocks if paged else None,
        max_blocks=max_blocks if paged else 0, sampled=True)
    rng = np.random.default_rng(0)
    shared = rng.integers(6, vocab, 8)
    for uid, L in enumerate([3, 9, 14, 5, 12, 4, 7, 20]):
        p = rng.integers(6, vocab, L)
        if uid % 3 == 0:
            p = np.concatenate([shared, p])
        sched.submit(uid, p.astype(np.int64), 6 + (uid % 4) * 3)
    log = []
    for _ in range(steps):
        finished = {}
        while True:
            plan = sched.plan_admission()
            if plan is None:
                break
            nxt = np.array([_fake_token(u, c, vocab)
                            for u, c in zip(plan.uids, plan.counts)])
            log.append(("admit", plan.slots, plan.bucket,
                        plan.tokens.tolist(), np.asarray(plan.targets).tolist(),
                        plan.lens.tolist(), plan.uids.tolist(),
                        plan.counts.tolist()))
            sched.commit_admission(plan, nxt, finished,
                                   ok=np.ones(len(nxt), bool))
        if paged:
            copies = sched.prepare_decode()
            log.append(("tables", copies, sched.table_arr.tolist(),
                        sched.pool.blocks_in_use))
        active = sched.active_slot_ids()
        sched.metrics.steps += 1
        if active:
            uids, counts = sched.decode_folds(active)
            nxt = np.array([_fake_token(u, c, vocab)
                            for u, c in zip(uids, counts)])
            log.append(("decode", active, sched.pos.tolist(),
                        sched.last_token.tolist(), uids.tolist()))
            sched.commit_decode(active, nxt, finished)
        log.append(("finished", sorted(finished.items())))
        if not sched.busy:
            break
    m = sched.metrics
    log.append((m.preemptions, m.prefix_hit_tokens, m.decode_tokens,
                m.eos_terminated, m.truncated))
    return log


@pytest.mark.parametrize("paged,n_blocks", [(False, None), (True, 24),
                                            (True, 10)])
def test_scheduler_decisions_match_reference(paged, n_blocks):
    """Same admission plans, block tables, copies and finished sets; the
    tight pool preempts."""
    got = _drive(scheduler, paged=paged, n_blocks=n_blocks)
    want = _drive(ref_scheduler, paged=paged, n_blocks=n_blocks)
    assert got == want
    if n_blocks == 10:
        assert got[-1][0] > 0                   # preemptions happened


def test_paged_cache_helpers_match_reference():
    """``scatter_cache_pages``, ``scatter_cache_slots`` and
    ``copy_cache_block`` write what the reference's functions return."""
    cfg = configs.smoke("tinyllama_1_1b")
    # unstacked layers: the reference keeps a per-layer list, as the port
    rcfg = dataclasses.replace(ref_configs.smoke("tinyllama_1_1b"),
                               n_layers=1, scan_layers=False)
    assert not ref_tf._use_scan(rcfg)
    rng = np.random.default_rng(1)
    n_phys, blk, k, S = 6, 4, 2, 7
    shape = (cfg.n_kv, cfg.head_dim)
    full = [rng.standard_normal((n_phys, blk) + shape).astype(np.float32)
            for _ in range(2)]
    part = [rng.standard_normal((k, S) + shape).astype(np.float32)
            for _ in range(2)]
    bmap = np.array([3, 1, 5, 0], np.int64)

    def port_tree(xs):
        return [{"k": torch.from_numpy(xs[0].copy()),
                 "v": torch.from_numpy(xs[1].copy())}]

    def ref_tree(xs):
        return [{"k": jnp.asarray(xs[0]), "v": jnp.asarray(xs[1])}]

    got = transformer.scatter_cache_pages(cfg, port_tree(full),
                                          port_tree(part),
                                          torch.from_numpy(bmap))
    want = ref_tf.scatter_cache_pages(rcfg, ref_tree(full), ref_tree(part),
                                      jnp.asarray(bmap))
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[0][name].numpy(),
                                      np.asarray(want[0][name]))
    got = transformer.copy_cache_block(cfg, got, 3, 4)
    want = ref_tf.copy_cache_block(rcfg, want, 3, 4)
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[0][name].numpy(),
                                      np.asarray(want[0][name]))
    dense = [rng.standard_normal((3, 12) + shape).astype(np.float32)
             for _ in range(2)]
    slots = np.array([2, 0], np.int64)
    got = transformer.scatter_cache_slots(cfg, port_tree(dense),
                                          port_tree(part),
                                          torch.from_numpy(slots))
    want = ref_tf.scatter_cache_slots(rcfg, ref_tree(dense), ref_tree(part),
                                      jnp.asarray(slots))
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[0][name].numpy(),
                                      np.asarray(want[0][name]))
    assert transformer.paged_blocks_per_seq(cfg, 30, 8) == \
        ref_tf.paged_blocks_per_seq(rcfg, 30, 8) == 4


def _run(batcher_cls, params, cfg, prompts, max_new, **kw):
    b = batcher_cls(params, cfg, **kw)
    for uid, p in enumerate(prompts):
        b.submit(uid, p, max_new_tokens=max_new)
    out = b.run_to_completion(max_steps=2000)
    assert len(out) == len(prompts)
    if b.paged:
        b.pool.check_invariants()
        assert b.pool.blocks_in_use == 0            # no leaked blocks
    return b, out


@pytest.mark.parametrize("arch,sparsity", CASES)
def test_paged_streams_match_reference_with_preemption(arch, sparsity):
    """A pool too small for the full decode length (test_paged_cache's
    forcing box) preempts; the resumed streams equal the reference's and
    the port's own dense-cache streams."""
    rcfg, jparams, pcfg, pparams = f32_models(arch, sparsity)
    prompts = prompts_of(pcfg, [3, 4, 5], seed=4)
    kw = dict(n_slots=3, max_len=32, cache_kind="paged", block_size=4,
              n_blocks=6)
    rb, want = _run(ref_batching.ContinuousBatcher, jparams, rcfg, prompts,
                    12, **kw)
    pb, got = _run(batching.ContinuousBatcher, pparams, pcfg, prompts, 12,
                   **kw)
    assert pb.metrics.preemptions > 0
    ties = assert_streams_agree(pparams, pcfg, dict(enumerate(prompts)),
                                got, want)
    if not ties:
        assert pb.metrics.preemptions == rb.metrics.preemptions
    _, dense = _run(batching.ContinuousBatcher, pparams, pcfg, prompts, 12,
                    n_slots=3, max_len=32)
    assert got == dense


def test_paged_dense_parity_mixed_lengths_and_shared_prefix():
    """Within the port: mixed lengths over two buckets and a shared
    prefix give the dense cache's streams, holding fewer blocks."""
    _, _, pcfg, pparams = f32_models("opt_30b", 0.8)
    rng = np.random.default_rng(3)
    shared = rng.integers(0, pcfg.vocab, 16).astype(np.int64)
    prompts = prompts_of(pcfg, [3, 9, 14, 5, 12, 4]) + [
        np.concatenate([shared, rng.integers(0, pcfg.vocab, 4)])
        for _ in range(3)]
    _, want = _run(batching.ContinuousBatcher, pparams, pcfg, prompts, 5,
                   n_slots=3, max_len=32)
    bp, got = _run(batching.ContinuousBatcher, pparams, pcfg, prompts, 5,
                   n_slots=3, max_len=32, cache_kind="paged", block_size=8,
                   n_blocks=12)
    assert got == want
    assert bp.metrics.prefix_hit_tokens > 0
    assert bp.metrics.peak_blocks_in_use < 3 * (32 // 8)


def test_paged_sampling_survives_preemption():
    """Sampled streams are a pure function of (seed, uid, token index):
    preempt-and-resume redraws the identical tokens; the seed moves the
    draw."""
    _, _, pcfg, pparams = f32_models("tinyllama_1_1b", 0.8)
    prompts = prompts_of(pcfg, [3, 4, 5], seed=7)
    kw = dict(n_slots=3, max_len=32, cache_kind="paged", temperature=0.7,
              top_k=16)
    _, calm = _run(batching.ContinuousBatcher, pparams, pcfg, prompts, 12,
                   block_size=8, n_blocks=24, seed=3, **kw)
    bp, tight = _run(batching.ContinuousBatcher, pparams, pcfg, prompts, 12,
                     block_size=4, n_blocks=6, seed=3, **kw)
    assert bp.metrics.preemptions > 0
    assert tight == calm
    _, other = _run(batching.ContinuousBatcher, pparams, pcfg, prompts, 12,
                    block_size=8, n_blocks=24, seed=4, **kw)
    _, greedy = _run(batching.ContinuousBatcher, pparams, pcfg, prompts, 12,
                     n_slots=3, max_len=32)
    assert other != calm and calm != greedy


def test_init_paged_cache_shapes():
    cfg = configs.smoke("opt_30b")
    cache = transformer.init_paged_cache(cfg, 5, 8, device="cpu")
    assert len(cache) == cfg.n_layers
    assert tuple(cache[0]["k"].shape) == (5, 8, cfg.n_kv, cfg.head_dim)
    assert cache[0]["v"].dtype == torch.bfloat16
    ref = ref_tf.init_paged_cache(ref_configs.smoke("opt_30b"), 5, 8)
    assert jax.tree.leaves(ref)[0].shape[-4:] == tuple(cache[0]["k"].shape)
