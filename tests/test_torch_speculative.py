"""Speculative decoding (DESIGN.md §11) in the port against the reference:
the n-gram drafter's proposals, the draft-model drafter, the verify
window's mask, attention and step on one shared paged cache, and the
batcher's streams and counters, on the f32 smoke configs of OPT-30B and
TinyLlama (GQA). Logits agree within ``F32_TOL`` (1e-3); greedy streams
agree under the near-tie rule of ``torch_serving_parity``; a rejected
draft leaves every real block bit-identical. Inside the port,
speculation leaves greedy and sampled streams as they were, also across
preemption, and the pool is invariant-clean after every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attention
from repro.models import transformer as ref_tf
from repro.serving import batching as ref_batching
from repro.serving import engine as ref_engine
from repro.serving import speculative as ref_speculative
from repro_torch.models import attention, transformer
from repro_torch.serving import batching, engine, speculative
from torch_serving_parity import (F32_TOL, assert_streams_agree, f32_models,
                                  prompts_of)
from torch_window_parity import (assert_window_committed,
                                 committed_positions, port_cache, port_np,
                                 random_pools, ref_cache, ref_np)

CASES = [("opt_30b", 0.8), ("tinyllama_1_1b", None), ("minicpm3_4b", None),
         ("minicpm3_4b", 0.8)]
SPEC_COUNTERS = ("drafted", "accepted", "decode_tokens", "steps",
                 "active_slot_steps", "admitted", "completed")


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


def _counters(b):
    return {k: getattr(b.metrics, k) for k in SPEC_COUNTERS}


# ---------------------------------------------------------------------------
# drafters
# ---------------------------------------------------------------------------

def _history(kind):
    rng = np.random.default_rng(len(kind))
    return {
        "suffix_recurs": np.array([5, 6, 7, 8, 9, 5, 6, 7]),
        "no_recurrence": np.arange(10),
        "one_token": np.array([1]),
        "constant_run": np.concatenate([np.arange(40, 46), [7] * 7]),
        "short_period": np.tile([3, 1, 4], 5),
        "seeded_small_vocab": rng.integers(0, 4, 30),
        "seeded_wide_vocab": rng.integers(0, 50, 60),
    }[kind].astype(np.int64)


@pytest.mark.parametrize("max_ngram", [1, 3])
@pytest.mark.parametrize("kind", ["suffix_recurs", "no_recurrence",
                                  "one_token", "constant_run",
                                  "short_period", "seeded_small_vocab",
                                  "seeded_wide_vocab"])
def test_ngram_drafter_matches_reference(kind, max_ngram):
    """Every prefix of the history, every k in 0..5: the port proposes
    exactly the reference's tokens."""
    hist = _history(kind)
    got_d = speculative.NgramDrafter(max_ngram=max_ngram)
    want_d = ref_speculative.NgramDrafter(max_ngram=max_ngram)
    for n in range(1, len(hist) + 1):
        for k in range(6):
            got = got_d.propose(hist[:n], k)
            want = want_d.propose(hist[:n], k)
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, want)
    if kind == "constant_run":
        np.testing.assert_array_equal(got_d.propose(hist, 4), [7] * 4)
    if kind == "short_period" and max_ngram == 3:
        np.testing.assert_array_equal(got_d.propose(hist, 5),
                                      [3, 1, 4, 3, 1])
    with pytest.raises(ValueError, match="min_ngram"):
        speculative.NgramDrafter(max_ngram=2, min_ngram=3)


@pytest.mark.parametrize("n", [6, 9])
def test_draft_model_drafter_self_draft_and_vocab_check(n):
    """A self-drafting model proposes the target's own greedy
    continuation (``engine.generate``), whether the history fills its
    bucket or is padded to the next one; a vocab that differs from the
    target's is refused."""
    _, _, pcfg, pparams = f32_models("tinyllama_1_1b", None)
    hist = prompts_of(pcfg, [n], seed=2)[0]
    d = speculative.DraftModelDrafter(pparams, pcfg, vocab=pcfg.vocab)
    got = d.propose(hist, 3)
    assert got.shape == (3,) and got.dtype == np.int64
    want = engine.generate(pparams, torch.from_numpy(hist[None]), pcfg,
                           max_new_tokens=3, max_len=32)[0, n:].numpy()
    np.testing.assert_array_equal(got, want)
    assert d.propose(hist, 0).size == 0
    assert isinstance(speculative.make_drafter(
        "model", draft_params=pparams, draft_cfg=pcfg, vocab=pcfg.vocab),
        speculative.DraftModelDrafter)
    with pytest.raises(ValueError, match="tokenizer"):
        speculative.DraftModelDrafter(pparams, pcfg, vocab=pcfg.vocab + 1)
    with pytest.raises(ValueError, match="ngram|model"):
        speculative.make_drafter("beam")
    with pytest.raises(ValueError, match="draft_params"):
        speculative.make_drafter("model")


# ---------------------------------------------------------------------------
# the verify window on one shared cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W,T_old", [(1, 8), (4, 16), (5, 12)])
def test_verify_window_mask_matches_reference(W, T_old):
    pos = np.array([0, 3, 7, 12, 16], np.int64)
    got = attention.verify_window_mask(torch.from_numpy(pos), W, T_old)
    want = ref_attention.verify_window_mask(
        jnp.asarray(pos, jnp.int32), W, T_old, None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


N_SLOTS, BLOCK, NBLK, W = 3, 4, 4, 4          # max_len 16, spec_k 3
POS = np.array([5, 2, 13], np.int64)         # slot 2's window runs past


def _tables():
    return 1 + np.arange(N_SLOTS * NBLK).reshape(N_SLOTS, NBLK)


@pytest.mark.parametrize("arch", ["opt_30b", "tinyllama_1_1b"])
def test_attention_verify_paged_matches_reference(arch):
    """One layer's verify attention over the same pool, tables and window
    input: output within ``F32_TOL``, fresh K/V in the cache dtype within
    one bf16 ulp, and the pool left as it was."""
    rcfg, jparams, pcfg, pparams = f32_models(arch, None)
    pools = random_pools(pcfg, 1 + N_SLOTS * NBLK, BLOCK, seed=1)
    tables = _tables()
    x = np.random.default_rng(2).standard_normal(
        (N_SLOTS, W, pcfg.d_model)).astype(np.float32)
    pc = port_cache(pools)
    before = port_np(pc)
    y, fresh = attention.attention_verify_paged(
        pparams["layers"][0]["attn"], torch.from_numpy(x), pc[0],
        torch.from_numpy(tables), torch.from_numpy(POS), pcfg)
    rparams = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    rc = ref_cache(pools)
    ry, rfresh = ref_attention.attention_verify_paged(
        rparams, jnp.asarray(x), {n: rc[n][0] for n in ("k", "v")},
        jnp.asarray(tables, jnp.int32), jnp.asarray(POS, jnp.int32), rcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=F32_TOL,
                               atol=F32_TOL)
    for n in ("k", "v"):
        assert fresh[n].dtype == torch.bfloat16
        np.testing.assert_allclose(
            fresh[n].float().numpy(),
            np.asarray(rfresh[n].astype(jnp.float32)), rtol=2 ** -7,
            atol=1e-6)
    after = port_np(pc)
    for n in ("k", "v"):
        np.testing.assert_array_equal(after[n], before[n])


def _port_verify_logits(pparams, pcfg, pools, tables, tokens):
    with torch.inference_mode():
        logits, _ = transformer.forward(
            pparams, {"tokens": torch.from_numpy(tokens)}, pcfg,
            mode="verify", cache=port_cache(pools), pos=torch.from_numpy(POS),
            block_tables=torch.from_numpy(tables))
    return logits.numpy()


def _drafts(pparams, pcfg, pools, tables, accept):
    """A window whose slot b has its first ``accept[b]`` drafts right and
    the next one wrong, built from the port's own verify argmax."""
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, pcfg.vocab, (N_SLOTS, W)).astype(np.int64)
    for j in range(W - 1):
        tgt = _port_verify_logits(pparams, pcfg, pools, tables,
                                  tokens).argmax(-1)
        for b in range(N_SLOTS):
            if j < accept[b]:
                tokens[b, j + 1] = tgt[b, j]
            elif j == accept[b]:
                tokens[b, j + 1] = (tgt[b, j] + 1) % pcfg.vocab
    return tokens


@pytest.mark.parametrize("arch,sparsity", CASES)
def test_verify_step_matches_reference(arch, sparsity):
    """``engine.verify_step`` against the reference's on one pool, one set
    of tables and one window (slot 0 accepts all three drafts, slot 1
    one, slot 2 none, its window running past its table): the window's
    logits within ``F32_TOL``, the same targets and accept counts, the
    accepted positions' K/V within one bf16 ulp, and every other position
    of every real block bit-identical."""
    rcfg, jparams, pcfg, pparams = f32_models(arch, sparsity)
    pools = random_pools(pcfg, 1 + N_SLOTS * NBLK, BLOCK, seed=4)
    tables = _tables()
    accept = [3, 1, 0]
    tokens = _drafts(pparams, pcfg, pools, tables, accept)
    draft_lens = np.array([3, 3, 2])
    logits = _port_verify_logits(pparams, pcfg, pools, tables, tokens)
    rlogits, _, _ = ref_tf.forward(
        jparams, {"tokens": jnp.asarray(tokens)}, rcfg, mode="verify",
        cache=ref_cache(pools), pos=jnp.asarray(POS, jnp.int32),
        block_tables=jnp.asarray(tables, jnp.int32))
    np.testing.assert_allclose(logits, np.asarray(rlogits), rtol=F32_TOL,
                               atol=F32_TOL)
    pc = port_cache(pools)
    before = port_np(pc)
    with torch.inference_mode():
        tgt, n_acc, _ = engine.verify_step(
            pparams, pc, torch.from_numpy(tokens), torch.from_numpy(POS),
            torch.from_numpy(tables), torch.from_numpy(draft_lens), None,
            None, pcfg)
    rtgt, rn_acc, rc = ref_engine.verify_step(
        jparams, ref_cache(pools), jnp.asarray(tokens),
        jnp.asarray(POS, jnp.int32), jnp.asarray(tables, jnp.int32),
        jnp.asarray(draft_lens, jnp.int32), None, None, rcfg)
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(rtgt))
    np.testing.assert_array_equal(n_acc.numpy(), np.asarray(rn_acc))
    assert n_acc.tolist() == accept
    commit = np.arange(W)[None, :] <= n_acc.numpy()[:, None]
    assert_window_committed(port_np(pc), ref_np(rc), before,
                            committed_positions(tables, POS, commit, BLOCK))


def test_verify_step_sampled_draws_as_decode_would():
    """Sampled verify: column j draws exactly what plain decode draws for
    token index ``counts + j`` from the same logits."""
    _, _, pcfg, pparams = f32_models("tinyllama_1_1b", None)
    pools = random_pools(pcfg, 1 + N_SLOTS * NBLK, BLOCK, seed=5)
    tables = _tables()
    tokens = np.random.default_rng(6).integers(
        0, pcfg.vocab, (N_SLOTS, W)).astype(np.int64)
    logits = torch.from_numpy(_port_verify_logits(pparams, pcfg, pools,
                                                  tables, tokens))
    uids, counts = torch.tensor([4, 9, 2]), torch.tensor([0, 5, 11])
    kw = dict(temperature=0.8, top_k=16, seed=3)
    tgt, n_acc = engine.accept_drafts(logits, torch.from_numpy(tokens),
                                      torch.tensor([3, 3, 3]), uids, counts,
                                      **kw)
    for j in range(W):
        col = engine.sample_per_slot(logits[:, j], uids, counts + j, **kw)
        assert torch.equal(tgt[:, j], col)
    match = (tokens[:, 1:] == tgt.numpy()[:, :-1])
    assert n_acc.tolist() == [int(np.cumprod(r).sum()) for r in match]


# ---------------------------------------------------------------------------
# the batcher: streams, counters and the pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,sparsity", CASES)
def test_spec_batcher_matches_reference_mixed_lengths(arch, sparsity):
    """Greedy speculation over mixed prompt lengths: the port's streams
    equal the reference's (near-tie rule) and the port's own without
    speculation; with no near-tie, the speculative counters equal the
    reference's."""
    rcfg, jparams, pcfg, pparams = f32_models(arch, sparsity)
    prompts = prompts_of(pcfg, [3, 9, 14, 5], seed=1)
    kw = dict(n_slots=3, max_len=32, cache_kind="paged", block_size=8,
              n_blocks=16)
    rb, want = _run(ref_batching.ContinuousBatcher, jparams, rcfg, prompts,
                    8, spec_k=4, **kw)
    pb, got = _run(batching.ContinuousBatcher, pparams, pcfg, prompts, 8,
                   spec_k=4, **kw)
    ties = assert_streams_agree(pparams, pcfg, dict(enumerate(prompts)),
                                got, want)
    assert pb.metrics.drafted > 0          # speculation actually ran
    if not ties:
        assert _counters(pb) == _counters(rb)
    _, plain = _run(batching.ContinuousBatcher, pparams, pcfg, prompts, 8,
                    n_slots=3, max_len=32)
    assert got == plain


def test_spec_accepts_on_repetitive_stream_with_reference_counters():
    """Repetitive prompts: drafts are accepted, speculation takes fewer
    steps than plain paged decode, and every speculative counter equals
    the reference's."""
    rcfg, jparams, pcfg, pparams = f32_models("tinyllama_1_1b", None)
    rng = np.random.default_rng(4)
    prompts = [np.tile(rng.integers(0, pcfg.vocab, 4).astype(np.int64), 6)
               for _ in range(2)]
    kw = dict(n_slots=2, max_len=64, cache_kind="paged", block_size=8,
              n_blocks=16)
    b0, plain = _run(batching.ContinuousBatcher, pparams, pcfg, prompts, 24,
                     **kw)
    bs, got = _run(batching.ContinuousBatcher, pparams, pcfg, prompts, 24,
                   spec_k=4, **kw)
    rb, want = _run(ref_batching.ContinuousBatcher, jparams, rcfg, prompts,
                    24, spec_k=4, **kw)
    assert got == plain
    ties = assert_streams_agree(pparams, pcfg, dict(enumerate(prompts)),
                                got, want)
    m = bs.metrics
    assert m.accepted > 0
    assert m.steps < b0.metrics.steps
    assert m.tokens_per_step > 1.0
    if not ties:
        assert _counters(bs) == _counters(rb)
        assert m.accept_rate == rb.metrics.accept_rate
        assert m.tokens_per_step == rb.metrics.tokens_per_step


def test_spec_rollback_pool_invariant_clean_every_step():
    """Rejected-window pages roll back each step: ref-counts tie out after
    every step, and no slot's table covers more than its committed
    positions once the step settles."""
    _, _, pcfg, pparams = f32_models("opt_30b", 0.8)
    prompts = prompts_of(pcfg, [3, 6, 9], seed=5)
    b = batching.ContinuousBatcher(pparams, pcfg, n_slots=3, max_len=32,
                                   cache_kind="paged", block_size=4,
                                   n_blocks=24, spec_k=4)
    for uid, p in enumerate(prompts):
        b.submit(uid, p, max_new_tokens=6)
    for _ in range(200):
        b.step()
        b.pool.check_invariants()
        for s in range(b.n_slots):
            if b.slots[s] is not None:
                assert len(b.tables[s].blocks) == \
                    b.pool.blocks_for(int(b.pos[s]))
        if not b.busy:
            break
    assert b.pool.blocks_in_use == 0
    assert b.metrics.completed == len(prompts)
    assert b.metrics.drafted > 0


def test_spec_preemption_greedy_and_sampled_parity():
    """A pool too small for the windows preempts; the resumed greedy
    streams equal the dense-cache ones, and sampled speculation (short
    periodic prompts, so drafts are made and some accepted) replays the
    plain sampled streams, calm or tight."""
    _, _, pcfg, pparams = f32_models("tinyllama_1_1b", None)
    prompts = prompts_of(pcfg, [3, 4, 5], seed=6)
    _, want = _run(batching.ContinuousBatcher, pparams, pcfg, prompts, 12,
                   n_slots=3, max_len=32)
    bp, got = _run(batching.ContinuousBatcher, pparams, pcfg, prompts, 12,
                   n_slots=3, max_len=32, cache_kind="paged", block_size=4,
                   n_blocks=7, spec_k=3)
    assert got == want
    assert bp.metrics.preemptions > 0
    kw = dict(n_slots=3, max_len=32, temperature=0.3, top_k=16, seed=3)
    rng = np.random.default_rng(7)
    prompts = [np.tile(rng.integers(0, pcfg.vocab, 2).astype(np.int64), 3)
               for _ in range(3)]
    _, plain = _run(batching.ContinuousBatcher, pparams, pcfg, prompts, 12,
                    **kw)
    bc, calm = _run(batching.ContinuousBatcher, pparams, pcfg, prompts, 12,
                    cache_kind="paged", block_size=8, n_blocks=24, spec_k=3,
                    **kw)
    bt, tight = _run(batching.ContinuousBatcher, pparams, pcfg, prompts, 12,
                     cache_kind="paged", block_size=4, n_blocks=7, spec_k=3,
                     **kw)
    assert calm == plain
    assert tight == calm
    assert bt.metrics.preemptions > 0
    assert bc.metrics.accepted > 0 and bt.metrics.accepted > 0


def test_spec_metrics_match_reference():
    """The speculative counters and rates of ``SchedulerMetrics`` equal
    the reference's on the same run, and hold the reference's
    arithmetic."""
    rcfg, jparams, pcfg, pparams = f32_models("opt_30b", 0.8)
    rng = np.random.default_rng(8)
    prompts = [np.tile(rng.integers(0, pcfg.vocab, 3).astype(np.int64), 5)
               for _ in range(3)]
    kw = dict(n_slots=2, max_len=48, cache_kind="paged", block_size=8,
              n_blocks=18, spec_k=4)
    bs, out = _run(batching.ContinuousBatcher, pparams, pcfg, prompts, 10,
                   **kw)
    rb, want = _run(ref_batching.ContinuousBatcher, jparams, rcfg, prompts,
                    10, **kw)
    m = bs.metrics
    assert sum(len(v) for v in out.values()) == m.admitted + m.decode_tokens
    assert 0 <= m.accepted <= m.drafted
    assert m.accept_rate == pytest.approx(m.accepted / max(m.drafted, 1))
    assert m.decode_tokens <= m.active_slot_steps * (bs.spec_k + 1)
    if not assert_streams_agree(pparams, pcfg, dict(enumerate(prompts)),
                                out, want):
        d, rd = m.as_dict(), rb.metrics.as_dict()
        for key in ("drafted", "accepted", "accept_rate", "tokens_per_step",
                    "decode_tokens", "steps"):
            assert d[key] == rd[key], key
    empty = batching.SchedulerMetrics()
    assert empty.accept_rate == 0.0 and empty.tokens_per_step == 0.0
