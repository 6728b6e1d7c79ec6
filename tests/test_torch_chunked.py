"""Chunked prefill (DESIGN.md §16) in the port against the reference: the
mixed prefill-chunk/decode step on one shared paged cache, and the
batcher's chunked streams, on the f32 smoke configs of OPT-30B and
TinyLlama (GQA). Logits agree within ``F32_TOL`` (1e-3); greedy streams
agree under the near-tie rule of ``torch_serving_parity``; padding
columns leave every real block bit-identical. Inside the port, chunked
streams equal the bucketed ones, greedy and sampled, at a stop token on
the step a prompt completes and across a preemption mid-prefill; the
mixed step keeps one shape; and the CLI serves with ``--chunked`` and
``--spec-k``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import batching as ref_batching
from repro.serving import engine as ref_engine
from repro_torch.serving import batching, engine
from repro_torch.serving.config import SchedulerConfig, ServeConfig
from torch_serving_parity import (F32_TOL, assert_streams_agree, f32_models,
                                  prompts_of)
from torch_window_parity import (assert_window_committed,
                                 committed_positions, port_cache, port_np,
                                 random_pools, ref_cache, ref_np)

CASES = [("opt_30b", 0.8), ("tinyllama_1_1b", None), ("minicpm3_4b", None),
         ("minicpm3_4b", 0.8)]
CHUNK_COUNTERS = ("mixed_steps", "chunk_tokens", "prefill_tokens",
                  "decode_tokens", "steps", "compute_positions", "admitted",
                  "completed")


def _config(*, chunked, chunk_size=4, chunk_budget=None, n_slots=3,
            temperature=0.0, seed=0, stop_ids=()):
    return ServeConfig(
        scheduler=SchedulerConfig(
            n_slots=n_slots, max_len=64, stop_ids=tuple(stop_ids),
            chunked_prefill=chunked, chunk_size=chunk_size,
            chunk_budget=chunk_budget if chunk_budget is not None
            else 2 * chunk_size),
        cache_kind="paged", block_size=8, n_blocks=64,
        temperature=temperature, seed=seed)


def _drain(batcher_cls, params, cfg, prompts, max_new=5, **cfg_kw):
    b = batcher_cls(params, cfg, config=_config(**cfg_kw))
    for uid, p in enumerate(prompts):
        b.submit(uid, p, max_new)
    out = b.run_to_completion()
    b.pool.check_invariants()
    assert b.pool.blocks_in_use == 0, "leaked KV blocks"
    return b, out


def _boundary_prompts(cfg, chunk_size):
    """Prompt lengths that hit every chunk-boundary case: an exact multiple
    of the chunk size, a single-token final chunk, shorter than one chunk,
    and a couple of ragged fillers."""
    rng = np.random.default_rng(7)
    lens = [2 * chunk_size, 2 * chunk_size + 1, max(1, chunk_size - 1),
            3 * chunk_size - 1, 5]
    return [rng.integers(0, cfg.vocab, n).astype(np.int64) for n in lens]


# ---------------------------------------------------------------------------
# the mixed step on one shared cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,sparsity", CASES)
def test_prefill_chunk_into_pages_matches_reference(arch, sparsity):
    """One mixed step over the same pool and tables: a full chunk at 0, a
    partial chunk at 4, a decode slot at 9, an idle slot. The last real
    column's logits within ``F32_TOL``, the committed K/V within one bf16
    ulp, and every padding column leaves the real blocks bit-identical."""
    rcfg, jparams, pcfg, pparams = f32_models(arch, sparsity)
    n_slots, block, nblk, W = 4, 4, 4, 4
    pools = random_pools(pcfg, 1 + n_slots * nblk, block, seed=8)
    tables = 1 + np.arange(n_slots * nblk).reshape(n_slots, nblk)
    tokens = np.random.default_rng(9).integers(
        0, pcfg.vocab, (n_slots, W)).astype(np.int64)
    pos = np.array([0, 4, 9, 0], np.int64)
    n_tokens = np.array([4, 3, 1, 0], np.int64)
    tokens[n_tokens[:, None] <= np.arange(W)[None, :]] = 0     # padding
    pc = port_cache(pools)
    before = port_np(pc)
    with torch.inference_mode():
        last, _ = engine.prefill_chunk_into_pages(
            pparams, pc, torch.from_numpy(tokens), torch.from_numpy(pos),
            torch.from_numpy(tables), torch.from_numpy(n_tokens), pcfg)
    rlast, rc = ref_engine.prefill_chunk_into_pages(
        jparams, ref_cache(pools), jnp.asarray(tokens),
        jnp.asarray(pos, jnp.int32), jnp.asarray(tables, jnp.int32),
        jnp.asarray(n_tokens, jnp.int32), rcfg)
    real = n_tokens > 0
    np.testing.assert_allclose(last.numpy()[real], np.asarray(rlast)[real],
                               rtol=F32_TOL, atol=F32_TOL)
    commit = np.arange(W)[None, :] < n_tokens[:, None]
    assert_window_committed(port_np(pc), ref_np(rc), before,
                            committed_positions(tables, pos, commit, block))


# ---------------------------------------------------------------------------
# the batcher's chunked streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk_size", [1, 4])
def test_chunked_matches_unchunked_greedy(chunk_size):
    """Every chunk-boundary case: chunked streams equal the bucketed ones
    inside the port, every prompt token goes through chunks, and the
    bucketed prefill never runs."""
    _, _, pcfg, pparams = f32_models("tinyllama_1_1b", None)
    prompts = _boundary_prompts(pcfg, chunk_size)
    _, want = _drain(batching.ContinuousBatcher, pparams, pcfg, prompts,
                     chunked=False)
    b, got = _drain(batching.ContinuousBatcher, pparams, pcfg, prompts,
                    chunked=True, chunk_size=chunk_size)
    assert got == want
    assert b.metrics.mixed_steps > 0
    assert b.metrics.chunk_tokens == sum(len(p) for p in prompts)
    assert b.prefill_compiles == 0, \
        "chunked mode must never hit the bucketed prefill path"


@pytest.mark.parametrize("arch,sparsity", CASES)
def test_chunked_batcher_matches_reference(arch, sparsity):
    """Chunked greedy streams against the reference's chunked batcher
    (near-tie rule); with no near-tie, the chunk counters are the
    reference's."""
    rcfg, jparams, pcfg, pparams = f32_models(arch, sparsity)
    prompts = _boundary_prompts(pcfg, 4)
    rb, want = _drain(ref_batching.ContinuousBatcher, jparams, rcfg, prompts,
                      chunked=True)
    pb, got = _drain(batching.ContinuousBatcher, pparams, pcfg, prompts,
                     chunked=True)
    ties = assert_streams_agree(pparams, pcfg, dict(enumerate(prompts)),
                                got, want)
    if not ties:
        for key in CHUNK_COUNTERS:
            assert getattr(pb.metrics, key) == getattr(rb.metrics, key), key


def test_chunked_matches_unchunked_sampled():
    """Sampled chunked streams are the bucketed ones: each slot's first
    token draws with the (uid, token index) fold bucketed admission
    uses."""
    _, _, pcfg, pparams = f32_models("opt_30b", 0.8)
    prompts = _boundary_prompts(pcfg, 4)
    _, want = _drain(batching.ContinuousBatcher, pparams, pcfg, prompts,
                     chunked=False, temperature=0.8, seed=3)
    _, got = _drain(batching.ContinuousBatcher, pparams, pcfg, prompts,
                    chunked=True, chunk_size=4, temperature=0.8, seed=3)
    assert got == want
    _, greedy = _drain(batching.ContinuousBatcher, pparams, pcfg, prompts,
                       chunked=True, chunk_size=4)
    assert got != greedy


def test_stop_token_on_chunk_completion_step():
    """A stop token drawn on the very step a slot's final chunk commits
    finishes the request in both modes alike."""
    _, _, pcfg, pparams = f32_models("tinyllama_1_1b", None)
    prompts = _boundary_prompts(pcfg, 4)[:2]
    _, free = _drain(batching.ContinuousBatcher, pparams, pcfg, prompts,
                     chunked=False)
    stop = free[0][0]                  # uid 0's first generated token
    b0, want = _drain(batching.ContinuousBatcher, pparams, pcfg, prompts,
                      chunked=False, stop_ids=(stop,))
    b1, got = _drain(batching.ContinuousBatcher, pparams, pcfg, prompts,
                     chunked=True, chunk_size=4, stop_ids=(stop,))
    assert got == want
    assert b0.requests[0].finish_reason == "stop"
    assert b1.requests[0].finish_reason == "stop"
    assert len(got[0]) == 1            # stopped on its first token


def test_preempt_mid_prefill_requeues_and_matches():
    """Preempting a slot whose prompt is only partly chunked in requeues
    it; the recompute-resume replays the bucketed stream."""
    _, _, pcfg, pparams = f32_models("opt_30b", 0.8)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, pcfg.vocab, 20).astype(np.int64),
               rng.integers(0, pcfg.vocab, 19).astype(np.int64)]
    _, want = _drain(batching.ContinuousBatcher, pparams, pcfg, prompts,
                     chunked=False, n_slots=2)
    b = batching.ContinuousBatcher(
        pparams, pcfg, config=_config(chunked=True, chunk_size=4, n_slots=2))
    for uid, p in enumerate(prompts):
        b.submit(uid, p, 5)
    got = dict(b.step())               # both admitted; first chunks in
    sched = b.sched
    slot1 = next(s for s, r in enumerate(sched.slots)
                 if r is not None and r.uid == 1)
    slot0 = next(s for s, r in enumerate(sched.slots)
                 if r is not None and r.uid == 0)
    assert sched.chunk_goal[slot1] == 19, "uid 1 should be mid-prefill"
    sched._preempt_youngest(exclude=slot0)
    assert sched.chunk_goal[slot1] == 0
    assert sched.requests[1].pending
    for _ in range(200):
        got.update(b.step())
        if not b.busy:
            break
    assert got == want
    assert b.metrics.preemptions >= 1
    b.pool.check_invariants()
    assert b.pool.blocks_in_use == 0


def test_mixed_step_keeps_one_shape():
    """Every chunk/decode mix runs the one [n_slots, chunk_size] step."""
    _, _, pcfg, pparams = f32_models("tinyllama_1_1b", None)
    prompts = _boundary_prompts(pcfg, 4)
    b, _ = _drain(batching.ContinuousBatcher, pparams, pcfg, prompts,
                  chunked=True, chunk_size=4)
    assert b.stepper.window_shapes == {("mixed", (3, 4))}
    assert tuple(b.stepper._mtok_in.shape) == (3, 4)
    assert b.metrics.compute_positions > 0
    assert b.metrics.mixed_steps > 0


@pytest.mark.parametrize("extra", [["--chunked"],
                                   ["--chunked", "--chunk-size", "4",
                                    "--chunk-budget", "8"],
                                   ["--spec-k", "2"],
                                   ["--spec-k", "2", "--drafter", "model",
                                    "--max-ngram", "2"]])
def test_cli_serves_chunked_and_speculative(extra):
    """``serve.main`` with the item-9 flags serves every request its
    ``--max-new`` tokens through the chunked or speculative batcher."""
    from repro_torch.launch import serve
    rep = serve.main(["--arch", "opt_30b", "--smoke", "--sparsity", "0.8",
                      "--slots", "2", "--requests", "3", "--max-new", "4",
                      "--max-len", "24", "--paged"] + extra, device="cpu")
    assert len(rep["responses"]) == 3 and rep["shed"] == 0
    assert all(len(r.tokens) == 4 for r in rep["responses"])
    b = rep["server"].batcher
    if "--chunked" in extra:
        assert b.chunked and b.metrics.mixed_steps > 0
        size = int(extra[extra.index("--chunk-size") + 1]) \
            if "--chunk-size" in extra else 16
        assert b.stepper.window_shapes == {("mixed", (2, size))}
    else:
        assert b.spec_k == 2 and b.metrics.drafted >= 0
        kind = "model" if "model" in extra else "ngram"
        assert type(b.drafter).__name__ == {
            "model": "DraftModelDrafter", "ngram": "NgramDrafter"}[kind]
