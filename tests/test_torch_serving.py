"""Continuous batching on the dense cache: the port's ``ContinuousBatcher``
against the reference's, on the smoke configs of OPT-30B and TinyLlama
(f32), dense and at sparsity 0.8, in the scenarios of
``test_serving.py``: mixed prompt lengths over two buckets, slot reuse,
EOS and ``max_len`` truncation. Greedy streams agree under the near-tie
rule of ``torch_serving_parity``. Also the engine's bucket helpers, the
per-slot sampler, the stepper's graph refusal on the CPU and the
not-ported paths.
"""

import numpy as np
import pytest
import torch

from repro.serving import batching as ref_batching
from repro.serving import engine as ref_engine
from repro_torch.serving import batching, config, engine, step
from torch_serving_parity import assert_streams_agree, f32_models, prompts_of

CASES = [("opt_30b", None), ("opt_30b", 0.8), ("tinyllama_1_1b", None),
         ("tinyllama_1_1b", 0.8)]
LENGTHS = [3, 9, 14, 5, 12, 4]          # buckets 8 and 16 at max_len 32


def _run(batcher_cls, params, cfg, prompts, max_new, **kw):
    b = batcher_cls(params, cfg, **kw)
    for uid, (p, n) in enumerate(zip(prompts, max_new)):
        b.submit(uid, p, max_new_tokens=n)
    return b, b.run_to_completion()


@pytest.mark.parametrize("arch,sparsity", CASES)
def test_batcher_streams_match_reference(arch, sparsity):
    """Six mixed-length prompts (two buckets) and one whose budget runs
    past ``max_len`` over three slots: the slots are reused, and every
    stream, finish reason and bucket count equals the reference's."""
    rcfg, jparams, pcfg, pparams = f32_models(arch, sparsity)
    prompts = prompts_of(pcfg, LENGTHS + [6], seed=3)
    max_new = [5] * len(LENGTHS) + [100]
    kw = dict(n_slots=3, max_len=32)
    rb, want = _run(ref_batching.ContinuousBatcher, jparams, rcfg, prompts,
                    max_new, **kw)
    pb, got = _run(batching.ContinuousBatcher, pparams, pcfg, prompts,
                   max_new, **kw)
    ties = assert_streams_agree(pparams, pcfg, dict(enumerate(prompts)),
                                got, want)
    if not ties:
        assert {u: r.finish_reason for u, r in pb.requests.items()} == \
            {u: r.finish_reason for u, r in rb.requests.items()}
    assert pb.requests[6].finish_reason == "max_len"
    assert len(got[6]) == 1 + (32 - 6)
    assert set(pb.metrics.bucket_admits) == {8, 16}
    assert pb.metrics.bucket_admits == rb.metrics.bucket_admits
    assert pb.prefill_compiles == 2
    assert pb.slots == [None] * 3
    m = pb.metrics
    assert m.admitted == m.completed == len(prompts)
    assert sum(len(v) for v in got.values()) == m.admitted + m.decode_tokens
    with pytest.raises(ValueError):
        pb.submit(99, prompts[0][:1].repeat(32), 1)     # over-long prompt


@pytest.mark.parametrize("arch,sparsity", [("opt_30b", 0.8),
                                           ("tinyllama_1_1b", None)])
def test_batcher_eos_matches_reference(arch, sparsity):
    """With the third token of a free run as EOS, both packages stop at
    it (kept in the output) with finish reason "stop"."""
    rcfg, jparams, pcfg, pparams = f32_models(arch, sparsity)
    prompt = prompts_of(pcfg, [6], seed=5)[0]
    _, free = _run(batching.ContinuousBatcher, pparams, pcfg, [prompt], [6],
                   n_slots=1, max_len=32)
    eos = free[0][2]
    kw = dict(n_slots=1, max_len=32, eos_id=eos)
    rb, want = _run(ref_batching.ContinuousBatcher, jparams, rcfg, [prompt],
                    [6], **kw)
    pb, got = _run(batching.ContinuousBatcher, pparams, pcfg, [prompt], [6],
                   **kw)
    assert got == {0: free[0][:free[0].index(eos) + 1]}
    assert not assert_streams_agree(pparams, pcfg, {0: prompt}, got, want)
    assert pb.requests[0].finish_reason == rb.requests[0].finish_reason \
        == "stop"
    assert pb.metrics.eos_terminated == 1


def test_batcher_matches_sequential_generate():
    """The port's batcher produces exactly what one-request-at-a-time
    greedy ``engine.generate`` produces (within the port)."""
    _, _, pcfg, pparams = f32_models("tinyllama_1_1b", 0.8)
    prompts = prompts_of(pcfg, [3, 6, 4, 5, 7], seed=0)
    want = {}
    for uid, p in enumerate(prompts):
        out = engine.generate(pparams, torch.from_numpy(p[None]), pcfg,
                              max_new_tokens=4, max_len=32)
        want[uid] = out[0, len(p):].tolist()
    _, got = _run(batching.ContinuousBatcher, pparams, pcfg, prompts,
                  [4] * len(prompts), n_slots=2, max_len=32)
    assert got == want


def test_length_buckets_match_reference():
    for max_len, lo in ((32, 8), (512, 8), (100, 16), (5, 8), (1, 1)):
        assert engine.length_buckets(max_len, lo) == \
            ref_engine.length_buckets(max_len, lo)
        for n in (1, min(lo, max_len), max_len):
            b = engine.length_buckets(max_len, lo)
            assert engine.bucket_for(n, b) == ref_engine.bucket_for(n, b)
    with pytest.raises(ValueError):
        engine.bucket_for(33, engine.length_buckets(32))
    with pytest.raises(ValueError):
        engine.length_buckets(0)


def test_sample_per_slot_is_a_function_of_seed_uid_and_index():
    """The per-slot draw: greedy at T = 0; the same (seed, uid, index)
    draws the same token whatever the row; top-k keeps every draw among
    the k largest logits; the empirical distribution follows the
    softmax."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((4, 50)).astype(np.float32))
    uids = torch.tensor([7, 8, 9, 10])
    counts = torch.tensor([0, 1, 2, 3])
    assert torch.equal(engine.sample_per_slot(logits, None, None),
                       logits.argmax(-1))
    once = engine.sample_per_slot(logits, uids, counts, temperature=0.7,
                                  seed=5)
    perm = torch.tensor([2, 0, 3, 1])
    again = engine.sample_per_slot(logits[perm], uids[perm], counts[perm],
                                   temperature=0.7, seed=5)
    assert torch.equal(again, once[perm])
    draws = torch.stack([engine.sample_per_slot(
        logits, uids, counts + i, temperature=1.0, top_k=3, seed=5)
        for i in range(40)])
    top3 = torch.topk(logits, 3, dim=-1).indices
    assert bool((draws[..., None] == top3[None]).any(-1).all())
    assert len(set(draws.flatten().tolist())) > 4
    other = engine.sample_per_slot(logits, uids, counts, temperature=0.7,
                                   seed=6)
    assert not torch.equal(other, once)                  # seed moves it
    row = torch.tensor([[0.0, 1.0, 2.0]]).expand(4000, 3)
    n = torch.arange(4000)
    picks = engine.sample_per_slot(row, torch.zeros_like(n), n,
                                   temperature=1.0)
    freq = torch.bincount(picks, minlength=3).float() / 4000
    np.testing.assert_allclose(freq.numpy(),
                               torch.softmax(row[0], -1).numpy(), atol=0.03)


def test_graph_refused_on_cpu_and_unported_paths_raise():
    _, _, pcfg, pparams = f32_models("opt_30b", None)
    with pytest.raises(ValueError, match="CUDA"):
        step.DeviceStepper(pparams, pcfg, n_slots=2, max_len=16, graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        batching.ContinuousBatcher(pparams, pcfg, n_slots=2, max_len=16,
                                   graph=True)
    assert not step.DeviceStepper(pparams, pcfg, n_slots=2,
                                  max_len=16).graph
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        batching.ContinuousBatcher(pparams, pcfg, config=config.ServeConfig(
            scheduler=config.SchedulerConfig(n_slots=2, max_len=16),
            cache_kind="paged", spec_k=2))
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        batching.ContinuousBatcher(pparams, pcfg, config=config.ServeConfig(
            scheduler=config.SchedulerConfig(n_slots=2, max_len=16,
                                             chunked_prefill=True),
            cache_kind="paged"))
    st = step.DeviceStepper(pparams, pcfg, n_slots=2, max_len=16)
    for fn in (st.verify, st.mixed):
        with pytest.raises(NotImplementedError, match="queue 1 item 9"):
            fn()


@pytest.mark.parametrize("extra", [[], ["--paged", "--trace-rate", "0.5"]])
def test_cli_serves_through_streaming_server(extra):
    """``launch.serve.main`` serves the closed loop (or, with
    ``--trace-rate``, an open-loop trace) through ``StreamingServer``;
    every request gets its ``--max-new`` tokens."""
    from repro_torch.launch import serve
    rep = serve.main(["--arch", "opt_30b", "--smoke", "--sparsity", "0.8",
                      "--slots", "2", "--requests", "3", "--max-new", "4",
                      "--max-len", "24"] + extra, device="cpu")
    assert len(rep["responses"]) == 3 and rep["shed"] == 0
    assert all(len(r.tokens) == 4 for r in rep["responses"])
    b = rep["server"].batcher
    assert b.paged == ("--paged" in extra) and not b.stepper.graph
    assert rep["ttft"]["n"] == 3
