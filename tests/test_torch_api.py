"""The session API: each scenario of ``test_serving_api.py`` (streaming
order, cancellation in every state, rejection, backpressure, latency
stamps, the load generator) and a fault-injection scenario run on the
reference's ``StreamingServer`` and on the port's, with the same params
(TinyLlama smoke, f32, sparsity 0.8), and the observations match: the
same streams (under the near-tie rule of ``torch_serving_parity``),
finish reasons, exceptions and their fields, metrics and pool state.
"""

import numpy as np
import pytest

from repro.serving import api as ref_api
from repro.serving import batching as ref_batching
from repro.serving import faults as ref_faults
from repro.serving import loadgen as ref_loadgen
from repro_torch.serving import api, batching, faults, loadgen
from torch_serving_parity import assert_streams_agree, f32_models, prompts_of

PORT = (api, batching, loadgen, faults)
REF = (ref_api, ref_batching, ref_loadgen, ref_faults)


@pytest.fixture(scope="module")
def model():
    return f32_models("tinyllama_1_1b", 0.8)


def _server(mods, params, cfg, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("cache_kind", "paged")
    kw.setdefault("block_size", 4)
    kw.setdefault("n_blocks", 16)
    return mods[0].StreamingServer(params, cfg, **kw)


def _clean(server):
    """The drained-clean state, as data."""
    pool = server.batcher.pool
    pool.check_invariants()
    return (server.busy, server.live_sessions(), pool.blocks_in_use)


def _both(model, scenario):
    """Run ``scenario(mods, params, cfg, prompts)`` on both packages; it
    returns (streams {sid: tokens}, prompts {sid: prompt}, observations).
    Streams agree under the near-tie rule; observations are equal."""
    rcfg, jparams, pcfg, pparams = model
    s_ref, prompts, o_ref = scenario(REF, jparams, rcfg)
    s_port, _, o_port = scenario(PORT, pparams, pcfg)
    ties = assert_streams_agree(pparams, pcfg, prompts, s_port, s_ref)
    if not ties:
        assert o_port == o_ref
    return o_port


def _stream_order(mods, params, cfg):
    prompts = prompts_of(cfg, [3, 6, 4, 5])
    events = {}
    server = _server(mods, params, cfg)
    for i, p in enumerate(prompts):
        server.submit(mods[0].GenerationRequest(
            p, max_new_tokens=5, session_id=f"s{i}",
            on_token=lambda ev: events.setdefault(ev.session_id,
                                                  []).append(ev)))
    responses = {r.session_id: r for r in server.run_until_drained()}
    obs = {}
    for sid, resp in responses.items():
        evs = events[sid]
        obs[sid] = ([e.index for e in evs] == list(range(len(resp.tokens))),
                    [e.token for e in evs] == resp.tokens,
                    [e.finish_reason for e in evs])
    b = mods[1].ContinuousBatcher(params, cfg, n_slots=2, max_len=32,
                                  cache_kind="paged", block_size=4,
                                  n_blocks=16)
    for i, p in enumerate(prompts):
        b.submit(i, p, 5)
    want = b.run_to_completion()
    obs["batcher"] = {f"s{u}": t for u, t in want.items()} == \
        {sid: r.tokens for sid, r in responses.items()}
    obs["clean"] = _clean(server)
    return ({sid: r.tokens for sid, r in responses.items()},
            {f"s{i}": p for i, p in enumerate(prompts)}, obs)


def test_stream_matches_batcher_and_orders_tokens(model):
    obs = _both(model, _stream_order)
    assert obs["batcher"] and obs["clean"] == (False, [], 0)
    for sid in ("s0", "s1", "s2", "s3"):
        assert obs[sid][:2] == (True, True)
        assert obs[sid][2] == [""] * 4 + ["max_new_tokens"]


def _cancel_queued(mods, params, cfg):
    prompts = prompts_of(cfg, [3, 4, 5, 6])
    server = _server(mods, params, cfg)
    for i, p in enumerate(prompts):
        server.submit(mods[0].GenerationRequest(p, 6, session_id=f"s{i}"))
    depth = server.queue_depth
    resp = server.cancel("s3")
    got = {r.session_id: r.tokens for r in server.run_until_drained()}
    obs = dict(depth=depth, reason=resp.finish_reason, tokens=resp.tokens,
               ttft=resp.ttft_s, cancelled=server.metrics.cancelled,
               clean=_clean(server))
    return got, {f"s{i}": p for i, p in enumerate(prompts)}, obs


def _cancel_just_admitted(mods, params, cfg):
    p = prompts_of(cfg, [5])[0]
    server = _server(mods, params, cfg)
    server.submit(mods[0].GenerationRequest(p, 8, session_id="x"))
    server.step()
    held = server.batcher.pool.blocks_in_use
    resp = server.cancel("x")
    obs = dict(held=held, reason=resp.finish_reason,
               has_ttft=resp.ttft_s is not None, clean=_clean(server))
    return {"x": resp.tokens}, {"x": p}, obs


def _cancel_mid_decode(mods, params, cfg):
    prompts = prompts_of(cfg, [3, 4, 5])
    server = _server(mods, params, cfg, n_slots=3)
    for i, p in enumerate(prompts):
        server.submit(mods[0].GenerationRequest(p, 8, session_id=f"s{i}"))
    for _ in range(3):
        server.step()
    before = server.batcher.pool.blocks_in_use
    resp = server.cancel("s2")
    after = server.batcher.pool.blocks_in_use
    got = {r.session_id: r.tokens for r in server.run_until_drained()}
    got["s2"] = resp.tokens
    obs = dict(before=before, after=after, reason=resp.finish_reason,
               clean=_clean(server))
    return got, {f"s{i}": p for i, p in enumerate(prompts)}, obs


def _cancel_preempted(mods, params, cfg):
    prompts = prompts_of(cfg, [3, 4, 5], seed=4)
    server = _server(mods, params, cfg, n_slots=3, block_size=4, n_blocks=6)
    for i, p in enumerate(prompts):
        server.submit(mods[0].GenerationRequest(p, 12, session_id=f"s{i}"))
    victim, steps = None, 0
    for steps in range(200):
        server.step()
        if server.metrics.preemptions > 0:
            victim = next((f"s{i}" for i in range(3)
                           if (r := server.batcher.requests.get(i))
                           is not None and not r.done and r.pending
                           and r.generated), None)
        if victim or not server.busy:
            break
    resp = server.cancel(victim)
    done = server.run_until_drained()
    got = {r.session_id: r.tokens for r in done}
    got[victim] = resp.tokens
    obs = dict(victim=victim, steps=steps, reason=resp.finish_reason,
               reasons=sorted(r.finish_reason for r in done),
               clean=_clean(server))
    return got, {f"s{i}": p for i, p in enumerate(prompts)}, obs


def _cancel_unknown_and_double(mods, params, cfg):
    server = _server(mods, params, cfg)
    server.submit(mods[0].GenerationRequest(prompts_of(cfg, [3])[0], 4,
                                            session_id="a"))
    obs = dict(unknown=server.cancel("nope"),
               first=server.cancel("a").finish_reason,
               second=server.cancel("a"),
               cancelled=server.metrics.cancelled, clean=_clean(server))
    return {}, {}, obs


@pytest.mark.parametrize("scenario", [
    _cancel_queued, _cancel_just_admitted, _cancel_mid_decode,
    _cancel_preempted, _cancel_unknown_and_double],
    ids=lambda f: f.__name__.lstrip("_"))
def test_cancel_in_every_state_matches_reference(model, scenario):
    obs = _both(model, scenario)
    assert obs["clean"] == (False, [], 0)
    assert obs.get("reason", "cancelled") == "cancelled"
    if scenario is _cancel_preempted:
        assert obs["victim"] is not None
        assert obs["reasons"] == ["max_new_tokens"] * 2
    if scenario is _cancel_queued:
        assert obs["depth"] >= 2 and obs["tokens"] == []


def _rejections(mods, params, cfg):
    api_mod = mods[0]
    server = _server(mods, params, cfg, n_blocks=4)
    obs = {}
    for name, req in (
            ("big", api_mod.GenerationRequest(prompts_of(cfg, [20])[0], 16,
                                              session_id="big")),
            ("2d", api_mod.GenerationRequest(np.zeros((2, 3), np.int64), 4))):
        with pytest.raises(api_mod.RequestRejected) as ei:
            server.submit(req)
        obs[name] = str(ei.value)
    obs["empty"] = (server.live_sessions(), server.queue_depth, server.busy,
                    len(server.batcher.requests))
    p = prompts_of(cfg, [3])[0]
    obs["sid"] = server.submit(api_mod.GenerationRequest(p, 4,
                                                         session_id="big"))
    out = server.run_until_drained()
    with pytest.raises(api_mod.RequestRejected, match="still live"):
        server.submit(api_mod.GenerationRequest(p, 4, session_id="dup"))
        server.submit(api_mod.GenerationRequest(p, 4, session_id="dup"))
    server.run_until_drained()
    obs["reuse"] = server.submit(api_mod.GenerationRequest(p, 4,
                                                           session_id="dup"))
    server.run_until_drained()
    obs["clean"] = _clean(server)
    return {"big": out[0].tokens}, {"big": p}, obs


def test_rejected_and_duplicate_submits_match_reference(model):
    obs = _both(model, _rejections)
    assert "KV blocks" in obs["big"] and "1-D" in obs["2d"]
    assert obs["empty"] == ([], 0, False, 0)
    assert obs["sid"] == "big" and obs["reuse"] == "dup"


def _backpressure(mods, params, cfg):
    api_mod = mods[0]
    prompts = prompts_of(cfg, [3, 4, 5, 6])
    server = _server(mods, params, cfg, max_queue=1)
    for i, p in enumerate(prompts[:3]):
        server.submit(api_mod.GenerationRequest(p, 6, session_id=f"s{i}"))
        if i < 2:
            server.step()
    with pytest.raises(api_mod.Backpressure) as ei:
        server.submit(api_mod.GenerationRequest(prompts[3], 6,
                                                session_id="s3"))
    e = ei.value
    obs = dict(fields=(e.queue_depth, e.max_queue, e.blocks_available,
                       e.reason), live=server.live_sessions(),
               absent="s3" not in server.batcher.requests)
    got = {r.session_id: r.tokens for r in server.run_until_drained()}
    obs["sid"] = server.submit(api_mod.GenerationRequest(prompts[3], 6,
                                                         session_id="s3"))
    got.update({r.session_id: r.tokens for r in server.run_until_drained()})
    obs["clean"] = _clean(server)
    return got, {f"s{i}": p for i, p in enumerate(prompts)}, obs


def test_backpressure_sheds_and_recovers_like_reference(model):
    obs = _both(model, _backpressure)
    assert obs["fields"][:2] == (1, 1) and obs["fields"][3] == "queue_full"
    assert obs["live"] == ["s0", "s1", "s2"] and obs["absent"]
    assert obs["sid"] == "s3"


def _virtual_clock(mods, params, cfg):
    clock = mods[2].StepClock(dt=1.0)
    server = _server(mods, params, cfg, clock=clock)
    prompts = prompts_of(cfg, [3, 4, 5])
    for i, p in enumerate(prompts):
        server.submit(mods[0].GenerationRequest(p, 6, session_id=f"s{i}"))
    server.step()
    server.cancel("s1")                 # cancelled latencies are excluded
    responses = {}
    for _ in range(40):
        clock.tick()
        for r in server.step():
            responses[r.session_id] = r
        if not server.busy:
            break
    m = server.metrics.as_dict()
    obs = {sid: (r.ttft_s, r.tpot_s, r.submit_t, r.finish_t)
           for sid, r in responses.items()}
    obs.update(ttft=m["ttft"], tpot=m["tpot"], cancelled=m["cancelled"],
               clean=_clean(server))
    return ({sid: r.tokens for sid, r in responses.items()},
            {f"s{i}": p for i, p in enumerate(prompts)}, obs)


def test_virtual_clock_latency_stamps_match_reference(model):
    obs = _both(model, _virtual_clock)
    assert obs["s0"][0] == 0.0 and obs["s2"][0] > 0.0
    assert obs["ttft"]["n"] == 2 and obs["cancelled"] == 1


def _replay(mods, params, cfg):
    trace = mods[2].open_loop_trace(seed=11, n_requests=8, rate=0.6,
                                    vocab=cfg.vocab)
    clock = mods[2].StepClock(dt=1.0)
    server = _server(mods, params, cfg, n_slots=3, clock=clock)
    res = mods[2].replay(server, trace, clock)
    s = res.summary()
    obs = dict(virtual=s["virtual"], completed=s["completed"],
               rejected=s["rejected"], steps=res.steps,
               fingerprint=mods[2].trace_fingerprint(trace),
               clean=_clean(server))
    return ({r.session_id: r.tokens for r in res.responses},
            {f"{t.tenant}/{t.rid}": t.prompt for t in trace}, obs)


def test_replay_and_trace_fingerprint_match_reference(model):
    obs = _both(model, _replay)
    assert obs["completed"] == 8 and obs["rejected"] == 0
    for seed in (3, 4):
        kw = dict(seed=seed, n_requests=20, rate=0.5, vocab=256)
        assert loadgen.trace_fingerprint(loadgen.open_loop_trace(**kw)) == \
            ref_loadgen.trace_fingerprint(ref_loadgen.open_loop_trace(**kw))
    spec = dict(prefix_len=0, suffix_len=(32, 385), max_new=(64, 65))
    kw = dict(seed=0, n_requests=32, rate=0.125, vocab=50272)
    t = loadgen.make_trace(tenants=[loadgen.TenantSpec("t", **spec)], **kw)
    r = ref_loadgen.make_trace(tenants=[ref_loadgen.TenantSpec("t", **spec)],
                               **kw)
    assert loadgen.trace_fingerprint(t) == ref_loadgen.trace_fingerprint(r)
    assert all(32 <= len(x.prompt) <= 384 and x.max_new_tokens == 64
               for x in t)


def _faults(mods, params, cfg):
    """A NaN row at a decode step and at a prefill, two transient decode
    errors, a pool storm and a slow step: quarantine, retries and the
    clock move as in the reference."""
    f = mods[3]
    plan = f.FaultPlan([
        f.FaultEvent(step=2, kind="nan_logits", slot=1, op="decode"),
        f.FaultEvent(step=3, kind="nan_logits", slot=0, op="prefill"),
        f.FaultEvent(step=3, kind="step_error", op="decode", attempts=2),
        f.FaultEvent(step=5, kind="pool_storm", blocks=6, duration=2),
        f.FaultEvent(step=6, kind="slow_step", delay_s=0.5)])
    clock = mods[2].StepClock(dt=1.0)
    server = _server(mods, params, cfg, n_slots=3, clock=clock,
                     fault_plan=plan)
    prompts = prompts_of(cfg, [3, 5, 4, 6, 7], seed=2)
    for i, p in enumerate(prompts):
        server.submit(mods[0].GenerationRequest(p, 8, session_id=f"s{i}"))
    done = []
    for _ in range(200):
        done += server.step()
        clock.tick()
        if not server.busy:
            break
    m = server.metrics
    rep = server.batcher.faults.report()
    obs = dict(reasons={r.session_id: r.finish_reason for r in done},
               quarantined=m.quarantined, retries=m.step_retries,
               fired=rep["fired"], by_kind=rep["by_kind"],
               t=clock.t, clean=_clean(server))
    return ({r.session_id: r.tokens for r in done},
            {f"s{i}": p for i, p in enumerate(prompts)}, obs)


def test_fault_injection_matches_reference(model):
    obs = _both(model, _faults)
    assert obs["fired"] == 5 and obs["by_kind"]["nan_logits"] == 2
    assert obs["retries"] == 2
    assert list(obs["reasons"].values()).count("quarantined") == \
        obs["quarantined"] >= 2


def test_drafter_reaches_the_batcher_like_reference(model):
    """``StreamingServer(drafter=...)`` hands the drafter to its batcher
    and scheduler, which draft with it; the sessions' streams and the
    speculative counters match the reference's server given the
    reference's drafter."""
    from repro.serving import speculative as ref_speculative
    from repro_torch.serving import speculative
    rcfg, jparams, pcfg, pparams = model
    rng = np.random.default_rng(12)
    prompts = [np.tile(rng.integers(0, pcfg.vocab, 3).astype(np.int64), 4)
               for _ in range(3)]
    seen = {}
    for name, mods, params, cfg, drafter in (
            ("port", PORT, pparams, pcfg, speculative.NgramDrafter(2)),
            ("ref", REF, jparams, rcfg, ref_speculative.NgramDrafter(2))):
        server = _server(mods, params, cfg, spec_k=3, drafter=drafter)
        assert server.batcher.drafter is drafter
        assert server.batcher.sched.drafter is drafter
        for i, p in enumerate(prompts):
            server.submit(mods[0].GenerationRequest(p, 8, session_id=f"s{i}"))
        out = {r.session_id: r.tokens for r in server.run_until_drained()}
        m = server.metrics
        seen[name] = (out, (m.drafted, m.accepted, m.steps),
                      _clean(server))
    assert seen["port"][1][0] > 0
    if not assert_streams_agree(
            pparams, pcfg, {f"s{i}": p for i, p in enumerate(prompts)},
            seen["port"][0], seen["ref"][0]):
        assert seen["port"][1:] == seen["ref"][1:]
