"""Checkpoints, resume and serving snapshots in the port, on the CPU.

* The reference's ``tests/test_fault_tolerance.py`` cases on the port's
  ``distributed.fault_tolerance`` (all but the elastic re-shard, ROADMAP
  queue 1 item 14): restart-resume bit for bit, no partial checkpoint
  listed, the keep policy, asynchronous save, a shape mismatch, the
  preemption handler, the straggler deadline; and the layout (path keys,
  bf16 leaves as uint16 bits, python scalars).
* A checkpoint that ``repro.launch.train`` writes (tinyllama smoke, 2
  steps: ROADMAP queue 3 item 10's input) restores into the port, and
  the port's next step matches the reference's next step from the same
  checkpoint in f32 (the tolerances of ``test_torch_training``); the
  port's serving CLI serves it (the JAX serving launcher cannot).
* ``launch/train.py``: ``--resume`` continues bit for bit, SIGTERM
  writes the final checkpoint at the step reached, and ``launch.serve
  --ckpt`` encodes a masked checkpoint with exactly its trained masks.
* ``StreamingServer.snapshot``/``restore``: the scenario of
  ``tests/test_faults.py::test_snapshot_restore_exactly_once`` on both
  packages with the same params: every (session, index) delivered
  exactly once, equal to the uninterrupted run, the snapshot payloads
  equal, and the streams equal to the reference's (near-tie rule).
"""

import dataclasses
import json
import os
import shutil
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.distributed import fault_tolerance as ref_ft
from repro.launch import train as ref_train_launch
from repro.serving import api as ref_api
from repro.serving import loadgen as ref_loadgen
from repro.training import data as ref_data
from repro.training import optimizer as ref_opt
from repro.training import train_loop as ref_tl
from repro_torch import convert
from repro_torch.core import tiled_csl
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.launch import serve
from repro_torch.launch import train as train_launch
from repro_torch.models.config import ModelConfig
from repro_torch.serving import api, loadgen
from repro_torch.training import data, optimizer, train_loop
from test_torch_training import _assert_grads, _bridge, _np, _port_cfg
from torch_serving_parity import assert_streams_agree, f32_models, prompts_of


def _cfg():
    return ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                       n_heads=2, n_kv=1, d_ff=64, vocab=64)


def _run(steps, ckpt_dir, resume=False, fail_at=None, every=2):
    cfg = _cfg()
    opt = optimizer.AdamW(lr=1e-3)
    mgr = ft.CheckpointManager(ckpt_dir, keep=2)
    stream = data.SyntheticLM(cfg.vocab, 16, 4, seed=0)
    state = train_loop.init_train_state(cfg, opt, seed=0, device="cpu")
    start = 0
    if resume and mgr.latest_step() is not None:
        (state, data_state), meta = mgr.restore((state, stream.state_dict()))
        stream.load_state_dict(data_state)
        start = meta["step"]
    injector = ft.FailureInjector(fail_at=fail_at)
    step_fn = train_loop.make_train_step(cfg, opt)
    for s in range(start, steps):
        injector.check(s)
        batch = train_loop.batch_to(stream.next_batch(), "cpu")
        state, metrics = step_fn(state, batch)
        if (s + 1) % every == 0:
            mgr.save(s + 1, (state, stream.state_dict()))
    return state, float(metrics["loss"])


def test_restart_resume_bit_exact(tmp_path):
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    state_ref, loss_ref = _run(8, d1)
    with pytest.raises(RuntimeError, match="injected failure"):
        _run(8, d2, fail_at=5)
    state_resumed, loss_resumed = _run(8, d2, resume=True)
    assert loss_ref == loss_resumed
    for tree in ("params", "opt_state"):
        for (p, a), (_, b) in zip(
                ft.flatten_with_paths(getattr(state_ref, tree)),
                ft.flatten_with_paths(getattr(state_resumed, tree))):
            assert torch.equal(a, b), p


def test_atomicity_no_partial_checkpoint(tmp_path):
    """A tmp dir left by a crashed save must never be listed as a step."""
    d = str(tmp_path / "c")
    mgr = ft.CheckpointManager(d, keep=5)
    mgr.save(1, {"w": torch.ones(4)})
    os.makedirs(os.path.join(d, "tmp.99.12345"))   # simulated crash debris
    open(os.path.join(d, "tmp.99.12345", "leaves.npz"), "wb").close()
    assert mgr.all_steps() == [1]
    state, meta = mgr.restore({"w": torch.zeros(4)})
    assert meta["step"] == 1 and torch.equal(state["w"], torch.ones(4))


def test_keep_policy_gc(tmp_path):
    mgr = ft.CheckpointManager(str(tmp_path / "gc"), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": torch.full((2,), float(s))})
    assert mgr.all_steps() == [3, 4]


def test_async_save_matches_sync(tmp_path):
    mgr = ft.CheckpointManager(str(tmp_path / "async"), keep=3,
                               async_save=True)
    tree = {"w": torch.arange(8.0), "b": {"x": torch.ones(3)},
            "l": [torch.zeros(2, dtype=torch.int32)]}
    mgr.save(7, tree)
    tree["w"] += 1.0                  # the leaves were copied at save time
    mgr.wait()
    restored, meta = mgr.restore({"w": torch.zeros(8), "b": {"x":
                                  torch.zeros(3)}, "l": [torch.ones(
                                      2, dtype=torch.int32)]})
    assert torch.equal(restored["w"], torch.arange(8.0))
    assert restored["l"][0].dtype == torch.int32
    assert meta["step"] == 7


def test_async_write_error_reaches_the_caller(tmp_path, monkeypatch):
    mgr = ft.CheckpointManager(str(tmp_path / "err"), async_save=True)

    def fail(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(np, "savez", fail)
    mgr.save(1, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="asynchronous checkpoint"):
        mgr.wait()
    assert mgr.all_steps() == []


def test_restore_shape_mismatch_raises(tmp_path):
    mgr = ft.CheckpointManager(str(tmp_path / "mismatch"))
    mgr.save(1, {"w": torch.ones(4)})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"w": torch.ones(5)})
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore({"v": torch.ones(4)})


def test_preemption_handler():
    h = ft.PreemptionHandler(install=False)
    assert not h.should_stop
    h.request_stop()
    assert h.should_stop


def test_straggler_deadline_hook():
    fired = []
    dl = ft.StepDeadline(0.5, on_straggler=fired.append)
    dl.observe(1, 0.1)
    dl.observe(2, 0.9)
    dl.observe(3, 2.0)
    assert fired == [2, 3] and dl.violations == 2


def test_layout_paths_bf16_bits_and_scalars(tmp_path):
    """The reference's layout over the port's trees: path keys in the
    manifest and the npz, a bf16 leaf as its uint16 bits (named in the
    manifest's ``dtypes``) restored bit for bit, python scalars."""
    d = str(tmp_path / "layout")
    bf = torch.randn(3, 5).to(torch.bfloat16)
    opt = optimizer.AdamW()
    params = {"embed": {"table": torch.randn(4, 2)},
              "layers": [{"w": bf}, {"w": bf + 1}]}
    state = train_loop.TrainState(params, opt.init(params),
                                  torch.tensor(3, dtype=torch.int32))
    ft.CheckpointManager(d).save(3, (state, {"seed": 7, "step": 3}))
    step_dir = os.path.join(d, "step_0000000003")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        meta = json.load(f)
    assert "[0].params['layers'][1]['w']" in meta["leaves"]
    assert "[0].opt_state.mu['embed']['table']" in meta["leaves"]
    assert {"[0].step", "[0].opt_state.step", "[1]['seed']",
            "[1]['step']"} <= set(meta["leaves"])
    assert meta["dtypes"]["[0].params['layers'][0]['w']"] == "bfloat16"
    with np.load(os.path.join(step_dir, "leaves.npz")) as z:
        assert z["[0].params['layers'][0]['w']"].dtype == np.uint16
    template = (train_loop.TrainState(
        {"embed": {"table": torch.zeros(4, 2)},
         "layers": [{"w": torch.zeros(3, 5, dtype=torch.bfloat16)}] * 2},
        opt.init(params), torch.zeros((), dtype=torch.int32)),
        {"seed": 0, "step": 0})
    (got, data_state), meta = ft.CheckpointManager(d).restore(template)
    assert got.params["layers"][0]["w"].dtype == torch.bfloat16
    assert torch.equal(got.params["layers"][0]["w"].view(torch.int16),
                       bf.view(torch.int16))
    assert data_state == {"seed": 7, "step": 3} and int(got.step) == 3
    served, meta = convert.params_from_checkpoint(d, device="cpu")
    assert meta["step"] == 3
    assert torch.equal(served["layers"][1]["w"], (bf + 1).float())
    assert ft.split_path("[0].opt_state.mu['layers'][1]['w']") == \
        [0, "opt_state", "mu", "layers", 1, "w"]


# ---------------------------------------------------------------------------
# a checkpoint the JAX launcher writes (ROADMAP queue 3 item 10's input)
# ---------------------------------------------------------------------------

REF_ARGS = ["--arch", "tinyllama_1_1b", "--smoke", "--steps", "2",
            "--batch", "2", "--seq", "16"]


@pytest.fixture(scope="module")
def ref_ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ref_ckpt"))
    argv = sys.argv
    sys.argv = ["repro.launch.train"] + REF_ARGS + ["--ckpt-dir", d]
    try:
        ref_train_launch.main()
    finally:
        sys.argv = argv
    return d


def test_reference_checkpoint_restores_and_steps_like_reference(ref_ckpt):
    """The port reads the reference's (TrainState, data state) leaves and
    takes the next step (the third) as the reference does from the same
    checkpoint, both in f32."""
    rcfg = dataclasses.replace(ref_configs.smoke("tinyllama_1_1b"),
                               dtype="float32")
    ropt = ref_opt.AdamW(lr=ref_opt.cosine_schedule(3e-4, 20, 2))
    stream = ref_data.SyntheticLM(rcfg.vocab, 16, 2, seed=0)
    template = ref_tl.init_train_state(jax.random.PRNGKey(0), rcfg, ropt)
    (jstate, jdata), _ = ref_ft.CheckpointManager(ref_ckpt).restore(
        (template, stream.state_dict()))
    stream.load_state_dict(jax.tree.map(int, jdata))
    batch = stream.next_batch()
    jbatch = jax.tree.map(jnp.asarray, batch)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_tl.loss_fn(p, b, rcfg), has_aux=True))(
        jstate.params, jbatch)
    jnext, _ = jax.jit(ref_tl.make_train_step(rcfg, ropt))(jstate, jbatch)

    state, data_state, meta = convert.train_state_from_checkpoint(
        ref_ckpt, device="cpu")
    assert meta["step"] == 2 and data_state == {"seed": 0, "step": 2}
    assert int(state.step) == 2 and int(state.opt_state.step) == 2
    for name in ("params", "mu", "nu"):
        got = state.params if name == "params" else getattr(
            state.opt_state, name)
        want = _bridge(_np(jstate.params if name == "params"
                           else getattr(jstate.opt_state, name)))
        for (p, a), (_, b) in zip(ft.flatten_with_paths(got),
                                  ft.flatten_with_paths(want)):
            assert torch.equal(a, b), (name, p)
    pstream = data.SyntheticLM(rcfg.vocab, 16, 2, seed=0)
    pstream.load_state_dict(data_state)
    pb = pstream.next_batch()
    assert pb["tokens"].tobytes() == batch["tokens"].tobytes()
    cfg = _port_cfg("tinyllama_1_1b")
    popt = optimizer.AdamW(lr=optimizer.cosine_schedule(3e-4, 20, 2))
    pbatch = train_loop.batch_to(pb, "cpu")
    loss, _, grads = train_loop.value_and_grad(state.params, pbatch, cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want_grads = _bridge(_np(jgrads))
    tols = _assert_grads(cfg, grads, want_grads)
    nxt, _ = train_loop.make_train_step(cfg, popt)(state, pbatch)
    assert int(nxt.step) == 3
    _assert_next_params(nxt.params, _bridge(_np(jnext.params)), state,
                        want_grads, tols, popt, float(popt.lr(3)))


def _adam_dir(g, m, v, t, scale, b1=0.9, b2=0.95, eps=1e-8):
    g = g * scale
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    return (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps)


def _assert_next_params(got, want, state, grads, tols, opt, lr):
    """The params after an AdamW step from a restored state: within 1e-5
    of the leaf's largest value plus ``lr`` times how far the update
    direction moves when the reference's gradient moves within its
    tolerance (the ends of the interval)."""
    t = int(state.opt_state.step) + 1
    scale = min(1.0, opt.clip_norm / (float(optimizer.global_norm(grads))
                                      + 1e-9))
    mu = dict(ft.flatten_with_paths(state.opt_state.mu))
    nu = dict(ft.flatten_with_paths(state.opt_state.nu))
    g_of = dict(ft.flatten_with_paths(grads))
    want_of = dict(ft.flatten_with_paths(want))
    for path, p in ft.flatten_with_paths(got):
        w, g = want_of[path], g_of[path]
        u = _adam_dir(g, mu[path], nu[path], t, scale)
        du = torch.maximum(
            (_adam_dir(g + tols[path], mu[path], nu[path], t, scale)
             - u).abs(),
            (_adam_dir(g - tols[path], mu[path], nu[path], t, scale)
             - u).abs())
        bound = 1e-5 * float(w.abs().max()) + lr * du * (1 + 1e-5)
        err = (p - w).abs()
        assert bool((err <= bound).all()), (
            f"param {path}: {float((err - bound).max()):.3e} past the bound")


def test_port_serves_a_reference_checkpoint(ref_ckpt, capsys):
    """ROADMAP queue 3 item 10: the JAX serving launcher restores onto a
    bare params template and cannot read its own trainer's checkpoint;
    the port's ``--ckpt`` takes the params subtree."""
    rep = serve.main(["--arch", "tinyllama_1_1b", "--smoke", "--ckpt",
                      ref_ckpt, "--requests", "3", "--slots", "2",
                      "--max-new", "4"], device="cpu")
    assert "params from" in capsys.readouterr().out
    assert len(rep["responses"]) == 3
    params, _ = convert.params_from_checkpoint(ref_ckpt, device="cpu")
    layer = rep["server"].batcher.params["layers"][1]["mlp"]["down"]["w"]
    assert torch.equal(layer, params["layers"][1]["mlp"]["down"]["w"].to(
        layer.dtype))


# ---------------------------------------------------------------------------
# launch/train.py: resume, preemption, and --ckpt into serving
# ---------------------------------------------------------------------------

ARGS = ["--arch", "tinyllama_1_1b", "--smoke", "--batch", "2", "--seq", "16",
        "--sparsity", "0.8", "--log-every", "1"]


def _same_state(a, b):
    for tree in ("params", "opt_state"):
        for (p, x), (_, y) in zip(ft.flatten_with_paths(getattr(a, tree)),
                                  ft.flatten_with_paths(getattr(b, tree))):
            assert torch.equal(x, y), p


def test_cli_resume_is_bit_exact(tmp_path):
    straight = train_launch.main(ARGS + ["--steps", "4"], device="cpu")
    d = str(tmp_path / "run")
    train_launch.main(ARGS + ["--steps", "4", "--ckpt-dir", d,
                              "--ckpt-every", "2"], device="cpu")
    ft_mgr = ft.CheckpointManager(d)
    assert ft_mgr.all_steps() == [2, 4]
    with open(os.path.join(d, "step_0000000004", "manifest.json")) as f:
        assert json.load(f)["extra"] == {"sparsity": 0.8}
    shutil.rmtree(os.path.join(d, "step_0000000004"))   # as if cut at 2
    resumed = train_launch.main(ARGS + ["--steps", "4", "--ckpt-dir", d,
                                        "--resume"], device="cpu")
    _same_state(straight["state"], resumed["state"])
    assert [r["loss"] for r in resumed["log"]] == \
        [r["loss"] for r in straight["log"]][2:]


def test_sigterm_writes_the_final_checkpoint_at_the_step_reached(
        tmp_path, monkeypatch):
    d = str(tmp_path / "pre")
    make = train_loop.make_train_step

    def make_step(*a, **k):
        step = make(*a, **k)
        calls = []

        def wrapped(state, batch):
            calls.append(1)
            if len(calls) == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return step(state, batch)
        return wrapped
    monkeypatch.setattr(train_loop, "make_train_step", make_step)
    before = signal.getsignal(signal.SIGTERM)
    out = train_launch.main(ARGS + ["--steps", "6", "--ckpt-dir", d],
                            device="cpu")
    assert signal.getsignal(signal.SIGTERM) == before
    assert out["steps"] == 2
    assert ft.CheckpointManager(d).all_steps() == [2]


def test_served_checkpoint_keeps_the_trained_masks(tmp_path):
    d = str(tmp_path / "masked")
    out = train_launch.main(ARGS + ["--steps", "3", "--ckpt-dir", d],
                            device="cpu")
    counts = train_launch.mask_counts(out["masks"])
    rep = serve.main(["--arch", "tinyllama_1_1b", "--smoke", "--ckpt", d,
                      "--sparsity", "0.8", "--requests", "2", "--slots", "2",
                      "--max-new", "3"], device="cpu")
    layers = rep["server"].batcher.params["layers"]
    grouped = {"wq": ("wqkv", 0), "wk": ("wqkv", 1), "wv": ("wqkv", 2),
               "gate": ("gate_up", 0), "up": ("gate_up", 1)}
    for path, n in counts.items():
        _, i, sub, name, _ = ft.split_path(path)   # layers, i, sub, name, w
        leaf = layers[i][sub]
        if name in grouped and grouped[name][0] in leaf:
            t = tiled_csl.group_slice(leaf[grouped[name][0]]["w"],
                                      grouped[name][1])
        else:
            t = leaf[name]["w"]
        assert int(t.nnz.sum()) == n, path
    # at another sparsity the trained weights are pruned as random ones
    rep = serve.main(["--arch", "tinyllama_1_1b", "--smoke", "--ckpt", d,
                      "--sparsity", "0.9", "--requests", "1", "--slots", "1",
                      "--max-new", "2"], device="cpu")
    t = rep["server"].batcher.params["layers"][0]["attn"]["wo"]["w"]
    assert int(t.nnz.sum()) < counts["['layers'][0]['attn']['wo']['w']"]


# ---------------------------------------------------------------------------
# StreamingServer snapshots
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    return f32_models("tinyllama_1_1b", 0.8)


def _server(mod, params, cfg, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("cache_kind", "paged")
    kw.setdefault("block_size", 4)
    kw.setdefault("n_blocks", 16)
    return mod.StreamingServer(params, cfg, **kw)


def _drained(server):
    assert not server.busy and server.live_sessions() == []
    server.batcher.pool.check_invariants()
    assert server.batcher.pool.blocks_in_use == 0


def _snapshot_scenario(api_mod, loadgen_mod, params, cfg, prompts, tmp):
    """test_faults.py's scenario: the uninterrupted run, then a run killed
    after step 3 right after a snapshot and restored into a new server.
    Returns (uninterrupted events, events across the restore, payload)."""
    def spin(server, clock, stop_after=None):
        for step in range(100):
            server.step()
            clock.tick()
            if stop_after is not None and step + 1 == stop_after:
                return
            if not server.busy:
                return

    def submit(server, events):
        for i, p in enumerate(prompts):
            server.submit(api_mod.GenerationRequest(
                p, 8, session_id=f"s{i}", on_token=events.append))

    ref_events, events = [], []
    clock0 = loadgen_mod.StepClock(dt=1.0)
    whole = _server(api_mod, params, cfg, clock=clock0)
    submit(whole, ref_events)
    spin(whole, clock0)
    _drained(whole)

    clock1 = loadgen_mod.StepClock(dt=1.0)
    server = _server(api_mod, params, cfg, clock=clock1)
    submit(server, events)
    spin(server, clock1, stop_after=3)
    assert server.busy and events
    path = server.snapshot(tmp)
    with open(path) as f:
        payload = json.load(f)
    clock2 = loadgen_mod.StepClock(dt=1.0)
    restored = api_mod.StreamingServer.restore(
        tmp, params, cfg, on_token=events.append, n_slots=2, max_len=32,
        cache_kind="paged", block_size=4, n_blocks=16, clock=clock2)
    assert clock2.t == clock1.t
    assert sorted(restored.live_sessions()) == sorted(server.live_sessions())
    spin(restored, clock2)
    _drained(restored)
    return ref_events, events, payload


def _streams(evs):
    out = {}
    for ev in evs:
        out.setdefault(ev.session_id, []).append((ev.index, ev.token))
    return out


def test_snapshot_restore_exactly_once_like_reference(model, tmp_path):
    rcfg, jparams, pcfg, pparams = model
    prompts = prompts_of(pcfg, [3, 5, 4])
    whole, across, payload = _snapshot_scenario(
        api, loadgen, pparams, pcfg, prompts, str(tmp_path / "port"))
    got = _streams(across)
    for sid, pairs in got.items():
        idx = [i for i, _ in pairs]
        assert idx == list(range(len(idx))), \
            f"{sid}: duplicated, out-of-order or missing delivery"
    assert got == _streams(whole)
    r_whole, r_across, r_payload = _snapshot_scenario(
        ref_api, ref_loadgen, jparams, rcfg, prompts, str(tmp_path / "ref"))
    assert _streams(r_across) == _streams(r_whole)
    want = {sid: [t for _, t in pairs]
            for sid, pairs in _streams(r_whole).items()}
    ties = assert_streams_agree(
        pparams, pcfg, {f"s{i}": p for i, p in enumerate(prompts)},
        {sid: [t for _, t in pairs] for sid, pairs in got.items()}, want)
    if not ties:
        assert payload == r_payload


def test_restore_without_a_snapshot_raises(model, tmp_path):
    _, _, pcfg, pparams = model
    with pytest.raises(FileNotFoundError, match="no snapshot"):
        api.StreamingServer.restore(str(tmp_path), pparams, pcfg, n_slots=2,
                                    max_len=32)


def test_cli_snapshot_dir_writes_and_restores(tmp_path, capsys):
    d = str(tmp_path / "snap")
    args = ["--arch", "tinyllama_1_1b", "--smoke", "--requests", "2",
            "--slots", "2", "--max-new", "3", "--snapshot-dir", d]
    rep = serve.main(args, device="cpu")
    assert os.path.exists(rep["snapshot"])
    serve.main(args, device="cpu")
    out = capsys.readouterr().out
    assert "restored 0 in-flight session(s)" in out
    assert len(ft.SnapshotStore(d).all_seqs()) == 2
