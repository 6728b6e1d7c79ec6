"""Training in the port against the reference, on the CPU at smoke sizes.

The same numpy inputs, made from a seed, go through the JAX function and
its port:

* data: ``SyntheticLM`` (codebooks, host shards), ``TextFileStream`` and
  ``ByteTokenizer`` batches byte for byte, iterator state round trips;
* optimizer: ``AdamW`` and ``SGDM`` updates (with masks and clipping),
  ``cosine_schedule``/``linear_schedule`` (int and 0-d steps) and
  ``global_norm`` within ``OPT_TOL`` (1e-6);
* one f32 train step of every family's smoke config (the reference's
  params through ``convert``, its batch from ``SyntheticLM``): loss, ce
  and aux within 1e-5 relative, every gradient leaf and every updated
  param through the bridge (``_assert_grads``, ``_assert_params``);
* step variants: microbatches 2 against 1, remat ``full`` and ``dots``
  against ``none``;
* masks: bit-equal to the reference launcher's rule on a scan config and
  a ``layer_pattern`` config (none masked), held at 0 over 3 steps;
* ``launch/train.py`` through ``main([...], device="cpu")``.

Gradient tolerance. Both packages round attention's K and V to bf16 on
the train path (``repro/models/attention.py:207-208``), and the backward
of that rounding rounds the K/V cotangents to bf16 too. Two f32
implementations whose values differ in the last bits round a few
elements to neighbouring bf16 values, one bf16 ulp (2^-8) apart, in the
forward pass (which moves everything after it) and in the backward pass
(everything before it). So in a family with GQA attention every
gradient leaf is held within ``2^-8`` of its largest absolute value;
the SSM's and MLA's train paths round nothing, and there every leaf is
held within ``1e-5``. Updated params: AdamW's first step
moves a param by ``lr * g / (|g| + eps)``, about the sign of ``g``, so
it magnifies a gradient difference near ``g = 0`` up to ``2 lr``. A param
is held within ``1e-5`` of its leaf's largest value plus ``lr`` times
the change of that direction across the reference gradient's own
tolerance (``_assert_params``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import transformer as ref_tf
from repro.training import data as ref_data
from repro.training import optimizer as ref_opt
from repro.training import train_loop as ref_tl
from repro_torch import configs, convert
from repro_torch.core import pruning
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.launch import train as train_launch
from repro_torch.models import transformer
from repro_torch.training import data, optimizer, train_loop

ARCHS = ("opt_30b", "tinyllama_1_1b", "minicpm3_4b", "qwen2_moe_a2_7b",
         "recurrentgemma_9b", "mamba2_130m", "qwen2_vl_2b", "musicgen_large")
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-5                 # of the leaf's largest absolute value
KV_ROUND_TOL = 2.0 ** -8        # one bf16 ulp of a K/V cotangent
LR = 3e-4 / 20                  # the launcher's lr at step 1 (warmup 20)
BATCH, SEQ = 2, 17              # 16 positions a row


def _ref_opt():
    return ref_opt.AdamW(lr=ref_opt.cosine_schedule(3e-4, 20, 100))


def _port_opt():
    return optimizer.AdamW(lr=optimizer.cosine_schedule(3e-4, 20, 100))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@functools.lru_cache(maxsize=None)
def _ref_step(arch):
    """The reference's f32 smoke config, params, one batch, its (loss,
    parts, grads) and the params after one AdamW step, as numpy."""
    rcfg = dataclasses.replace(ref_configs.smoke(arch), dtype="float32")
    jparams = ref_tf.init_model(jax.random.PRNGKey(0), rcfg)
    batch = ref_data.SyntheticLM(rcfg.vocab, SEQ, BATCH, seed=0,
                                 n_codebooks=rcfg.n_codebooks).next_batch()
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: ref_tl.loss_fn(p, b, rcfg), has_aux=True))
    (loss, parts), grads = vg(jparams, jax.tree.map(jnp.asarray, batch))
    opt = _ref_opt()
    new_params, _ = jax.jit(opt.update)(grads, opt.init(jparams), jparams)
    return (rcfg, _np(jparams), batch, float(loss),
            {k: float(v) for k, v in parts.items()}, _np(grads),
            _np(new_params))


def _port_cfg(arch, **kw):
    return dataclasses.replace(configs.smoke(arch), dtype="float32", **kw)


def _bridge(tree):
    return convert.params_from_numpy(tree, device="cpu")


def _rounds_kv(cfg):
    """Does the train path round K/V to bf16 (a GQA attention layer)?"""
    return cfg.attn_kind != "mla" and any(
        cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))


def _grad_tols(cfg, want):
    """{path: absolute tolerance} of every gradient leaf."""
    rel = KV_ROUND_TOL if _rounds_kv(cfg) else LEAF_TOL
    out = {}
    for path, w in ft.flatten_with_paths(want):
        out[path] = rel * (float(w.abs().max()) if w.numel() else 0.0)
    return out


def _assert_grads(cfg, got, want):
    tols = _grad_tols(cfg, want)
    for (path, g), (_, w) in zip(ft.flatten_with_paths(got),
                                 ft.flatten_with_paths(want)):
        err = float((g - w).abs().max()) if w.numel() else 0.0
        assert err <= tols[path], f"grad {path}: {err:.3e} > {tols[path]:.3e}"
    return tols


def _step1(g, scale):
    """AdamW's first update direction of gradient ``g`` (before weight
    decay): m / (sqrt(v) + eps) with m = g, v = g^2 after the bias
    corrections, of the clipped gradient."""
    gc = g * scale
    return gc / (gc.abs() + 1e-8)


def _assert_params(got, want, grads, tols, lr=LR):
    """Each updated param within ``LEAF_TOL`` of its leaf's largest value,
    plus ``lr`` times how far the first update direction moves when the
    reference's gradient moves within its tolerance (monotone in g, so
    the ends of the interval bound it)."""
    gnorm = float(optimizer.global_norm(grads))
    scale = min(1.0, 1.0 / (gnorm + 1e-9))
    for (path, p), (_, w), (_, g) in zip(ft.flatten_with_paths(got),
                                         ft.flatten_with_paths(want),
                                         ft.flatten_with_paths(grads)):
        if not w.numel():
            continue
        u = _step1(g, scale)
        du = torch.maximum((_step1(g + tols[path], scale) - u).abs(),
                           (_step1(g - tols[path], scale) - u).abs())
        bound = LEAF_TOL * float(w.abs().max()) + lr * du * (1 + 1e-5)
        err = (p - w).abs()
        assert bool((err <= bound).all()), (
            f"param {path}: {float((err - bound).max()):.3e} past the bound")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_codebooks,host_index,host_count",
                         [(0, 0, 1), (4, 0, 1), (0, 1, 2)])
def test_synthetic_batches_are_the_references_byte_for_byte(
        n_codebooks, host_index, host_count):
    kw = dict(seed=5, n_codebooks=n_codebooks, host_index=host_index,
              host_count=host_count)
    want = ref_data.SyntheticLM(97, 12, 4, **kw)
    got = data.SyntheticLM(97, 12, 4, **kw)
    for _ in range(3):
        a, b = got.next_batch(), want.next_batch()
        for k in ("tokens", "targets"):
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    assert got.state_dict() == want.state_dict() == {"seed": 5, "step": 3}
    again = data.SyntheticLM(97, 12, 4, **kw)
    again.load_state_dict(want.state_dict())
    assert again.next_batch()["tokens"].tobytes() == \
        want.next_batch()["tokens"].tobytes()


def test_text_stream_and_tokenizer_are_the_references():
    text = "Flash-LLM: load as sparse, compute as dense. " * 7
    want = ref_data.TextFileStream(text, 10, 3, seed=2)
    got = data.TextFileStream(text, 10, 3, seed=2)
    for _ in range(2):
        a, b = got.next_batch(), want.next_batch()
        assert a["tokens"].tobytes() == b["tokens"].tobytes()
        assert a["targets"].tobytes() == b["targets"].tobytes()
    assert got.state_dict() == want.state_dict()
    tok, rtok = data.ByteTokenizer(), ref_data.ByteTokenizer()
    ids = tok.encode("héllo")
    assert ids.tobytes() == rtok.encode("héllo").tobytes()
    assert tok.decode(list(ids) + [tok.PAD]) == rtok.decode(
        list(ids) + [rtok.PAD]) == "héllo"


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _random_tree(rng, scale=1.0):
    return {"a": (scale * rng.standard_normal((4, 8))).astype(np.float32),
            "b": {"c": (scale * rng.standard_normal(16)).astype(np.float32),
                  "d": (scale * rng.standard_normal((3, 5))).astype(
                      np.float32)},
            "layers": [{"w": (scale * rng.standard_normal((6, 2))).astype(
                np.float32)} for _ in range(2)]}


def _to_port(tree):
    return optimizer.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, **tol):
    for (path, a), (_, b) in zip(ft.flatten_with_paths(got),
                                 ft.flatten_with_paths(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   err_msg=path, **(tol or OPT_TOL))


@pytest.mark.parametrize("kind", ["adamw", "sgdm"])
@pytest.mark.parametrize("clip", [1.0, None])
def test_optimizer_updates_match_reference(kind, clip):
    rng = np.random.default_rng(0)
    params = _random_tree(rng)
    mask_a = rng.random((4, 8)) > 0.5
    masks = {"a": mask_a, "b": {"c": None, "d": None},
             "layers": [{"w": None}, {"w": None}]}
    if kind == "adamw":
        ref = ref_opt.AdamW(lr=ref_opt.cosine_schedule(0.1, 2, 10),
                            clip_norm=clip)
        port = optimizer.AdamW(lr=optimizer.cosine_schedule(0.1, 2, 10),
                               clip_norm=clip)
    else:
        ref = ref_opt.SGDM(lr=ref_opt.linear_schedule(0.05, 2, 10),
                           clip_norm=clip)
        port = optimizer.SGDM(lr=optimizer.linear_schedule(0.05, 2, 10),
                              clip_norm=clip)
    jp = jax.tree.map(jnp.asarray, params)
    pp = _to_port(params)
    jmasks = jax.tree.map(jnp.asarray, masks)
    pmasks = optimizer.tree_map(
        lambda m: None if m is None else torch.from_numpy(m), masks)
    js, ps = ref.init(jp), port.init(pp)
    for i in range(3):
        grads = _random_tree(np.random.default_rng(10 + i), scale=3.0)
        jp, js = ref.update(jax.tree.map(jnp.asarray, grads), js, jp,
                            masks=jmasks)
        pp, ps = port.update(_to_port(grads), ps, pp, masks=pmasks)
        _close(pp, _np(jp))
        for name in (("mu", "nu") if kind == "adamw" else ("mom",)):
            _close(getattr(ps, name), _np(getattr(js, name)))
        assert int(ps.step) == int(js.step) == i + 1
    assert float(pp["a"][~torch.from_numpy(mask_a)].abs().max()) == 0.0


@pytest.mark.parametrize("fn", ["cosine_schedule", "linear_schedule"])
def test_schedules_match_reference_at_int_and_tensor_steps(fn):
    want = getattr(ref_opt, fn)(3e-4, 20, 100)
    got = getattr(optimizer, fn)(3e-4, 20, 100)
    for step in (0, 1, 7, 19, 20, 21, 55, 99, 100, 150):
        w = float(want(jnp.asarray(step)))
        np.testing.assert_allclose(float(got(step)), w, **OPT_TOL)
        np.testing.assert_allclose(
            float(got(torch.tensor(step, dtype=torch.int32))), w, **OPT_TOL)


def test_global_norm_and_clip_match_reference():
    tree = _random_tree(np.random.default_rng(3), scale=50.0)
    np.testing.assert_allclose(
        float(optimizer.global_norm(_to_port(tree))),
        float(ref_opt.global_norm(jax.tree.map(jnp.asarray, tree))),
        **OPT_TOL)
    # lr 0: only the clipped moments move
    ref, port = ref_opt.AdamW(lr=0.0), optimizer.AdamW(lr=0.0)
    zeros = jax.tree.map(np.zeros_like, tree)
    _, js = ref.update(jax.tree.map(jnp.asarray, tree),
                       ref.init(jax.tree.map(jnp.asarray, zeros)),
                       jax.tree.map(jnp.asarray, zeros))
    _, ps = port.update(_to_port(tree), port.init(_to_port(zeros)),
                        _to_port(zeros))
    _close(ps.mu, _np(js.mu))
    assert float(optimizer.global_norm(ps.mu)) < 0.11   # (1 - b1) * 1.0


# ---------------------------------------------------------------------------
# one f32 train step of every family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    rcfg, jparams, batch, loss, parts, jgrads, jnew = _ref_step(arch)
    cfg = _port_cfg(arch)
    params = _bridge(jparams)
    pbatch = train_loop.batch_to(batch, "cpu")
    got_loss, got_parts, grads = train_loop.value_and_grad(params, pbatch,
                                                           cfg)
    np.testing.assert_allclose(float(got_loss), loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got_parts["ce"]), parts["ce"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got_parts["aux"]), parts["aux"],
                               rtol=LOSS_RTOL, atol=1e-7)
    assert (parts["aux"] > 0) == bool(cfg.n_routed_experts)
    want_grads = _bridge(jgrads)
    tols = _assert_grads(cfg, grads, want_grads)
    opt = _port_opt()
    state = train_loop.TrainState(params, opt.init(params),
                                  torch.zeros((), dtype=torch.int32))
    new, metrics = train_loop.make_train_step(cfg, opt)(state, pbatch)
    assert int(new.step) == 1 and int(new.opt_state.step) == 1
    np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(
        float(metrics["grad_norm"]),
        float(ref_opt.global_norm(jax.tree.map(jnp.asarray, jgrads))),
        rtol=1e-4)
    _assert_params(new.params, _bridge(jnew), want_grads, tols)


@pytest.mark.parametrize("arch", ("tinyllama_1_1b", "qwen2_moe_a2_7b"))
def test_donated_step_equals_the_step(arch):
    """``donate=True`` (AdamW in place, with the launcher's masks) gives
    the step's params, moments and metrics bit for bit, over two steps."""
    _, jparams, batch, *_ = _ref_step(arch)
    cfg = _port_cfg(arch)
    pbatch = train_loop.batch_to(batch, "cpu")
    runs = []
    for donate in (False, True):
        params = _bridge(jparams)
        masks = train_launch.reference_masks(params, cfg, 0.8)
        params = optimizer.apply_masks(params, masks)
        opt = _port_opt()
        state = train_loop.TrainState(params, opt.init(params),
                                      torch.zeros((), dtype=torch.int32))
        step = train_loop.make_train_step(cfg, opt, masks=masks,
                                          donate=donate)
        for _ in range(2):
            state, metrics = step(state, pbatch)
        runs.append((state, metrics))
    (a, ma), (b, mb) = runs
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for (path, x), (_, y) in zip(ft.flatten_with_paths(a),
                                 ft.flatten_with_paths(b)):
        assert torch.equal(x, y), path


def test_microbatches_average_like_one_batch():
    """Two microbatches against one, SGD-M (linear in the gradient, as the
    reference's own test uses), f32."""
    _, jparams, batch, *_ = _ref_step("tinyllama_1_1b")
    cfg = _port_cfg("tinyllama_1_1b")
    opt = optimizer.SGDM(lr=1e-2, clip_norm=None)
    params = _bridge(jparams)
    state = train_loop.TrainState(params, opt.init(params),
                                  torch.zeros((), dtype=torch.int32))
    pbatch = train_loop.batch_to(batch, "cpu")
    one, m1 = train_loop.make_train_step(cfg, opt)(state, pbatch)
    two, m2 = train_loop.make_train_step(cfg, opt, microbatches=2)(state,
                                                                   pbatch)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m2["ce"]), float(m1["ce"]), rtol=1e-5)
    _close(two.params, one.params, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="microbatches"):
        train_loop.make_train_step(cfg, opt, microbatches=3)(state, pbatch)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "qwen2_moe_a2_7b"])
def test_remat_gives_the_gradients_of_no_remat(arch, remat):
    _, jparams, batch, *_ = _ref_step(arch)
    params = _bridge(jparams)
    pbatch = train_loop.batch_to(batch, "cpu")
    base = train_loop.value_and_grad(params, pbatch, _port_cfg(arch))
    got = train_loop.value_and_grad(params, pbatch,
                                    _port_cfg(arch, remat=remat))
    assert float(got[0]) == float(base[0])
    assert float(got[1]["aux"]) == float(base[1]["aux"])
    for (path, a), (_, b) in zip(ft.flatten_with_paths(got[2]),
                                 ft.flatten_with_paths(base[2])):
        assert torch.equal(a, b), path


def test_dots_policy_saves_only_unbatched_matmuls():
    ops = torch.ops.aten
    policy = transformer._dots_policy
    save = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    assert policy(None, ops.mm.default) == save
    assert policy(None, ops.addmm.default) == save
    assert policy(None, ops.bmm.default) != save
    assert policy(None, ops.mul.Tensor) != save


# ---------------------------------------------------------------------------
# masks by the reference launcher's rule
# ---------------------------------------------------------------------------

def _ref_launcher_masks(jparams, sparsity):
    """``repro.launch.train``'s rule, verbatim."""
    from repro.core import pruning as ref_pruning
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (ref_pruning.unstructured_mask(jnp.abs(x), sparsity)
                      if x.ndim == 3 and "'w'" in jax.tree_util.keystr(p)
                      else None), jparams)


@pytest.mark.parametrize("arch,masked", [("tinyllama_1_1b", True),
                                         ("recurrentgemma_9b", False)])
def test_masks_are_the_reference_launchers_bit_for_bit(arch, masked):
    rcfg = ref_configs.smoke(arch)
    jparams = ref_tf.init_model(jax.random.PRNGKey(1), rcfg)
    want = _ref_launcher_masks(jparams, 0.8)
    cfg = configs.smoke(arch)
    params = _bridge(jax.tree.map(np.asarray, jparams))
    got = train_launch.reference_masks(params, cfg, 0.8)
    want_leaves = {}          # the stacked [L, ...] masks split per layer
    for kp, m in jax.tree_util.tree_flatten_with_path(want)[0]:
        key = jax.tree_util.keystr(kp)
        rest = key[len("['layers']"):]
        for i in range(m.shape[0]):
            want_leaves[f"['layers'][{i}]{rest}"] = torch.from_numpy(
                np.asarray(m[i]))
    got_leaves = dict(ft.flatten_with_paths(got))
    assert set(got_leaves) == set(want_leaves)
    assert bool(got_leaves) == masked
    for path, m in got_leaves.items():
        assert m.dtype == torch.bool and torch.equal(m, want_leaves[path]), \
            path
    if masked:        # one threshold over the whole [L, out, in] stack
        counts = train_launch.mask_counts(got)
        wq = [n for p, n in counts.items() if p.endswith("['wq']['w']")]
        size = params["layers"][0]["attn"]["wq"]["w"].numel()
        assert sum(wq) == round(len(wq) * size * 0.2)


def test_masked_positions_stay_zero_over_three_steps():
    cfg = dataclasses.replace(configs.smoke("tinyllama_1_1b"),
                              dtype="float32")
    opt = _port_opt()
    state = train_loop.init_train_state(cfg, opt, seed=0, device="cpu")
    masks = train_launch.reference_masks(state.params, cfg, 0.8)
    state = train_loop.TrainState(optimizer.apply_masks(state.params, masks),
                                  state.opt_state, state.step)
    step = train_loop.make_train_step(cfg, opt, masks=masks)
    stream = data.SyntheticLM(cfg.vocab, SEQ, BATCH, seed=0)
    for _ in range(3):
        state, _ = step(state, train_loop.batch_to(stream.next_batch(),
                                                   "cpu"))
    params = dict(ft.flatten_with_paths(state.params))
    masked = ft.flatten_with_paths(masks)
    assert len(masked) == 2 * 7
    for path, m in masked:
        assert float(params[path][~m].abs().max()) == 0.0, path
        assert float(params[path][m].abs().min()) > 0.0, path


def test_unstructured_mask_is_unchanged_per_matrix():
    """``reference_masks`` concatenates a stack; ``unstructured_mask``
    itself keeps thresholding each matrix of a stack."""
    w = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    m = pruning.unstructured_mask(w, 0.5)
    assert m.sum(dim=(1, 2)).tolist() == [6, 6]


# ---------------------------------------------------------------------------
# launch/train.py
# ---------------------------------------------------------------------------

def test_cli_trains_and_logs(capsys):
    out = train_launch.main(["--arch", "tinyllama_1_1b", "--smoke",
                             "--steps", "4", "--batch", "2", "--seq", "16",
                             "--log-every", "2", "--sparsity", "0.8"],
                            device="cpu")
    text = capsys.readouterr().out
    assert "step     2 loss" in text and "tok/s" in text and "done" in text
    assert out["steps"] == 4 and [r["step"] for r in out["log"]] == [2, 4]
    assert all(np.isfinite(r["loss"]) for r in out["log"])
    assert int(out["state"].step) == 4


def test_cli_layers_trains_the_first_layers_at_full_width():
    # --layers N: the arch's first N layers at its widths, drawn from
    # the seed as the full-depth model is (its embedding the same).
    argv = ["--arch", "tinyllama_1_1b", "--smoke", "--steps", "1",
            "--batch", "2", "--seq", "16", "--sparsity", "0.8"]
    cut = train_launch.setup(train_launch.parse_args(argv + ["--layers",
                                                             "1"]), "cpu")
    whole = train_launch.setup(train_launch.parse_args(argv), "cpu")
    assert cut["cfg"] == dataclasses.replace(whole["cfg"], n_layers=1)
    assert len(cut["state"].params["layers"]) == 1
    for (pa, ta), (pb, tb) in zip(
            ft.flatten_with_paths(cut["state"].params["embed"]),
            ft.flatten_with_paths(whole["state"].params["embed"])):
        assert pa == pb and torch.equal(ta, tb), pa
    out = train_launch.main(argv + ["--layers", "1", "--log-every", "1"],
                            device="cpu")
    assert out["steps"] == 1 and np.isfinite(out["log"][-1]["loss"])
    with pytest.raises(SystemExit):
        train_launch.parse_args(argv + ["--layers", "0"])


def test_cli_refuses_mesh_and_needs_a_card_by_default(monkeypatch):
    # --mesh is ported (tests/test_torch_sharding.py drives it); a mesh
    # that is not DxM is still refused, and no run starts without a card.
    with pytest.raises(SystemExit):
        train_launch.main(["--arch", "tinyllama_1_1b", "--smoke", "--mesh",
                           "2by1"], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--mesh", "2x2"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_launch.main(["--arch", "tinyllama_1_1b", "--smoke",
                               "--steps", "1"] + extra)


def test_cli_mesh_message_names_the_queue_item():
    # The SSM trains under a mesh (ROADMAP.md queue 1 item 14, which
    # this test's refusal named before): one step of smoke mamba2 on
    # 1x2, d_inner over the two model ranks, against the same step on
    # one process.
    argv = ["--arch", "mamba2_130m", "--smoke", "--steps", "1", "--batch",
            "2", "--seq", "17", "--sparsity", "0.8", "--log-every", "1"]
    out = train_launch.main(argv + ["--mesh", "1x2"], device="cpu")
    assert out["steps"] == 1 and [r["step"] for r in out["log"]] == [1]
    one = train_launch.main(argv, device="cpu")
    # bf16 compute (the smoke config's dtype): within the reference's own
    # sharded-step tolerance (tests/test_torch_sharding.py's CLI test)
    for a, b in zip(out["log"], one["log"]):
        assert np.isfinite(a["loss"])
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=5e-3)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                   rtol=5e-3)
