"""The sequence-sharded K/V cache and FSDP execution of the port on host
meshes, against the reference's unsharded functions, on the CPU.

Four gloo ranks (``launch.mesh.run_world``, ``device="cpu"``):

* Serving on 2x2 and 1x4, widened smoke OPT (MHA, grouped ``wqkv``),
  tinyllama (GQA) and qwen2 (12 query heads over 3 KV heads: the heads
  split neither two nor four ways, so every rank computes every head),
  f32 and bf16, dense and at sparsity 0.8. The cache of 16 positions is
  laid out by ``cache_shardings``: the sequence over ``model`` (blocks
  of 8 and 4), the batch of 4 over ``data``. A 9-token prompt crosses a
  block boundary; a 3-token one leaves the last block(s) empty through
  every step. Prefill and first decode-step logits against the
  reference's unsharded ``engine.prefill``/``serve_step`` within the
  slice tests' tolerances (f32 1e-3, bf16 3e-2), greedy streams equal
  up to the first near-tie, every rank's the same. The ranks' K/V blocks
  put together are the reference's cache within the bf16 tolerance; a
  row whose K or V differs from the reference's at all is held at the
  bf16 tolerance: f32 sums taken in another order (the ranks' partial
  softmaxes, the row-parallel partial products) can round a bf16 K/V
  store apart by one ulp, which moves the logits past 1e-3, the rule of
  ``tests/test_torch_moe.py``.
* ``seq_shard`` at batch 1 on 2x2: the sequence over ``data``, the KV
  heads over ``model``; qwen2's 3 KV heads fall back to the head dim
  over ``model`` (each rank's partial q.k summed in f32 before the
  softmax, its share of ``p @ V`` gathered before ``wo``).
* FSDP (ZeRO-3) on 2x2 and 4x1: one f32 step at 0.8 masks against the
  reference's jitted unsharded step: loss and grad norm within
  ``LOSS_RTOL``, params within 5e-3, masked weights at zero; the 2x2
  checkpoint restores bit for bit on one process and on 1x4 without
  FSDP.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worlds as worlds
from repro import configs as ref_configs
from repro.core import pruning as ref_pruning
from repro.models import transformer as ref_tf
from repro.serving import engine as ref_engine
from repro_torch import configs
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import transformer
from test_torch_sharding import (LOSS_RTOL, PARAM_TOL, _ref_train, _scan,
                                 _template)

TOL = {"float32": 1e-3, "bfloat16": 3e-2}
MAX_LEN, MAX_NEW = 16, 5
ARCHS = ("opt_30b", "tinyllama_1_1b", "qwen2_1_5b")
CASES = ([(a, "float32", None) for a in ARCHS]
         + [(a, "bfloat16", 0.8) for a in ARCHS])
SEQ_SHARD = [(a, "float32", None) for a in ARCHS]
TRAIN_ARCHS = ("opt_30b", "tinyllama_1_1b")
# ``build_cell`` on a device inside the world: (name, kind, seq, batch)
DEVICE_CELLS = (("decode", "decode", 16, 4), ("one", "decode", 16, 1),
                ("prefill", "prefill", 16, 4), ("train", "train", 16, 4))

_PREFILL = jax.jit(ref_engine.prefill, static_argnums=(2, 3))
_STEP = jax.jit(ref_engine.serve_step, static_argnums=(4,))


def _prompts(batch):
    rng = np.random.default_rng(29)
    if batch == 1:
        return {"one": rng.integers(0, 256, (1, 9)).astype(np.int32)}
    return {"long": rng.integers(0, 256, (batch, 9)).astype(np.int32),
            "short": rng.integers(0, 256, (batch, 3)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _ref_params(arch, sparsity):
    rcfg = worlds.wide(ref_configs.smoke(arch), arch, "float32")
    jparams = ref_tf.init_model(jax.random.PRNGKey(0), rcfg)
    dense = jax.tree.map(np.asarray, jparams)
    if sparsity:
        jparams = ref_pruning.group_projections(ref_pruning.sparsify_params(
            jparams, sparsity, should_sparsify=worlds.should_sparsify))
    return dense, jparams


def _ref_kv(cache, n_layers):
    """Per-layer ``(k, v)`` f32 numpy of a reference cache (stacked or a
    list)."""
    f32 = lambda x: np.asarray(jnp.asarray(x, jnp.float32))
    if isinstance(cache, dict):
        return [(f32(cache["k"][i]), f32(cache["v"][i]))
                for i in range(n_layers)]
    return [(f32(c["k"]), f32(c["v"])) for c in cache]


@functools.lru_cache(maxsize=None)
def _ref_serve(arch, dtype, sparsity, batch, name):
    """The reference's unsharded prefill and first-step logits, its K/V
    after each, and its greedy stream at ``MAX_LEN``."""
    rcfg = worlds.wide(ref_configs.smoke(arch), arch, dtype)
    _, jparams = _ref_params(arch, sparsity)
    prompt = _prompts(batch)[name]
    S = prompt.shape[1]
    last, cache = _PREFILL(jparams, jnp.asarray(prompt), rcfg, MAX_LEN)
    kv_pre = _ref_kv(cache, rcfg.n_layers)
    f32 = lambda x: np.asarray(jnp.asarray(x, jnp.float32))
    first, step, toks, kv_step = f32(last), None, [prompt], None
    tok = np.asarray(jnp.argmax(last, -1))[:, None]
    for i in range(MAX_NEW):
        toks.append(tok)
        if i == MAX_NEW - 1:
            break
        last, cache = _STEP(jparams, cache, jnp.asarray(tok),
                            jnp.array(S + i, jnp.int32), rcfg)
        if step is None:
            step, kv_step = f32(last), _ref_kv(cache, rcfg.n_layers)
        tok = np.asarray(jnp.argmax(last, -1))[:, None]
    return dict(first=first, step=step, tokens=np.concatenate(toks, axis=1),
                kv_pre=kv_pre, kv_step=kv_step)


def _flip_rows(results, key, which, ref_kv, upto):
    """The ranks' K/V blocks put together, over positions [0, upto):
    within the bf16 tolerance of the reference's cache; True for each row
    where some layer's K or V differs from it at all (a bf16 rounding
    flip, or what one flip upstream moved)."""
    flips = None
    for layer, (rk, rv) in enumerate(ref_kv):
        for j, want in enumerate((rk, rv)):
            got = np.full_like(want, np.nan)
            for r in results:
                blk = r["serve"][key][which]
                part = blk["kv"][layer][j]
                b, s, h, d = blk["at"]
                got[b:b + part.shape[0], s:s + part.shape[1],
                    h:h + part.shape[2], d:d + part.shape[3]] = part
            got, want = got[:, :upto], want[:, :upto]
            np.testing.assert_allclose(got, want, rtol=TOL["bfloat16"],
                                       atol=TOL["bfloat16"])
            rows = (got != want).reshape(got.shape[0], -1).any(-1)
            flips = rows if flips is None else flips | rows
    return flips


def _key(arch, dtype, sparsity, seq_shard=False):
    return f"{arch}-{dtype}-{sparsity}-{'seq' if seq_shard else 'model'}"


def _serve_args(cases, batch, seq_shard):
    """``seq_serve_cases``' arguments; the first step is teacher-forced
    with the reference's first tokens (a near tie in the prefill would
    otherwise feed the two sides different tokens)."""
    first = {(_key(a, d, s, seq_shard), name):
             _ref_serve(a, d, s, batch, name)["tokens"][:, prompt.shape[1]]
             for a, d, s in cases
             for name, prompt in _prompts(batch).items()}
    return ([(_key(a, d, s, seq_shard), a, d, s, _ref_params(a, s)[0],
              seq_shard) for a, d, s in cases],
            _prompts(batch), MAX_LEN, MAX_NEW, first)


def _train_cases():
    return [(arch, *_ref_train(arch)[:2]) for arch in TRAIN_ARCHS]


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    return tmp_path_factory.mktemp("fsdp_ckpt")


@pytest.fixture(scope="module")
def world_2x2(ckpt_root):
    cases, prompts, max_len, max_new, first = _serve_args(CASES, 4, False)
    seq_cases, seq_prompts, _, _, seq_first = _serve_args(SEQ_SHARD, 1,
                                                          True)
    serve = (cases + seq_cases, {**prompts, **seq_prompts}, max_len,
             max_new, {**first, **seq_first})
    return (2, 2), mesh_mod.run_world(
        worlds.seq_world, (2, 2), device="cpu",
        args=(serve, _train_cases(), str(ckpt_root), None, DEVICE_CELLS))


@pytest.fixture(scope="module")
def world_1x4(world_2x2, ckpt_root):
    return (1, 4), mesh_mod.run_world(
        worlds.seq_world, (1, 4), device="cpu",
        args=(_serve_args(CASES, 4, False), [], None, str(ckpt_root)))


@pytest.fixture(scope="module")
def world_4x1():
    return (4, 1), mesh_mod.run_world(worlds.seq_world, (4, 1),
                                      device="cpu",
                                      args=(None, _train_cases()))


def _near_tie_step(steps, tol):
    for i, lg in enumerate(steps):
        top = np.sort(lg, axis=-1)[:, -2:]
        if np.any(top[:, 1] - top[:, 0] < tol):
            return i
    return None


def _close_rows(got, want, flips, tol):
    """Rows at ``tol``, those with a K/V rounding flip at the bf16
    tolerance."""
    np.testing.assert_allclose(got[~flips], want[~flips], rtol=tol,
                               atol=tol)
    bf16 = TOL["bfloat16"]
    np.testing.assert_allclose(got[flips], want[flips], rtol=bf16,
                               atol=bf16)


def _check_serving(results, key, ref, tol, S):
    got = [r["serve"][key] for r in results]
    for g in got:
        assert "error" not in g, g.get("error")
        np.testing.assert_array_equal(g["tokens"], got[0]["tokens"])
        np.testing.assert_array_equal(g["prefill"], got[0]["prefill"])
    want_tok = ref["tokens"]
    g = got[0]
    _close_rows(g["prefill"], ref["first"],
                _flip_rows(results, key, "kv_pre", ref["kv_pre"], S), tol)
    _close_rows(g["step"], ref["step"],
                _flip_rows(results, key, "kv_step", ref["kv_step"], S + 1),
                tol)
    tie = _near_tie_step(g["steps"], tol)
    upto = S + (MAX_NEW if tie is None else tie)
    np.testing.assert_array_equal(g["tokens"][:, :upto], want_tok[:, :upto])
    assert g["tokens"].shape == want_tok.shape
    return g


@pytest.mark.parametrize("name", ("long", "short"))
@pytest.mark.parametrize("arch,dtype,sparsity", CASES)
@pytest.mark.parametrize("world", ("world_2x2", "world_1x4"))
def test_sequence_sharded_serving_matches_reference(world, arch, dtype,
                                                    sparsity, name,
                                                    request):
    shape, results = request.getfixturevalue(world)
    key = (_key(arch, dtype, sparsity), name)
    S = _prompts(4)[name].shape[1]
    g = _check_serving(results, key,
                       _ref_serve(arch, dtype, sparsity, 4, name),
                       TOL[dtype], S)
    d, m = shape
    assert g["seq"] == "model"
    assert g["batch"] == "data"
    assert g["local"][:2] == (4 // d, MAX_LEN // m)


@pytest.mark.parametrize("arch,dtype,sparsity", SEQ_SHARD)
def test_seq_shard_at_batch_one(world_2x2, arch, dtype, sparsity):
    _, results = world_2x2
    key = (_key(arch, dtype, sparsity, True), "one")
    g = _check_serving(results, key,
                       _ref_serve(arch, dtype, sparsity, 1, "one"),
                       TOL[dtype], 9)
    assert g["seq"] == "data" and g["batch"] is None
    wcfg = worlds.wide(ref_configs.smoke(arch), arch, dtype)
    kv = wcfg.n_kv
    if arch == "qwen2_1_5b":         # 3 KV heads over model 2: the head dim
        assert g["local"] == (1, MAX_LEN // 2, kv, wcfg.head_dim // 2)
    else:
        assert g["local"][:3] == (1, MAX_LEN // 2, kv // 2)


def _assemble(results, key, specs, sizes):
    """Whole leaves from every rank's blocks of ``results[r][key]``,
    whatever axes split them."""
    out = {}
    for path, spec in specs.items():
        block = results[0][key][path]
        shape = list(block.shape)
        for dim, e in enumerate(spec):
            if e is not None:
                shape[dim] *= sizes[e]
        whole = np.zeros(shape, block.dtype)
        for r in results:
            at = tuple(slice(None) if e is None else
                       slice(r["coords"][e] * block.shape[dim],
                             (r["coords"][e] + 1) * block.shape[dim])
                       for dim, e in enumerate(spec))
            whole[at] = r[key][path]
        out[path] = whole
    return out


def _fsdp_specs(arch, shape):
    cfg = worlds.wide(configs.smoke(arch), arch, "float32")
    whole = transformer.init_model(cfg, device="cpu")
    return sharding.params_shardings(
        whole, dict(zip(("data", "model"), shape)), fsdp=True)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
@pytest.mark.parametrize("world", ("world_2x2", "world_4x1"))
def test_fsdp_step_matches_reference(world, arch, request):
    shape, results = request.getfixturevalue(world)
    _, _, loss, gnorm, want, _ = _ref_train(arch)
    per_rank = [{**r[arch], "coords": r["coords"]} for r in results]
    for r in per_rank:
        assert r["loss"] == per_rank[0]["loss"]
        assert r["grad_norm"] == per_rank[0]["grad_norm"]
    got = per_rank[0]
    assert abs(got["loss"] - loss) <= LOSS_RTOL * abs(loss)
    assert abs(got["grad_norm"] - gnorm) <= LOSS_RTOL * abs(gnorm)
    specs = _fsdp_specs(arch, shape)
    assert any("data" in sharding.split_axes(s) for s in specs.values())
    sizes = dict(zip(("data", "model"), shape))
    params = _assemble(per_rank, "params", specs, sizes)
    masks = _assemble(per_rank, "masks",
                      {p: s for p, s in specs.items()
                       if p in per_rank[0]["masks"]}, sizes)
    scan = _scan(arch)
    for path, value in params.items():
        ref_path = sharding.reference_path(path, scan=scan)
        w = want[ref_path]
        if scan and ref_path.startswith("['layers']"):
            w = w[int(path.split("[")[2].rstrip("]"))]
        assert value.shape == w.shape, path
        assert float(np.abs(value - w).max()) <= PARAM_TOL, path
    assert masks
    for path, m in masks.items():
        assert np.all(params[path][~m.astype(bool)] == 0.0), path


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_fsdp_checkpoint_restores_on_one_process_and_1x4(
        world_2x2, world_1x4, ckpt_root, arch):
    shape, results = world_2x2
    (state, _), meta = ft.CheckpointManager(
        str(ckpt_root / arch)).restore(_template(arch))
    assert meta["step"] == 1
    whole = {p: v.detach().numpy() for p, v in ft.flatten_with_paths(state)
             if isinstance(v, torch.Tensor)}
    sizes = dict(zip(("data", "model"), shape))
    specs = {p: ft.leaf_spec(p, v.shape, sizes, fsdp=True)
             for p, v in whole.items()}
    per_rank = [{**r[arch], "coords": r["coords"]} for r in results]
    saved = _assemble(per_rank, "state", specs, sizes)
    for path, v in whole.items():
        np.testing.assert_array_equal(saved[path], v, err_msg=path)
    shape4, results4 = world_1x4
    mesh4 = dict(zip(("data", "model"), shape4))
    for res in results4:
        got = res["restored"][arch]
        assert got["step"] == 1
        for path, v in whole.items():
            spec = ft.leaf_spec(path, v.shape, mesh4)
            want = sharding.shard_leaf(torch.from_numpy(v), spec, mesh4,
                                       coords=got["coords"]).numpy()
            np.testing.assert_array_equal(got["state"][path], want,
                                          err_msg=path)


def test_fsdp_step_is_a_zero3_step(world_2x2):
    """The FSDP params are split over ``data`` too: a rank holds a
    quarter of each matrix on 2x2."""
    _, results = world_2x2
    specs = _fsdp_specs("tinyllama_1_1b", (2, 2))
    path = "['layers'][0]['mlp']['gate']['w']"
    assert specs[path] == ("model", "data")
    assert results[0]["tinyllama_1_1b"]["params"][path].shape == (512, 256)


@pytest.mark.parametrize("name", [c[0] for c in DEVICE_CELLS])
def test_build_cell_runs_on_a_device_in_a_world(world_2x2, name):
    """The dry run's ``build_cell`` on the CPU inside the 2x2 world (the
    card's phase builds and runs its cells the same way): it runs, and
    each rank's argument bytes are those its meta cell predicts."""
    _, results = world_2x2
    for r in results:
        cell = r["cells"][name]
        assert cell["finite"], name
        assert cell["bytes"] == cell["dry"], (name, r["coords"])
