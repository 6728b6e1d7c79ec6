"""Sharding rules, Tiled-CSL shards, sharded training, compression and
the elastic restore of the port, against the reference.

* Rules: ``sharding.spec_for`` / ``params_shardings`` of the port give
  the reference's ``params_shardings(...).spec`` for every leaf of every
  config (smoke and full, dense and Tiled-CSL structs through
  ``jax.eval_shape``, and the port's own converted smoke params) on
  ``AbstractMesh`` (2, 2), (1, 4), (4, 2) and (2, 16, 16) with ``pod``,
  ``fsdp`` off and on, a scan config's ``[L]`` entry dropped; and the
  reference's own ``rule_for`` / ``fit_spec`` / ``batch_sharding`` cases.
* Tiled-CSL shards: the ``mt`` and ``kt`` shards of an encoding at 2 and
  4 ways equal, after ``pad_max_nnz`` to one width, the port's and the
  reference's encodings of the sliced matrix, byte for byte, and no
  padding word lies in a shard's live range.
* Training (four gloo ranks on the CPU, ``launch.mesh.run_world``): one
  f32 step of widened smoke configs at 0.8 masks on meshes 2x2, 4x1 and
  1x4 against the reference's unsharded jitted step: loss and grad norm
  within ``LOSS_RTOL``, every param within 5e-3 (the reference's own
  sharded-step tolerance, ``tests/test_distributed.py``), the update
  itself within ``UPDATE_MISS_TOL`` (below), masked weights at zero.
* Compression: ``compressed_all_reduce`` over four data ranks against
  the reference's ``compressed_psum`` under ``jax.vmap`` (within one f32
  ulp), the grad all-reduce's leaf rule and ``ErrorFeedback``'s residual.
* Elastic restore: the 2x2 step's checkpoint restores bit for bit on one
  process and, in a 1x4 world, on every rank; the single-process
  ``--resume`` reads the checkpoint that ``--mesh 2x2`` wrote.

Widened smoke configs (``torch_mesh_worlds.wide``): the smoke widths
(d_model 128) shard almost nothing.
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
from repro.core import tiled_csl as ref_csl
from repro.distributed import compression as ref_compression
from repro.distributed import sharding as ref_sharding
from repro.launch import specs as ref_specs
from repro.models import transformer as ref_tf
from repro.training import data as ref_data
from repro.training import optimizer as ref_opt
from repro.training import train_loop as ref_tl
from repro_torch import configs, convert
from repro_torch.core import tiled_csl
from repro_torch.distributed import compression, sharding
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train as train_launch
from repro_torch.models import transformer
from repro_torch.training import train_loop

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
LOSS_RTOL = 1e-5
PARAM_TOL = 5e-3
# Adam's first step moves every element by about lr (1.5e-5 here), so
# PARAM_TOL passes a skipped or sign-wrong update too. Per leaf, the
# elements off the reference's by more than lr / 2, over those the
# reference moved by more than lr / 2: 1.0 for a skipped update (checked
# on a copy whose AdamW left params as they were), near 1 for a
# sign-wrong or mis-scaled one. A sound step misses only where a gradient
# rounds across zero: at most 0.045, on OPT's K bias, whose gradient is
# zero but for rounding (softmax ignores a shift shared by every key).
UPDATE_MISS_TOL = 0.25
SCHEDULE = (3e-4, 20, 100)          # torch_mesh_worlds._opt's
SPARSITY = 0.8
BATCH, SEQ = 4, 17


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

def _abstract(name):
    return jax.sharding.AbstractMesh(*MESHES[name])


def _sparse_struct(dense):
    """``specs.sparse_params_struct`` of a dense struct already made (it
    would trace the model again): Tiled-CSL structs where its rule
    sparsifies."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(dense)
    leaves = []
    for path, leaf in flat:
        if leaf.ndim in (2, 3) and ref_specs.default_should_sparsify(
                jax.tree_util.keystr(path)):
            leaf = ref_specs._csl_struct(leaf.shape[-2], leaf.shape[-1],
                                         SPARSITY, tuple(leaf.shape[:-2]))
        leaves.append(leaf)
    return jax.tree_util.tree_unflatten(treedef, leaves)


@functools.lru_cache(maxsize=None)
def _structs(arch):
    """The reference's param structs of ``arch``: smoke and full, dense
    and at 0.8 (Tiled-CSL leaves), through ``jax.eval_shape``."""
    out = {}
    for size, cfg in (("smoke", ref_configs.smoke(arch)),
                      ("full", ref_configs.get(arch))):
        out[size, "dense"] = ref_specs.params_struct(cfg)
        out[size, "sparse"] = _sparse_struct(out[size, "dense"])
    return out


def test_sparse_struct_is_the_references():
    cfg = ref_configs.smoke("tinyllama_1_1b")
    want = ref_specs.sparse_params_struct(cfg, SPARSITY, dtype=jnp.float32)
    got = _sparse_struct(ref_specs.params_struct(cfg))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    assert [x.shape for x in jax.tree.leaves(got)] == \
        [x.shape for x in jax.tree.leaves(want)]


def _ref_specs(tree, mesh, fsdp):
    """{reference keystr path: (spec tuple, leaf shape)}."""
    sh = ref_sharding.params_shardings(tree, mesh, fsdp=fsdp)
    flat_s = jax.tree_util.tree_flatten_with_path(
        sh, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    flat_t = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): (tuple(s.spec), tuple(t.shape))
            for (p, s), (_, t) in zip(flat_s, flat_t)}


def _scan(arch) -> bool:
    return transformer.uses_scan(configs.smoke(arch))


def _want(ref_spec, ndim, stacked):
    """The reference's spec padded to its leaf's rank, ``[L]`` dropped."""
    spec = tuple(ref_spec) + (None,) * (ndim - len(ref_spec))
    return spec[1:] if stacked else spec


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_rules_match_reference_on_every_struct(arch, mesh_name):
    mesh = _abstract(mesh_name)
    scan = _scan(arch)
    n = 0
    for (size, kind), tree in _structs(arch).items():
        for fsdp in (False, True):
            for ref_path, (spec, shape) in _ref_specs(tree, mesh,
                                                      fsdp).items():
                stacked = scan and ref_path.startswith("['layers']")
                for layer in ((0, shape[0] - 1) if stacked else (None,)):
                    port_path = (ref_path.replace("['layers']",
                                                  f"['layers'][{layer}]", 1)
                                 if stacked else ref_path)
                    port_shape = shape[1:] if stacked else shape
                    assert sharding.reference_path(port_path,
                                                   scan=scan) == ref_path
                    got = sharding.spec_for(port_path, port_shape, mesh,
                                            fsdp=fsdp)
                    want = _want(spec, len(shape), stacked)
                    assert got == want, (size, kind, fsdp, port_path)
                    n += 1
    assert n > 0


@functools.lru_cache(maxsize=None)
def _smoke_params(arch):
    """The reference's smoke param tree at 0.8 (its Tiled-CSL layout,
    zero-filled: the rules read shapes only), grouped by its
    ``group_projections``, and the same through ``convert``."""
    struct = _structs(arch)["smoke", "sparse"]
    zeros = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), struct)
    np_params = jax.tree.map(np.asarray,
                             ref_pruning.group_projections(zeros))
    return np_params, convert.params_from_numpy(np_params, device="cpu")


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_port_params_shardings_match_reference(arch):
    np_params, port = _smoke_params(arch)
    scan = _scan(arch)
    for mesh_name in ("2x2", "1x4"):
        mesh = _abstract(mesh_name)
        for fsdp in (False, True):
            want = _ref_specs(np_params, mesh, fsdp)
            got = sharding.params_shardings(port, mesh, fsdp=fsdp)
            seen = set()
            for path, spec in got.items():
                ref_path = sharding.reference_path(path, scan=scan)
                stacked = scan and ref_path.startswith("['layers']")
                rspec, rshape = want[ref_path]
                assert spec == _want(rspec, len(rshape), stacked), path
                seen.add(ref_path)
            assert seen == set(want)


def test_rule_for_and_fit_spec_reference_cases():
    cases = [("['layers']['attn']['wq']['w']", 3, {}),
             ("['layers']['attn']['wo']['w']", 3, {}),
             ("['layers']['moe']['gate']", 4, {}),
             ("['layers']['moe']['router']['w']", 3, {}),
             ("['embed']['table']", 2, {}),
             ("['final_norm']['scale']", 1, {}),
             ("['layers']['mlp']['up']['w'].words", 4, {}),
             ("['layers']['mlp']['down']['w'].nnz", 3, {}),
             ("['layers']['attn']['wq']['w']", 3, dict(fsdp=True)),
             ("['layers']['moe']['down']", 4,
              dict(fsdp=True, shape=(2, 64, 32, 16), model_size=16)),
             ("['layers']['moe']['down']", 4,
              dict(fsdp=True, shape=(2, 60, 32, 16), model_size=16)),
             ("['layers']['attn']['wq']['b']", 2, {}),
             ("['layers']['attn']['wo']['b']", 2, {})]
    for path, ndim, kw in cases:
        want = tuple(ref_sharding.rule_for(path, ndim, **kw))
        assert sharding.rule_for(path, ndim, **kw) == want, path
    assert sharding.rule_for("['layers']['attn']['wq']['w']", 3) == \
        (None, "model", None)
    for name in ("2x2", "4x2", "pod2x16x16"):
        mesh = _abstract(name)
        P = jax.sharding.PartitionSpec
        batch = sharding.batch_axes(mesh)
        for spec, shape in ((("model", None), (7, 3)),
                            (("model", "data"), (8, 8)),
                            ((batch, None), (4, 2)),
                            ((batch, None), (32, 2)),
                            ((batch, None), (6, 2)),
                            ((("data", "model"), None), (6, 2))):
            want = tuple(ref_sharding.fit_spec(P(*spec), shape, mesh))
            assert sharding.fit_spec(spec, shape, mesh) == want
        for ndim, shape in ((2, (8, 16)), (3, (6, 4, 2)), (2, None)):
            want = tuple(ref_sharding.batch_sharding(
                mesh, ndim, shape=shape).spec)
            assert sharding.batch_sharding(mesh, ndim, shape=shape) == want
        assert sharding.batch_axes(mesh) == ref_sharding.batch_axes(mesh)


# ---------------------------------------------------------------------------
# Tiled-CSL shards
# ---------------------------------------------------------------------------

def _pruned(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32)
    return np.where(rng.random(shape) < SPARSITY, 0.0, a).astype(np.float32)


@pytest.mark.parametrize("ways", (2, 4))
@pytest.mark.parametrize("axis", ("mt", "kt"))
def test_tiled_csl_shards_equal_encoded_slices(axis, ways):
    a = _pruned((512, 512), ways * 7 + (axis == "kt"))
    whole = tiled_csl.encode(torch.from_numpy(a))
    spec = ("model", None, None) if axis == "mt" else (None, "model", None)
    nnz_spec = spec[:2]
    mesh = {"model": ways}
    rows = a.shape[0 if axis == "mt" else 1] // ways
    for r in range(ways):
        shard = sharding.shard_tiled_csl(whole, spec, mesh,
                                         coords={"model": r},
                                         nnz_spec=nnz_spec)
        sl = a[r * rows:(r + 1) * rows] if axis == "mt" \
            else a[:, r * rows:(r + 1) * rows]
        port = tiled_csl.encode(torch.from_numpy(np.ascontiguousarray(sl)))
        ref = ref_csl.encode(sl)
        assert shard.shape == sl.shape == port.shape
        assert shard.max_nnz == whole.max_nnz
        width = max(shard.max_nnz, port.max_nnz, ref.max_nnz)
        got = tiled_csl.pad_max_nnz(shard, width)
        np.testing.assert_array_equal(
            got.words.numpy(),
            tiled_csl.pad_max_nnz(port, width).words.numpy())
        ref_words = np.asarray(ref.words).view(np.int32)
        ref_words = np.pad(ref_words, ((0, 0), (0, 0),
                                       (0, width - ref_words.shape[-1])))
        np.testing.assert_array_equal(got.words.numpy(), ref_words)
        np.testing.assert_array_equal(shard.nnz.numpy(), np.asarray(ref.nnz))
        # live words hold a value, padding words are zero
        live = np.arange(width)[None, None] < shard.nnz.numpy()[..., None]
        assert np.all(got.words.numpy()[live] != 0)
        assert np.all(got.words.numpy()[~live] == 0)
        np.testing.assert_array_equal(
            tiled_csl.decode(shard).numpy(),
            torch.from_numpy(sl).to(torch.bfloat16).float().numpy())


def test_shard_params_of_a_grouped_encoding():
    _, port = _smoke_params("opt_30b")
    mesh, layer = {"data": 1, "model": 2}, port["layers"][0]
    wqkv = layer["attn"]["wqkv"]["w"]
    assert wqkv.group == 3
    for r in range(2):
        got = sharding.shard_params(layer, mesh, coords={"data": 0,
                                                         "model": r},
                                    prefix="['layers'][0]")
        # d_model 128 is one tile: the rule leaves the words whole ...
        assert torch.equal(got["attn"]["wqkv"]["w"].words, wqkv.words)
        # ... and splits the biases, whose 128 rows divide.
        np.testing.assert_array_equal(
            got["attn"]["wq"]["b"].numpy(),
            layer["attn"]["wq"]["b"][r * 64:(r + 1) * 64].numpy())


# ---------------------------------------------------------------------------
# training, compression, elastic restore: one world a mesh shape
# ---------------------------------------------------------------------------

def _ref_masks(params, sparsity):
    """The reference launcher's rule (``repro/launch/train.py``)."""
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (ref_pruning.unstructured_mask(jnp.abs(x), sparsity)
                      if x.ndim == 3 and "'w'" in jax.tree_util.keystr(p)
                      else None), params)


@functools.lru_cache(maxsize=None)
def _ref_train(arch):
    """The reference's widened f32 params (numpy), one global batch, and
    its unsharded jitted masked step: (loss, grad norm, new params, the
    params it stepped from), the last two flat by path."""
    rcfg = worlds.wide(ref_configs.smoke(arch), arch, "float32")
    jparams = ref_tf.init_model(jax.random.PRNGKey(0), rcfg)
    masks = _ref_masks(jparams, SPARSITY)
    jparams = ref_opt.apply_masks(jparams, masks)     # as its launcher does
    opt = ref_opt.AdamW(lr=ref_opt.cosine_schedule(*SCHEDULE))
    state = ref_tl.TrainState(jparams, opt.init(jparams),
                              jnp.zeros((), jnp.int32))
    batch = ref_data.SyntheticLM(rcfg.vocab, SEQ, BATCH, seed=0).next_batch()
    step = jax.jit(ref_tl.make_train_step(rcfg, opt, masks=masks))
    new, metrics = step(state, jax.tree.map(jnp.asarray, batch))
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v, np.float32)
                      for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    return (jax.tree.map(np.asarray, jparams), batch,
            float(metrics["loss"]), float(metrics["grad_norm"]),
            flat(new.params), flat(jparams))


def _unshard(results, key, specs):
    """Whole leaves from every rank's shards of ``results[r][key]``."""
    out = {}
    for path, spec in specs.items():
        dims = [i for i, e in enumerate(spec) if e is not None]
        blocks = {}
        for res in results:
            index = tuple(res["coords"][e] if isinstance(e, str) else 0
                          for e in spec)
            blocks.setdefault(index, res[key][path])
        if not dims:
            out[path] = blocks[(0,) * len(spec)]
            continue
        assert len(dims) == 1
        d = dims[0]
        out[path] = np.concatenate(
            [blocks[k] for k in sorted(blocks, key=lambda k: k[d])], axis=d)
    return out


def _whole_specs(arch, mesh_shape):
    cfg = worlds.wide(configs.smoke(arch), arch, "float32")
    whole = transformer.init_model(cfg, device="cpu")
    return sharding.params_shardings(
        whole, dict(zip(("data", "model"), mesh_shape)))


ARCHS = ("opt_30b", "tinyllama_1_1b")


def _cases():
    return [(arch, *_ref_train(arch)[:2]) for arch in ARCHS]


def _compress_inputs():
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((4, 64)).astype(np.float32),
          (rng.standard_normal((4, 3, 5)) * 1e-3).astype(np.float32)]
    tree = {"a": rng.standard_normal((4, 8, 6)).astype(np.float32),
            "b": rng.standard_normal((4, 3)).astype(np.float32)}
    return xs, tree


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh_ckpt")


@pytest.fixture(scope="module")
def world_2x2(ckpt_root):
    return (2, 2), mesh_mod.run_world(worlds.train_world, (2, 2),
                                      device="cpu",
                                      args=(_cases(), str(ckpt_root)))


@pytest.fixture(scope="module")
def world_4x1():
    return (4, 1), mesh_mod.run_world(
        worlds.train_world, (4, 1), device="cpu",
        args=(_cases(), None, _compress_inputs()))


@pytest.fixture(scope="module")
def world_1x4(world_2x2, ckpt_root):
    return (1, 4), mesh_mod.run_world(
        worlds.train_world, (1, 4), device="cpu",
        args=(_cases(), None, None, str(ckpt_root)))


@pytest.mark.parametrize("arch", ("opt_30b", "tinyllama_1_1b"))
@pytest.mark.parametrize("world", ("world_2x2", "world_4x1", "world_1x4"))
def test_sharded_step_matches_reference(world, arch, request):
    shape, results = request.getfixturevalue(world)
    _, _, loss, gnorm, want, before = _ref_train(arch)
    lr = float(ref_opt.cosine_schedule(*SCHEDULE)(jnp.asarray(1)))
    per_rank = [r[arch] for r in results]
    for r in per_rank:        # every rank reports the same metrics
        assert r["loss"] == per_rank[0]["loss"]
        assert r["grad_norm"] == per_rank[0]["grad_norm"]
    got = per_rank[0]
    assert abs(got["loss"] - loss) <= LOSS_RTOL * abs(loss)
    assert abs(got["grad_norm"] - gnorm) <= LOSS_RTOL * abs(gnorm)
    specs = _whole_specs(arch, shape)
    params = _unshard(per_rank, "params", specs)
    masks = _unshard(per_rank, "masks", {p: s for p, s in specs.items()
                                         if p in per_rank[0]["masks"]})
    scan = _scan(arch)
    for path, value in params.items():
        ref_path = sharding.reference_path(path, scan=scan)
        w, b = want[ref_path], before[ref_path]
        if scan and ref_path.startswith("['layers']"):
            layer = int(path.split("[")[2].rstrip("]"))
            w, b = w[layer], b[layer]
        assert value.shape == w.shape, path
        err = float(np.abs(value - w).max())
        assert err <= PARAM_TOL, f"{path}: {err:.3e}"
        moved = int((np.abs(w - b) > lr / 2).sum())
        miss = int((np.abs(value - w) > lr / 2).sum()) / max(moved, 1)
        assert miss <= UPDATE_MISS_TOL, f"{path}: update misses {miss:.3e}"
    assert masks, "no leaf masked"
    for path, m in masks.items():
        assert np.all(params[path][~m] == 0.0), path


def test_compressed_all_reduce_matches_reference(world_4x1):
    _, results = world_4x1
    comp = [r["compression"] for r in results]
    xs, tree = _compress_inputs()
    for i, x in enumerate(xs):
        want = np.asarray(jax.vmap(
            lambda v: ref_compression.compressed_psum(v, "data"),
            axis_name="data")(jnp.asarray(x)))
        for r, c in enumerate(comp):
            np.testing.assert_array_max_ulp(c["sums"][i], want[r], maxulp=1)
        bound = 4 * float(np.abs(x).max()) / 127
        assert float(np.abs(comp[0]["sums"][i] - x.sum(0)).max()) <= bound
    for r, c in enumerate(comp):
        # "a" has a leading dim of 8 (divides 4): mean-reduced; "b" of 3
        # does not: returned as it is.
        np.testing.assert_array_equal(c["reduced"]["b"], tree["b"][r])
        np.testing.assert_allclose(c["reduced"]["a"], tree["a"].mean(0),
                                   atol=float(np.abs(tree["a"]).max()) / 127)
        np.testing.assert_array_equal(c["reduced"]["a"], comp[0]["reduced"]["a"])
        for k in ("a", "b"):
            np.testing.assert_array_equal(
                c["residual"][k], c["compensated"][k] - c["sent"][k])
    assert compression.quantization_error_bound(
        torch.from_numpy(xs[0][0])) == pytest.approx(
        ref_compression.quantization_error_bound(jnp.asarray(xs[0][0])))


def _template(arch):
    cfg = worlds.wide(configs.smoke(arch), arch, "float32")
    params = transformer.init_model(cfg, device="cpu")
    opt = worlds._opt()
    return (train_loop.TrainState(params, opt.init(params),
                                  torch.zeros((), dtype=torch.int32)),
            {"seed": 0, "step": 0})


@pytest.mark.parametrize("arch", ("opt_30b", "tinyllama_1_1b"))
def test_checkpoint_from_2x2_restores_on_one_process_and_1x4(
        world_2x2, world_1x4, ckpt_root, arch):
    shape, results = world_2x2
    (state, _), meta = ft.CheckpointManager(
        str(ckpt_root / arch)).restore(_template(arch))
    assert meta["step"] == 1
    whole = {p: v.detach().numpy() for p, v in ft.flatten_with_paths(state)
             if isinstance(v, torch.Tensor)}
    # the saved state is the 2x2 ranks' shards put together, bit for bit
    specs = {p: ft.leaf_spec(p, v.shape, dict(zip(("data", "model"), shape)))
             for p, v in whole.items()}
    saved = _unshard([r[arch] for r in results], "state", specs)
    for path, v in whole.items():
        np.testing.assert_array_equal(saved[path], v, err_msg=path)
    # each 1x4 rank restores exactly its block of it
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


def test_cli_trains_on_a_2x2_mesh_and_resumes_on_one_process(tmp_path):
    args = ["--arch", "tinyllama_1_1b", "--smoke", "--batch", "4", "--seq",
            "17", "--sparsity", "0.8", "--log-every", "1", "--ckpt-dir",
            str(tmp_path)]
    out = train_launch.main(args + ["--mesh", "2x2", "--steps", "2"],
                            device="cpu")
    assert out["steps"] == 2 and [r["step"] for r in out["log"]] == [1, 2]
    assert ft.CheckpointManager(str(tmp_path)).latest_step() == 2
    straight = train_launch.main(args[:-2] + ["--steps", "2"], device="cpu")
    # bf16 compute (the smoke config's dtype): within the reference's own
    # sharded-step tolerance on its metrics
    for a, b in zip(out["log"], straight["log"]):
        assert abs(a["loss"] - b["loss"]) <= PARAM_TOL
    resumed = train_launch.main(args + ["--steps", "3", "--resume"],
                                device="cpu")
    assert resumed["steps"] == 3
    # the resumed run's masks still hold
    for path, m in ft.flatten_with_paths(resumed["masks"]):
        w = resumed["state"].params
        for step in ft.split_path(path):
            w = w[step]
        assert torch.all(w[~m] == 0), path
