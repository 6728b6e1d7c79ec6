"""The test side of training every family under a mesh
(``tests/test_torch_mesh_train_moe.py``, ``_fam.py``): the reference's
unsharded masked f32 step of a widened smoke config, the ranks' shards
put together, and the checks that hold one world's step to it.

A case is ``(key, arch, overrides)``; its world case adds the
reference's numpy params and batch (``world_case``). One world of four
gloo ranks on the CPU runs every mesh shape of a test file in turn
(``torch_mesh_worlds.family_train_world``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_mesh_worlds as worlds
from repro import configs as ref_configs
from repro.core import pruning as ref_pruning
from repro.models import transformer as ref_tf
from repro.training import data as ref_data
from repro.training import optimizer as ref_opt
from repro.training import train_loop as ref_tl
from repro_torch import configs
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import transformer

from test_torch_mesh_moe import _RefRoutes

LOSS_RTOL = 1e-5
LEAF_TOL = 1e-5                 # of the leaf's largest absolute value
# Both packages round attention's K and V to bf16 on the train path, so
# a GQA family's gradients flip bf16 roundings against any other f32
# program, the port's own unsharded step included (1.4e-3 of the leaf's
# largest value on widened recurrentgemma): those families' leaves are
# held within one bf16 ulp of it, as tests/test_torch_training.py holds
# the unsharded step; the SSM's and MLA's round nothing.
# Their gradient norm is held within the norm of the leaves' differences
# (which bounds it) plus LOSS_RTOL. A K bias's gradient is zero but for
# those roundings (softmax ignores a shift shared by every key): it is
# held within KV_ROUND_TOL of its layer's K weight gradient.
KV_ROUND_TOL = 2.0 ** -8
PARAM_TOL = 5e-3                # tests/test_torch_sharding.py's
UPDATE_MISS_TOL = 0.25          # tests/test_torch_sharding.py's
SCHEDULE = (3e-4, 20, 100)      # torch_mesh_worlds._opt's
SPARSITY = 0.8
BATCH, SEQ = 4, 17              # 16 positions a row, 64 tokens in all
NAMES = ("data", "model")


def _ref_masks(params, sparsity):
    """The reference launcher's rule (``repro/launch/train.py``)."""
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (ref_pruning.unstructured_mask(jnp.abs(x), sparsity)
                      if x.ndim == 3 and "'w'" in jax.tree_util.keystr(p)
                      else None), params)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def ref_step(arch, over=()):
    """The reference's widened f32 smoke ``arch`` (with ``over``): its
    params (numpy, masked), one global batch, ``jax.value_and_grad`` of
    its loss (loss, ce, aux, each gradient leaf flat by path), its
    unsharded jitted masked step (grad norm, the new params and those it
    stepped from, flat by path) and its MoE routing (each layer's
    experts and capacity positions, on the whole batch)."""
    rcfg = worlds.wide(ref_configs.smoke(arch), arch, "float32", over)
    # jitted: the same functions, compiled once instead of op by op
    jparams = jax.jit(lambda k: ref_tf.init_model(k, rcfg))(
        jax.random.PRNGKey(0))
    masks = jax.jit(lambda p: _ref_masks(p, SPARSITY))(jparams)
    jparams = ref_opt.apply_masks(jparams, masks)    # as its launcher does
    batch = ref_data.SyntheticLM(rcfg.vocab, SEQ, BATCH, seed=0,
                                 n_codebooks=rcfg.n_codebooks).next_batch()
    jbatch = jax.tree.map(jnp.asarray, batch)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: ref_tl.loss_fn(p, b, rcfg), has_aux=True))
    (loss, parts), grads = vg(jparams, jbatch)
    opt = ref_opt.AdamW(lr=ref_opt.cosine_schedule(*SCHEDULE))
    state = ref_tl.TrainState(jparams, opt.init(jparams),
                              jnp.zeros((), jnp.int32))
    new, metrics = jax.jit(ref_tl.make_train_step(rcfg, opt, masks=masks))(
        state, jbatch)
    routes = None
    if rcfg.n_routed_experts:
        with _RefRoutes() as tap:
            jax.jit(lambda p, b: ref_tl.loss_fn(p, b, rcfg))(jparams, jbatch)
            jax.effects_barrier()
        routes = tap.calls
    return dict(params=jax.tree.map(np.asarray, jparams), batch=batch,
                loss=float(loss), ce=float(parts["ce"]),
                aux=float(parts["aux"]), grad_norm=float(metrics["grad_norm"]),
                grads=_flat(grads), new=_flat(new.params),
                before=_flat(jparams), routes=routes,
                scan=transformer.uses_scan(worlds.wide(
                    configs.smoke(arch), arch, "float32", over)))


def world_case(key, arch, over, fsdp=False, ckpt=None):
    """The world's case of ``(key, arch, overrides)``."""
    ref = ref_step(arch, over)
    return (key, arch, over, ref["params"], ref["batch"], fsdp, ckpt)


def run(plans) -> dict:
    """One world of four gloo ranks running each ``(name, (d, m), cases,
    restore)`` plan on its own mesh over them: ``{name: [each rank's
    results]}``."""
    ranks = mesh_mod.run_world(worlds.family_train_world, (2, 2),
                               device="cpu", args=(plans,))
    return {name: [r[name] for r in ranks] for name, *_ in plans}


def whole_specs(arch, over, shape, fsdp=False):
    cfg = worlds.wide(configs.smoke(arch), arch, "float32", over)
    params = transformer.init_model(cfg, device="meta")
    return sharding.params_shardings(params, dict(zip(NAMES, shape)),
                                     fsdp=fsdp)


def unshard(results, key, specs, shape):
    """Whole leaves (numpy) from every rank's blocks of
    ``results[r][key]``, each put at its rank's place by its spec
    (``sharding.shard_leaf``), whatever axes split it."""
    sizes = dict(zip(NAMES, shape))
    out = {}
    for path, spec in specs.items():
        if path not in results[0][key]:
            continue
        part = results[0][key][path]
        whole_shape = list(part.shape)
        for d, e in enumerate(spec):
            for n in (() if e is None else e if isinstance(e, tuple)
                      else (e,)):
                whole_shape[d] *= sizes[n]
        whole = torch.full(whole_shape, float("nan"), dtype=torch.float64)
        for r in results:
            sharding.shard_leaf(whole, spec, sizes, coords=r["coords"]
                                ).copy_(torch.from_numpy(
                                    r[key][path].astype(np.float64)))
        assert not torch.isnan(whole).any(), path
        out[path] = whole.numpy()
    return out


def _ref_leaf(tree, path, scan):
    """The reference's leaf of a port path (a scan config's layer cut out
    of its stacked ``[L, ...]`` leaf)."""
    ref_path = sharding.reference_path(path, scan=scan)
    v = tree[ref_path]
    if scan and ref_path.startswith("['layers']"):
        v = v[int(path.split("[")[2].rstrip("]"))]
    return v


def rounds_kv(cfg) -> bool:
    """Does the train path round K/V to bf16 (a GQA attention layer)?"""
    return cfg.attn_kind != "mla" and any(
        cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))


def check_step(results, case, shape, fsdp=False):
    """One world's step of ``case`` against the reference's: the same
    metrics on every rank, within ``LOSS_RTOL`` of the reference's; every
    gradient leaf put together within ``LEAF_TOL`` of its largest
    absolute value (``KV_ROUND_TOL`` where K/V round); every param within
    ``PARAM_TOL``, its update's misses within ``UPDATE_MISS_TOL``; masked
    weights zero; no raw collective reached while gradients were on. Returns rank 0's
    results."""
    key, arch, over = case
    ref = ref_step(arch, over)
    got = [r[key] for r in results]
    for g in got:
        assert g["raw_under_grad"] == 0, (key, g["coords"])
        for name in ("loss", "ce", "aux", "grad_norm"):
            assert g["metrics"][name] == got[0]["metrics"][name], name
    m = got[0]["metrics"]
    cfg = worlds.wide(configs.smoke(arch), arch, "float32", over)
    kv = rounds_kv(cfg)
    specs = whole_specs(arch, over, shape, fsdp)
    grads = unshard(got, "grads", specs, shape)
    assert len(grads) == len(specs)
    rel = KV_ROUND_TOL if kv else LEAF_TOL
    diff_sq = 0.0
    for path, g in grads.items():
        w = _ref_leaf(ref["grads"], path, ref["scan"])
        assert g.shape == w.shape, path
        scale = w
        if kv and path.endswith("['wk']['b']"):
            scale = _ref_leaf(ref["grads"], path[:-len("['b']")] + "['w']",
                              ref["scan"])
        tol = rel * float(np.abs(scale).max())
        err = float(np.abs(g - w).max())
        assert err <= tol, f"{key}: grad {path}: {err:.3e} > {tol:.3e}"
        diff_sq += float(np.sum((g - w) ** 2))
    for name in ("loss", "ce", "aux", "grad_norm"):
        want = ref[name]
        tol = LOSS_RTOL * abs(want) + 1e-12
        if kv and name == "grad_norm":
            tol += diff_sq ** 0.5
        assert abs(m[name] - want) <= tol, (key, name, m[name], want)
    lr = float(ref_opt.cosine_schedule(*SCHEDULE)(jnp.asarray(1)))
    params = unshard(got, "params", specs, shape)
    for path, value in params.items():
        w = _ref_leaf(ref["new"], path, ref["scan"])
        b = _ref_leaf(ref["before"], path, ref["scan"])
        err = float(np.abs(value - w).max())
        assert err <= PARAM_TOL, f"{key}: {path}: {err:.3e}"
        moved = int((np.abs(w - b) > lr / 2).sum())
        miss = int((np.abs(value - w) > lr / 2).sum()) / max(moved, 1)
        assert miss <= UPDATE_MISS_TOL, f"{key}: {path}: misses {miss:.3e}"
    masks = unshard(got, "masks", specs, shape)
    if transformer.uses_scan(cfg):
        assert masks, f"{key}: no leaf masked"
    for path, mk in masks.items():
        assert np.all(params[path][~mk.astype(bool)] == 0.0), path
    return got[0]


def check_routes(results, case, shape):
    """Each rank's MoE routing (its rows' experts and capacity positions,
    layer by layer) equal to the reference's on the whole batch; returns
    the reference's dropped assignments."""
    key, arch, over = case
    ref = ref_step(arch, over)
    per_rank = BATCH * (SEQ - 1) // shape[0]
    dropped = 0
    cfg = worlds.wide(configs.smoke(arch), arch, "float32", over)
    for layer, (oh, pos) in enumerate(ref["routes"]):
        oh = oh.reshape(-1, oh.shape[-1])
        pos = pos.reshape(-1, pos.shape[-1])
        sg = min(cfg.moe_subgroup, oh.shape[0])
        cap = max(int(-(-sg * cfg.top_k // cfg.n_routed_experts)
                      * cfg.capacity_factor), 1)
        dropped += int(((pos >= cap) & (oh > 0)).sum())
        for r in results:
            g_oh, g_pos = r[key]["routes"][layer]
            lo = r[key]["coords"]["data"] * per_rank
            np.testing.assert_array_equal(
                g_oh.reshape(-1, oh.shape[-1]), oh[lo:lo + per_rank],
                err_msg=f"{key} layer {layer}")
            np.testing.assert_array_equal(
                g_pos.reshape(-1, pos.shape[-1]), pos[lo:lo + per_rank],
                err_msg=f"{key} layer {layer}")
    return dropped


def check_fsdp(fsdp_results, plain_results, key_fsdp, key_plain, case,
               shape):
    """The ZeRO-3 step of ``case`` against its step without FSDP: loss
    within ``LOSS_RTOL``, every param within ``PARAM_TOL``."""
    _, arch, over = case
    a = fsdp_results[0][key_fsdp]["metrics"]
    b = plain_results[0][key_plain]["metrics"]
    assert abs(a["loss"] - b["loss"]) <= LOSS_RTOL * abs(b["loss"])
    pa = unshard([r[key_fsdp] for r in fsdp_results], "params",
                 whole_specs(arch, over, shape, fsdp=True), shape)
    pb = unshard([r[key_plain] for r in plain_results], "params",
                 whole_specs(arch, over, shape), shape)
    assert pa.keys() == pb.keys()
    for path in pa:
        err = float(np.abs(pa[path] - pb[path]).max())
        assert err <= PARAM_TOL, f"{path}: {err:.3e}"

