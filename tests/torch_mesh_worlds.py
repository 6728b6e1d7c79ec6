"""What each rank of the mesh tests runs (``launch.mesh.run_world``).

These functions run in the ranks' own processes, which import torch and
the port only; the tests hold what they return against the reference in
the test process. Inputs come in as numpy (the reference's params, a
prompt, a batch), results go back as numpy.
"""

import dataclasses

import numpy as np
import torch

from repro_torch import configs, convert
from repro_torch.distributed import compression, sharding
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve, specs
from repro_torch.launch import train as train_launch
from repro_torch.models import transformer
from repro_torch.serving import engine
from repro_torch.training import data, optimizer, train_loop

# Smoke widths shard nothing (d_model 128 is one 128-row tile); these
# widen a smoke config so that every rule splits its leaf at model = 2,
# and tinyllama's wk/wv (4 KV heads of 64: two tiles) stays whole at 4.
WIDE = dict(d_model=512, d_ff=1024, n_heads=8, n_layers=2, vocab=256)
WIDE_KV = {"opt_30b": 8, "tinyllama_1_1b": 4}
# qwen2 widened with heads that split neither two nor four ways by head
# (3 KV heads under 12 query heads), whose widths do: every rank
# computes every head. Its 3-tile wk/wv stay whole at model 2 and 4.
WIDE_HEADS = {"qwen2_1_5b": dict(n_heads=12, n_kv=3, d_head=128)}
# The other families keep their smoke KV heads, and what the widening
# would take from them: recurrentgemma its one period of (rglru, rglru,
# attn), mamba2 its missing MLP, qwen2-vl M-RoPE sections that cover the
# widened head (64 / 2 frequencies).
WIDE_FAMILY = {"recurrentgemma_9b": dict(n_layers=3),
               "mamba2_130m": dict(d_ff=0),
               "qwen2_vl_2b": dict(mrope_sections=(8, 12, 12))}
SPARSE = ("'wq'", "'wk'", "'wv'", "'wo'", "'gate'", "'up'", "'down'")


def wide(cfg, arch: str, dtype: str, over=()):
    """``cfg`` (either package's smoke config) at the widened sizes, with
    ``over``'s ``(field, value)`` pairs on top."""
    heads = WIDE_HEADS.get(arch, {"n_kv": WIDE_KV.get(arch, cfg.n_kv)})
    return dataclasses.replace(cfg, dtype=dtype, **{
        **WIDE, **heads, **WIDE_FAMILY.get(arch, {}), **dict(over)})


def should_sparsify(name: str) -> bool:
    return name.endswith("['w']") and any(k in name for k in SPARSE)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _shards(tree) -> dict:
    """{path: numpy} of every leaf (Tiled-CSL words and nnz as int32)."""
    return {p: (v.numpy() if v.dtype in (torch.int32, torch.bool)
                else _np(v))
            for p, v in sharding.leaves_with_paths(tree)}


def _state(state) -> dict:
    """{checkpoint path: numpy} of a train state's tensor leaves."""
    return {p: v.detach().numpy() for p, v in ft.flatten_with_paths(state)
            if isinstance(v, torch.Tensor)}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def serve_cases(mesh, cases, prompt: np.ndarray, max_new: int) -> dict:
    """Per case ``(key, arch, dtype, sparsity, reference numpy params)``:
    this rank's prefill and first-step logits, its greedy stream and the
    logits of each step along it."""
    out = {}
    S = prompt.shape[1]
    p = torch.from_numpy(prompt).long()
    for key, arch, dtype, sparsity, np_params in cases:
        cfg = wide(configs.smoke(arch), arch, dtype)
        local = convert.rank_params_from_numpy(
            np_params, mesh, device="cpu", sparsity=sparsity,
            should_sparsify=should_sparsify)
        with torch.inference_mode():
            first, cache = engine.prefill(local, p, cfg, S + max_new,
                                          mesh=mesh)
            tok = torch.argmax(first, -1)[:, None]
            step, _ = engine.serve_step(local, cache, tok, S, cfg, mesh=mesh)
            toks = engine.generate(local, p, cfg, max_new_tokens=max_new,
                                   mesh=mesh)
            steps = []
            last, cache = engine.prefill(local, toks[:, :S], cfg,
                                         S + max_new, mesh=mesh)
            steps.append(_np(last))
            for i in range(max_new - 1):
                last, cache = engine.serve_step(
                    local, cache, toks[:, S + i:S + i + 1], S + i, cfg,
                    mesh=mesh)
                steps.append(_np(last))
        out[key] = dict(prefill=_np(first), step=_np(step),
                        tokens=toks.numpy(), steps=steps)
    return out


def build_shards(mesh, arch: str, over=None) -> dict:
    """``serve.build`` under the mesh against the shard of the unsharded
    build, leaf by leaf; the non-zeros of this rank's model-split
    Tiled-CSL leaves, of those it holds whole, and of the whole build.
    The widened smoke config of ``arch``, or with ``over`` the smoke
    config with those overrides."""
    cfg = (wide(configs.smoke(arch), arch, "bfloat16") if over is None
           else dataclasses.replace(configs.smoke(arch), dtype="bfloat16",
                                    **dict(over)))
    mine, _ = serve.build(cfg, sparsity=0.8, device="cpu", mesh=mesh)
    whole, report = serve.build(cfg, sparsity=0.8, device="cpu")
    want = sharding.shard_params(whole, mesh)
    got_leaves = dict(sharding.leaves_with_paths(mine))
    specs = sharding.params_shardings(whole, mesh)
    equal, nnz_split, nnz_whole = {}, 0, 0
    for path, w in sharding.leaves_with_paths(want):
        g = got_leaves.get(path)
        equal[path] = g is not None and g.dtype == w.dtype and \
            torch.equal(g, w)
        if path.endswith(".nnz") and g is not None:
            if sharding.model_sharded(specs[path]):
                nnz_split += int(g.sum())
            else:
                nnz_whole += int(g.sum())
    return dict(equal=equal, extra=sorted(set(got_leaves) - set(equal)),
                nnz_split=nnz_split, nnz_whole_leaves=nnz_whole,
                nnz_unsharded=report["nnz"])


def refusals(mesh) -> dict:
    """The message each refused config raises under this mesh."""
    out = {}
    for arch in configs.ARCH_IDS:
        cfg = configs.smoke(arch)
        try:
            transformer.init_cache(cfg, 1, 8, device="cpu", mesh=mesh)
        except (NotImplementedError, ValueError) as e:
            out[arch] = f"{type(e).__name__}: {e}"
    odd = dataclasses.replace(configs.smoke("tinyllama_1_1b"), n_kv=3,
                              n_heads=12)
    try:
        transformer.init_cache(odd, 1, 8, device="cpu", mesh=mesh)
    except ValueError as e:
        out["tinyllama_1_1b_kv3"] = f"ValueError: {e}"
    cfg = wide(configs.smoke("tinyllama_1_1b"), "tinyllama_1_1b", "float32")
    params = transformer.init_model(cfg, device="cpu")
    local = sharding.shard_params(params, mesh)
    tables = torch.zeros((1, 1), dtype=torch.int64)
    try:
        transformer.forward(local, {"tokens": torch.zeros((1, 1),
                                                          dtype=torch.long)},
                            cfg, mode="decode", cache=[{}] * cfg.n_layers,
                            pos=0, block_tables=tables, mesh=mesh)
    except NotImplementedError as e:
        out["paged"] = f"NotImplementedError: {e}"
    return out


def serve_world(mesh, cases, prompt, max_new, with_refusals) -> dict:
    """A serving world of the mesh tests: ``serve_cases``, ``build_shards``
    of each arch, and (``with_refusals``) ``refusals``."""
    archs = sorted({arch for _, arch, _, _, _ in cases})
    out = dict(serve=serve_cases(mesh, cases, prompt, max_new),
               build={a: build_shards(mesh, a) for a in archs})
    if with_refusals:
        out["refusals"] = refusals(mesh)
    return out


# ---------------------------------------------------------------------------
# training, checkpoints, compression
# ---------------------------------------------------------------------------

def _opt():
    return optimizer.AdamW(lr=optimizer.cosine_schedule(3e-4, 20, 100))


def train_step(mesh, arch: str, np_params, batch, sparsity,
               ckpt_dir=None, fsdp: bool = False) -> dict:
    """One sharded f32 train step from the reference's params (masked by
    the launcher's rule on the whole leaves): the metrics, this rank's
    new params, its coordinates; with ``ckpt_dir`` the state is saved
    there (whole arrays) from this mesh. ``fsdp``: ZeRO-3 shards."""
    cfg = wide(configs.smoke(arch), arch, "float32")
    whole = convert.params_from_numpy(np_params, device="cpu")
    masks = None
    if sparsity:
        masks = train_launch.reference_masks(whole, cfg, sparsity)
        whole = optimizer.apply_masks(whole, masks)
    shardings = sharding.params_shardings(whole, mesh, fsdp=fsdp)
    params = sharding.shard_params(whole, mesh, fsdp=fsdp)
    if masks is not None:
        masks = sharding.shard_params(masks, mesh, fsdp=fsdp)
    opt = _opt()
    state = train_loop.TrainState(params, opt.init(params),
                                  torch.zeros((), dtype=torch.int32))
    step = train_loop.make_train_step(cfg, opt, masks=masks, mesh=mesh,
                                      shardings=shardings, fsdp=fsdp)
    local = data.batch_slice(batch, mesh.get_local_rank("data"),
                             mesh.size(0))
    state, metrics = step(state, train_loop.batch_to(local, "cpu"))
    if ckpt_dir is not None:
        ft.CheckpointManager(ckpt_dir).save(
            1, (state, {"seed": 0, "step": 1}), mesh=mesh,
            shardings=shardings, block=True)
    return dict(loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]),
                params=_shards(state.params),
                masks=None if masks is None else _shards(masks),
                state=_state(state), coords=sharding.coordinates(mesh))


def restore_shards(mesh, arch: str, ckpt_dir: str,
                   fsdp: bool = False) -> dict:
    """This rank's shard of the checkpoint in ``ckpt_dir``, restored onto
    a template of its own shapes (``fsdp``: ZeRO-3 shards)."""
    cfg = wide(configs.smoke(arch), arch, "float32")
    whole = transformer.init_model(cfg, device="cpu")
    params = sharding.shard_params(whole, mesh, fsdp=fsdp)
    opt = _opt()
    template = (train_loop.TrainState(params, opt.init(params),
                                      torch.zeros((), dtype=torch.int32)),
                {"seed": 0, "step": 0})
    (state, _), meta = ft.CheckpointManager(ckpt_dir).restore(
        template, mesh=mesh, fsdp=fsdp)
    return dict(state=_state(state), coords=sharding.coordinates(mesh),
                step=meta["step"])


def compressed(mesh, xs, tree) -> dict:
    """``compressed_all_reduce`` of this data rank's row of each of
    ``xs`` over ``data``; ``make_compressed_grad_allreduce`` of this
    rank's ``tree``; one ``ErrorFeedback`` round."""
    group = mesh.get_group("data")
    r = mesh.get_local_rank("data")
    sums = [compression.compressed_all_reduce(torch.from_numpy(x[r]),
                                              group).numpy() for x in xs]
    mine = {k: torch.from_numpy(v[r]) for k, v in tree.items()}
    reduced = compression.make_compressed_grad_allreduce(mesh)(mine)
    ef = compression.ErrorFeedback(mine)
    comp = ef.compensate(mine)
    sent = compression.make_compressed_grad_allreduce(mesh)(comp)
    ef.update(comp, sent)
    return dict(sums=sums,
                reduced={k: v.numpy() for k, v in reduced.items()},
                compensated={k: v.numpy() for k, v in comp.items()},
                sent={k: v.numpy() for k, v in sent.items()},
                residual={k: v.numpy() for k, v in ef.residual.items()})


def train_world(mesh, cases, ckpt_root=None, compress=None,
                restore_root=None) -> dict:
    """A training world of the sharding tests: one ``train_step`` per
    ``(arch, reference numpy params, batch)`` case (saved under
    ``ckpt_root/<arch>`` where given), ``compressed`` on ``compress``'s
    ``(xs, tree)``, and ``restore_shards`` of ``restore_root/<arch>``."""
    out = {}
    for arch, np_params, batch in cases:
        out[arch] = train_step(
            mesh, arch, np_params, batch, 0.8,
            ckpt_dir=None if ckpt_root is None else f"{ckpt_root}/{arch}")
    if compress is not None:
        out["compression"] = compressed(mesh, *compress)
    if restore_root is not None:
        out["restored"] = {arch: restore_shards(mesh, arch,
                                                f"{restore_root}/{arch}")
                           for arch, _, _ in cases}
    return out


def decode_step_logits(mesh, arch: str, n_layers: int, sparsity: float,
                       prompt: np.ndarray, max_len=None, layout=False):
    """The first decode step's logits of ``arch`` at full width cut to
    ``n_layers``, built by ``serve.build`` under the mesh on this rank's
    device (the card in the GPU tests), the cache ``max_len`` long
    (default: the prompt and one step); with ``layout`` also the axis
    the cache's positions split over."""
    cfg = dataclasses.replace(configs.get(arch), n_layers=n_layers)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")
    params, _ = serve.build(cfg, sparsity=sparsity, device=dev, mesh=mesh)
    p = torch.from_numpy(prompt).long().to(dev)
    S = p.shape[1]
    with torch.inference_mode():
        last, cache = engine.prefill(params, p, cfg, max_len or S + 1,
                                     mesh=mesh)
        tok = torch.argmax(last, -1)[:, None]
        step, _ = engine.serve_step(params, cache, tok, S, cfg, mesh=mesh)
    logits = step.float().cpu().numpy()
    return (logits, cache.seq) if layout else logits


# ---------------------------------------------------------------------------
# the sequence-sharded K/V cache and FSDP (tests/test_torch_seqshard.py)
# ---------------------------------------------------------------------------

def _kv_blocks(cache, mesh, batch: int) -> dict:
    """This rank's K/V blocks (f32 numpy, per layer) and where they sit
    in the whole ``[batch, max_len, n_kv, hd]`` leaves: (row, position,
    head, head-dim) offsets."""
    rows = transformer.cache_rows(cache, mesh, batch)
    k = cache[0]["k"]
    at = [rows.start, 0, 0, 0]
    if cache.seq is not None:
        at[1] = mesh.get_local_rank(cache.seq) * k.shape[1]
    if cache.head_dim is not None:
        at[3] = mesh.get_local_rank(cache.head_dim) * k.shape[3]
    elif cache.seq != "model" and "model" in mesh.mesh_dim_names:
        at[2] = mesh.get_local_rank("model") * k.shape[2]
    return dict(at=tuple(at), kv=[(_np(c["k"]), _np(c["v"]))
                                  for c in cache])


class _Tap:
    """While entered, keeps each logits tensor ``engine.generate``
    samples from (f32 numpy, one a step)."""

    def __init__(self, engine_mod):
        self.engine, self.logits = engine_mod, []

    def __enter__(self):
        self.orig = self.engine.sample_per_slot

        def tapped(logits, *args, **kw):
            self.logits.append(_np(logits))
            return self.orig(logits, *args, **kw)
        self.engine.sample_per_slot = tapped
        return self

    def __exit__(self, *exc):
        self.engine.sample_per_slot = self.orig


def seq_serve_cases(mesh, cases, prompts, max_len: int, max_new: int,
                    first_tokens: dict) -> dict:
    """Per case ``(key, arch, dtype, sparsity, numpy params, seq_shard)``
    and per prompt set: this rank's prefill logits, its first step's
    (teacher-forced with ``first_tokens[key, name]``, the reference's)
    and its K/V blocks after each, ``engine.generate``'s greedy stream
    and the logits it sampled each token from, at ``max_len``, and the
    cache's layout; or the refusal's message."""
    out = {}
    for key, arch, dtype, sparsity, np_params, seq_shard in cases:
        cfg = wide(configs.smoke(arch), arch, dtype)
        local = convert.rank_params_from_numpy(
            np_params, mesh, device="cpu", sparsity=sparsity,
            should_sparsify=should_sparsify)
        for name, prompt in prompts.items():
            if (key, name) not in first_tokens:     # not this case's
                continue
            p = torch.from_numpy(prompt).long()
            S = p.shape[1]
            kw = dict(mesh=mesh, seq_shard=seq_shard)
            try:
                with torch.inference_mode():
                    first, cache = engine.prefill(local, p, cfg, max_len,
                                                  **kw)
                    kv_pre = _kv_blocks(cache, mesh, p.shape[0])
                    tok = torch.from_numpy(
                        first_tokens[key, name]).long()[:, None]
                    step, _ = engine.serve_step(local, cache, tok, S, cfg,
                                                mesh=mesh)
                    kv_step = _kv_blocks(cache, mesh, p.shape[0])
                    with _Tap(engine) as tap:
                        toks = engine.generate(local, p, cfg,
                                               max_new_tokens=max_new,
                                               max_len=max_len, **kw)
                    steps = tap.logits
            except (NotImplementedError, ValueError) as e:
                out[key, name] = dict(error=f"{type(e).__name__}: {e}")
                continue
            out[key, name] = dict(
                prefill=_np(first), step=_np(step), tokens=toks.numpy(),
                steps=steps, seq=cache.seq, batch=cache.batch,
                local=tuple(cache[0]["k"].shape), kv_pre=kv_pre,
                kv_step=kv_step)
    return out


def device_cells(mesh, shapes) -> dict:
    """``specs.build_cell`` on the CPU inside the world for each
    ``(name, kind, seq_len, batch)`` of widened smoke tinyllama (dense),
    run once: its per-rank argument bytes beside those of the same cell
    on meta on a dry mesh of this rank's coordinates, and what it gave."""
    from repro_torch.models.config import ShapeConfig
    cfg = wide(configs.smoke("tinyllama_1_1b"), "tinyllama_1_1b", "float32")
    names = mesh.mesh_dim_names
    shape = tuple(mesh.size(i) for i in range(len(names)))
    rank = 0
    for n, size in zip(names, shape):
        rank = rank * size + mesh.get_local_rank(n)
    out = {}
    for name, kind, seq, batch in shapes:
        sc = ShapeConfig(name, kind, seq, batch)
        cell = specs.build_cell(cfg, sc, mesh, device="cpu")
        dry = specs.build_cell(cfg, sc, mesh_mod.DryMesh(shape, names,
                                                         rank=rank))
        with torch.set_grad_enabled(kind == "train"):
            got = cell.fn(*cell.args)
        first = got[1]["loss"] if kind == "train" else got[0]
        out[name] = dict(bytes=cell.arg_bytes(), dry=dry.arg_bytes(),
                         finite=bool(torch.isfinite(first).all()),
                         shape=tuple(first.shape))
    return out


def seq_world(mesh, serve, train, ckpt_root=None, restore_root=None,
              cells=()) -> dict:
    """A world of the sequence-sharding tests: ``seq_serve_cases(*serve)``
    where given; one FSDP ``train_step`` per ``(arch, numpy params,
    batch)`` of ``train`` (saved under ``ckpt_root/<arch>``);
    ``restore_root/<arch>`` restored without FSDP; ``device_cells`` of
    ``cells``."""
    out = {"coords": sharding.coordinates(mesh),
           "cells": device_cells(mesh, cells)}
    if serve is not None:
        out["serve"] = seq_serve_cases(mesh, *serve)
    for arch, np_params, batch in train:
        out[arch] = train_step(
            mesh, arch, np_params, batch, 0.8, fsdp=True,
            ckpt_dir=None if ckpt_root is None else f"{ckpt_root}/{arch}")
    if restore_root is not None:
        out["restored"] = {arch: restore_shards(mesh, arch,
                                                f"{restore_root}/{arch}")
                           for arch in ("opt_30b", "tinyllama_1_1b")}
    return out


# ---------------------------------------------------------------------------
# MoE and MLA under a mesh (tests/test_torch_mesh_moe.py, _mla.py)
# ---------------------------------------------------------------------------

STACKS = ("['gate']", "['up']", "['down']")


def family_sparsify(name: str) -> bool:
    """The serving build's weights (``SPARSE``' names ending in ``['w']``)
    and MoE's routed stacks (bare ``moe['gate']``, ``['up']``,
    ``['down']`` leaves)."""
    return should_sparsify(name) or (
        "['moe']" in name and name.endswith(STACKS))


# every MLA factor as well (the reference's default_should_sparsify)
FACTORS = ("'w_dq'", "'w_uq'", "'w_dkv'", "'w_ukv'")


def family_sparsify_all(name: str) -> bool:
    """:func:`family_sparsify` and MLA's latent factors."""
    return family_sparsify(name) or (name.endswith("['w']") and any(
        k in name for k in FACTORS))


# overrides that are not config fields: ``one`` serves the first prompt
# alone with the sequence over ``data`` (``seq_shard``), ``factors``
# encodes MLA's latent factors too
CASE_FLAGS = ("one", "factors")


def family_config(case):
    """The port config of a family case ``(key, arch, dtype, sparsity,
    overrides, ...)``."""
    _, arch, dtype, _, over = case[:5]
    over = {k: v for k, v in over if k not in CASE_FLAGS}
    return dataclasses.replace(configs.smoke(arch), dtype=dtype, **over)


class _RouteTap:
    """While entered, records each MoE block's routing on this rank:
    (the experts each token picked, ``[G, sg, E]`` 0/1, and their
    capacity positions, -1 where not picked)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.calls = moe, []

    def __enter__(self):
        self.orig = self.moe._positions

        def tapped(oh_e, *args):
            pos = self.orig(oh_e, *args)
            self.calls.append((oh_e.numpy().astype(np.int8), pos.numpy()))
            return pos
        self.moe._positions = tapped
        return self

    def __exit__(self, *exc):
        self.moe._positions = self.orig


def cache_blocks(cache, mesh, batch: int) -> dict:
    """This rank's cache blocks (f32 numpy, per layer, each layer's
    leaves in name order: K/V, or MLA's ``ckv``/``krope``) and where they
    sit in the whole leaves: (row, position, head) offsets (the head
    offset 0 for latents, whole over ``model``)."""
    rows = transformer.cache_rows(cache, mesh, batch)
    first = cache[0][sorted(cache[0])[0]]
    at = [rows.start, 0, 0]
    if cache.seq is not None:
        at[1] = mesh.get_local_rank(cache.seq) * first.shape[1]
    if first.dim() == 4 and cache.seq != "model" and \
            "model" in mesh.mesh_dim_names:
        at[2] = mesh.get_local_rank("model") * first.shape[2]
    return dict(at=tuple(at), kv=[tuple(_np(c[n]) for n in sorted(c))
                                  for c in cache])


def family_cases(mesh, cases, prompt: np.ndarray, max_len: int,
                 max_new: int, step_pos: np.ndarray) -> dict:
    """Per case ``(key, arch, dtype, sparsity, overrides, numpy params,
    first tokens)``: this rank's prefill logits and routes; one decode
    step at per-slot positions ``step_pos`` teacher-forced with the
    reference's first tokens, its logits and routes; the cache's blocks
    after each (``cache_blocks``); ``engine.generate``'s greedy stream
    and the logits of each step along it; the cache's layout."""
    out = {}
    for case in cases:
        key, _, _, sparsity, over, np_params, first_tok = case
        flags = {k: v for k, v in over if k in CASE_FLAGS}
        cfg = family_config(case)
        local = convert.rank_params_from_numpy(
            np_params, mesh, device="cpu", sparsity=sparsity,
            should_sparsify=family_sparsify_all if flags.get("factors")
            else family_sparsify)
        one = bool(flags.get("one"))
        p = torch.from_numpy(prompt[:1] if one else prompt).long()
        pos = torch.from_numpy(step_pos[:1] if one else step_pos)
        kw = dict(mesh=mesh, seq_shard=one)
        with torch.inference_mode(), _RouteTap() as tap:
            first, cache = engine.prefill(local, p, cfg, max_len, **kw)
            kv_pre = cache_blocks(cache, mesh, p.shape[0])
            pre_routes = list(tap.calls)
            tap.calls.clear()
            tok = torch.from_numpy(first_tok).long()[:, None]
            step, _ = engine.serve_step(local, cache, tok, pos, cfg,
                                        mesh=mesh)
            step_routes = list(tap.calls)
            kv_step = cache_blocks(cache, mesh, p.shape[0])
            with _Tap(engine) as logit_tap:
                toks = engine.generate(local, p, cfg, max_new_tokens=max_new,
                                       max_len=max_len, **kw)
        out[key] = dict(prefill=_np(first), step=_np(step),
                        tokens=toks.numpy(), steps=logit_tap.logits,
                        seq=cache.seq, batch=cache.batch, kv_pre=kv_pre,
                        kv_step=kv_step,
                        rows=(lambda r: (r.start, r.stop))(
                            transformer.cache_rows(cache, mesh, p.shape[0])),
                        routes=dict(prefill=pre_routes, step=step_routes))
    return out


def family_world(mesh, serve_args, builds=()) -> dict:
    """A world of the MoE/MLA mesh tests: ``family_cases(*serve_args)``
    and ``build_shards`` of each ``(arch, overrides)`` in ``builds``."""
    return dict(coords=sharding.coordinates(mesh),
                serve=family_cases(mesh, *serve_args),
                build={f"{a}-{dict(o)}": build_shards(mesh, a, o)
                       for a, o in builds})


# ---------------------------------------------------------------------------
# the SSM, hybrid, vlm and audio families under a mesh
# (tests/test_torch_mesh_ssm.py, _ring.py, _media.py)
# ---------------------------------------------------------------------------

def leaf_blocks(cache, cfg, mesh, batch: int, max_len: int,
                seq_shard: bool) -> list:
    """This rank's block of every cache leaf (f32 numpy, per layer, each
    layer's leaves in name order) with its offset in the whole leaf, dim
    by dim, from ``sharding.cache_shardings``' spec of that leaf: K/V
    rows, positions (ring slots), heads and head dim; the recurrent
    states' rows."""
    whole = transformer.init_cache(cfg, batch, max_len, device="meta")
    specs = sharding.cache_shardings(whole, mesh, seq_shard=seq_shard)
    sizes, coords = sharding.axis_sizes(mesh), sharding.coordinates(mesh)
    out = []
    for i, layer in enumerate(cache):
        leaves = []
        for name in sorted(layer):
            t = layer[name]
            spec = specs[f"[{i}]['{name}']"]
            at = tuple(0 if e is None else sharding._shard_index(
                e, sizes, coords)[1] * t.shape[d] for d, e in enumerate(spec))
            leaves.append((at, _np(t).copy()))     # decode writes t
        out.append(leaves)
    return out


def _greedy(params, prompt, cfg, max_len: int, max_new: int, inputs: dict,
            kw: dict) -> torch.Tensor:
    """``engine.generate``'s greedy loop from a prefill with ``inputs``
    (``embeds``, M-RoPE ``positions``), which ``generate`` does not
    take: the decode steps go on at the cache's next index, as the
    reference's ``serve_step`` does."""
    S = prompt.shape[-1]
    uids = torch.arange(prompt.shape[0])
    sample = lambda logits, i: engine.sample_per_slot(
        logits, uids, torch.full_like(uids, i), temperature=0.0)
    last, cache = engine.prefill(params, prompt, cfg, max_len, **inputs,
                                 **kw)
    out, tok = [prompt], sample(last, S)
    for i in range(max_new):
        out.append(tok[:, None])
        if i == max_new - 1:
            break
        logits, cache = engine.serve_step(params, cache, tok[:, None],
                                          S + i, cfg, mesh=kw["mesh"])
        tok = sample(logits, S + i + 1)
    return torch.cat(out, dim=-1)


def media_cases(mesh, cases, max_new: int) -> dict:
    """Per case ``(key, arch, dtype, sparsity, overrides, numpy params,
    prompt, max_len, one, extra, first tokens)``: this rank's prefill
    logits (``extra``: numpy ``embeds``/``positions``, whole batch), its
    cache blocks after the prefill and after one decode step at the
    prompt's end teacher-forced with the reference's first tokens
    (``leaf_blocks``), that step's logits, ``engine.generate``'s greedy
    stream (with ``extra``, the same loop from the prefill with those
    inputs, ``_greedy``) and the logits of each step along it, and the
    cache's layout.
    ``one`` serves with ``seq_shard``."""
    out = {}
    for case in cases:
        (key, arch, dtype, sparsity, over, np_params, prompt, max_len, one,
         extra, first_tok) = case
        cfg = dataclasses.replace(configs.smoke(arch), dtype=dtype,
                                  **dict(over))
        local = convert.rank_params_from_numpy(
            np_params, mesh, device="cpu", sparsity=sparsity,
            should_sparsify=should_sparsify)
        p = torch.from_numpy(prompt).long()
        B, S = p.shape[0], p.shape[-1]
        kw = dict(mesh=mesh, seq_shard=one)
        inputs = {k: torch.from_numpy(v) for k, v in (extra or {}).items()}
        if "positions" in inputs:
            inputs["positions"] = inputs["positions"].long()
        with torch.inference_mode():
            first, cache = engine.prefill(local, p, cfg, max_len, **inputs,
                                          **kw)
            pre = leaf_blocks(cache, cfg, mesh, B, max_len, one)
            tok = torch.from_numpy(first_tok).long()[..., None]
            step, _ = engine.serve_step(local, cache, tok, S, cfg, mesh=mesh)
            after = leaf_blocks(cache, cfg, mesh, B, max_len, one)
            with _Tap(engine) as tap:
                if inputs:
                    toks = _greedy(local, p, cfg, max_len, max_new, inputs,
                                   kw)
                else:
                    toks = engine.generate(local, p, cfg,
                                           max_new_tokens=max_new,
                                           max_len=max_len, **kw)
        out[key] = dict(prefill=_np(first), step=_np(step),
                        tokens=toks.numpy(), steps=tap.logits,
                        seq=cache.seq, batch=cache.batch,
                        head_dim=cache.head_dim, kv_pre=pre, kv_step=after)
    return out


def media_world(mesh, cases, max_new: int, builds=()) -> dict:
    """A world of the SSM, ring and media mesh tests: ``media_cases`` and
    ``build_shards`` of each ``(arch, overrides)`` in ``builds``."""
    return dict(coords=sharding.coordinates(mesh),
                serve=media_cases(mesh, cases, max_new),
                build={f"{a}-{dict(o)}": build_shards(mesh, a, o)
                       for a, o in builds})


# ---------------------------------------------------------------------------
# training every family under a mesh (tests/test_torch_mesh_train_*.py)
# ---------------------------------------------------------------------------

class _GradTap:
    """An optimizer that keeps the gradients its last update took (a
    rank's shards, reduced as the step reduces them) and otherwise is
    ``opt``."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, *args, **kw):
        self.grads = grads
        return self.opt.update(grads, *args, **kw)


def family_train_step(mesh, arch: str, over, np_params, batch,
                      fsdp: bool = False, ckpt_dir=None) -> dict:
    """One sharded masked f32 step of the widened smoke ``arch`` (with
    ``over``) from the reference's params (masked by the launcher's rule
    on the whole leaves): its metrics, this rank's gradient shards (the
    ones the update took) and new params, its masks, the MoE blocks'
    routing (each token's experts and capacity positions), the raw
    collectives reached while gradients were on, and with ``ckpt_dir``
    the state saved there from this mesh."""
    from repro_torch.distributed import tensor_parallel
    cfg = wide(configs.smoke(arch), arch, "float32", over)
    whole = convert.params_from_numpy(np_params, device="cpu")
    masks = train_launch.reference_masks(whole, cfg, 0.8)
    whole = optimizer.apply_masks(whole, masks)
    shardings = sharding.params_shardings(whole, mesh, fsdp=fsdp)
    params = sharding.shard_params(whole, mesh, fsdp=fsdp)
    masks = sharding.shard_params(masks, mesh, fsdp=fsdp)
    opt = _GradTap(_opt())
    state = train_loop.TrainState(params, opt.init(params),
                                  torch.zeros((), dtype=torch.int32))
    step = train_loop.make_train_step(cfg, opt, masks=masks, mesh=mesh,
                                      shardings=shardings, fsdp=fsdp)
    local = train_loop.batch_to(data.batch_slice(
        batch, mesh.get_local_rank("data"), mesh.size(0)), "cpu")
    tensor_parallel.raw_under_grad = 0
    with _RouteTap() as tap:
        state, metrics = step(state, local)
    out = dict(coords=sharding.coordinates(mesh),
               raw_under_grad=tensor_parallel.raw_under_grad,
               metrics={k: float(v) for k, v in metrics.items()},
               grads=_shards(opt.grads), params=_shards(state.params),
               masks=_shards(masks), routes=tap.calls)
    if ckpt_dir is not None:
        ft.CheckpointManager(ckpt_dir).save(
            1, (state, {"seed": 0, "step": 1}), mesh=mesh,
            shardings=shardings, block=True)
        out["state"] = _state(state)
    return out


def family_restore(mesh, arch: str, over, ckpt_dir: str) -> dict:
    """This rank's shard of the widened smoke ``arch``'s checkpoint in
    ``ckpt_dir``, restored onto a template of its own shapes."""
    cfg = wide(configs.smoke(arch), arch, "float32", over)
    params = sharding.shard_params(transformer.init_model(cfg, device="cpu"),
                                   mesh)
    opt = _opt()
    template = (train_loop.TrainState(params, opt.init(params),
                                      torch.zeros((), dtype=torch.int32)),
                {"seed": 0, "step": 0})
    (state, _), meta = ft.CheckpointManager(ckpt_dir).restore(template,
                                                              mesh=mesh)
    return dict(state=_state(state), coords=sharding.coordinates(mesh),
                step=meta["step"])


def family_train_world(mesh, plans) -> dict:
    """A world of the family training tests: for each ``(name, (d, m),
    cases, restore)`` of ``plans`` in turn, a ``d x m`` mesh over this
    world's ranks, ``family_train_step`` of each ``(key, arch,
    overrides, numpy params, batch, fsdp, ckpt_dir)`` case on it, then
    ``family_restore`` of each ``(key, arch, overrides, ckpt_dir)`` of
    ``restore``; by name."""
    out = {}
    for name, (d, m), cases, restore in plans:
        sub = mesh_mod.make_host_mesh(d * m, m, device_type=mesh.device_type)
        res = {key: family_train_step(sub, arch, over, p, batch, fsdp, ckpt)
               for key, arch, over, p, batch, fsdp, ckpt in cases}
        res["restored"] = {key: family_restore(sub, arch, over, ckpt)
                           for key, arch, over, ckpt in restore}
        out[name] = res
    return out
