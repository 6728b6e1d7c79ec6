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
from repro_torch.launch import serve
from repro_torch.launch import train as train_launch
from repro_torch.models import transformer
from repro_torch.serving import engine
from repro_torch.training import data, optimizer, train_loop

# Smoke widths shard nothing (d_model 128 is one 128-row tile); these
# widen a smoke config so that every rule splits its leaf at model = 2,
# and tinyllama's wk/wv (4 KV heads of 64: two tiles) stays whole at 4.
WIDE = dict(d_model=512, d_ff=1024, n_heads=8, n_layers=2, vocab=256)
WIDE_KV = {"opt_30b": 8, "tinyllama_1_1b": 4}
SPARSE = ("'wq'", "'wk'", "'wv'", "'wo'", "'gate'", "'up'", "'down'")


def wide(cfg, arch: str, dtype: str):
    """``cfg`` (either package's smoke config) at the widened sizes."""
    return dataclasses.replace(cfg, n_kv=WIDE_KV[arch], dtype=dtype, **WIDE)


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


def build_shards(mesh, arch: str) -> dict:
    """``serve.build`` under the mesh against the shard of the unsharded
    build, leaf by leaf; the non-zeros of this rank's model-split
    Tiled-CSL leaves, of those it holds whole, and of the whole build."""
    cfg = wide(configs.smoke(arch), arch, "bfloat16")
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
               ckpt_dir=None) -> dict:
    """One sharded f32 train step from the reference's params (masked by
    the launcher's rule on the whole leaves): the metrics, this rank's
    new params, its coordinates; with ``ckpt_dir`` the state is saved
    there (whole arrays) from this mesh."""
    cfg = wide(configs.smoke(arch), arch, "float32")
    whole = convert.params_from_numpy(np_params, device="cpu")
    masks = None
    if sparsity:
        masks = train_launch.reference_masks(whole, cfg, sparsity)
        whole = optimizer.apply_masks(whole, masks)
    shardings = sharding.params_shardings(whole, mesh)
    params = sharding.shard_params(whole, mesh)
    if masks is not None:
        masks = sharding.shard_params(masks, mesh)
    opt = _opt()
    state = train_loop.TrainState(params, opt.init(params),
                                  torch.zeros((), dtype=torch.int32))
    step = train_loop.make_train_step(cfg, opt, masks=masks, mesh=mesh,
                                      shardings=shardings)
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


def restore_shards(mesh, arch: str, ckpt_dir: str) -> dict:
    """This rank's shard of the checkpoint in ``ckpt_dir``, restored onto
    a template of its own shapes."""
    cfg = wide(configs.smoke(arch), arch, "float32")
    whole = transformer.init_model(cfg, device="cpu")
    params = sharding.shard_params(whole, mesh)
    opt = _opt()
    template = (train_loop.TrainState(params, opt.init(params),
                                      torch.zeros((), dtype=torch.int32)),
                {"seed": 0, "step": 0})
    (state, _), meta = ft.CheckpointManager(ckpt_dir).restore(template,
                                                              mesh=mesh)
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
                       prompt: np.ndarray) -> np.ndarray:
    """The first decode step's logits of ``arch`` at full width cut to
    ``n_layers``, built by ``serve.build`` under the mesh on this rank's
    device (the card in the GPU tests)."""
    cfg = dataclasses.replace(configs.get(arch), n_layers=n_layers)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")
    params, _ = serve.build(cfg, sparsity=sparsity, device=dev, mesh=mesh)
    p = torch.from_numpy(prompt).long().to(dev)
    S = p.shape[1]
    with torch.inference_mode():
        last, cache = engine.prefill(params, p, cfg, S + 1, mesh=mesh)
        tok = torch.argmax(last, -1)[:, None]
        step, _ = engine.serve_step(params, cache, tok, S, cfg, mesh=mesh)
    return step.float().cpu().numpy()
