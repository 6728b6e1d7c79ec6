"""Weight pruning and the dense -> Tiled-CSL reformatting tool (paper §5).

The counterpart of ``repro.core.pruning``, on torch tensors so that it
runs on the card: the importance scores the paper prunes by (magnitude,
and the first-order Taylor score of §6.3.1), global and tile-balanced
masks, the paper's OPT layer plan (:func:`opt_style_plan`), and the
reformatting of params trees to Tiled-CSL. Params trees are nested
dicts with per-layer lists (``params["layers"][i]``) where the JAX
package has scan-stacked ``[L, ...]`` leaves; leaves at the same place
in every element of a list share one ``max_nnz``, as the reference's
stacked leaves do, so the encodings compare byte for byte.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import sparse_linear, tiled_csl

METHODS = ("magnitude", "taylor")

# ---------------------------------------------------------------------------
# importance scores
# ---------------------------------------------------------------------------


def magnitude_scores(w: torch.Tensor) -> torch.Tensor:
    """Magnitude pruning (paper §3.1): |w|."""
    return w.abs()


def taylor_scores(w: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """First-order Taylor importance (paper §6.3.1): |w * dL/dw|, the loss
    change of zeroing the weight, to first order."""
    return (w * grad).abs()


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------


def unstructured_mask(scores: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Global top-(1-sparsity) mask over the whole matrix; over each
    matrix of a stack ``[E, M, K]``."""
    if sparsity <= 0.0:
        return torch.ones_like(scores, dtype=torch.bool)
    lead = scores.shape[:-2]
    flat = scores.reshape(-1, scores.shape[-2] * scores.shape[-1])
    k = max(int(round(flat.shape[1] * (1.0 - sparsity))), 1)
    # The k-th largest score, i.e. sorted(scores)[-k]: the least of the top
    # k. (``kthvalue`` gives the same element, but on a card it selects a
    # whole matrix in one thread block, which made it most of the build.)
    thresh = torch.topk(flat, k, dim=-1, sorted=False).values.min(-1).values
    return scores >= thresh.reshape(lead + (1, 1))


def tile_balanced_mask(scores: torch.Tensor, sparsity: float,
                       m_tb: int = tiled_csl.DEFAULT_M_TB,
                       k_tb: int = tiled_csl.DEFAULT_K_TB) -> torch.Tensor:
    """Keep exactly ceil((1-s) * m_tb * k_tb) top elements per tile."""
    m, k = scores.shape
    if m % m_tb or k % k_tb:
        raise ValueError(f"shape {(m, k)} not tile-aligned")
    tile = m_tb * k_tb
    keep = max(math.ceil(tile * (1.0 - sparsity)), 1)
    flat = scores.reshape(m // m_tb, m_tb, k // k_tb, k_tb).permute(
        0, 2, 1, 3).reshape(m // m_tb, k // k_tb, tile)
    thresh = torch.kthvalue(flat, tile - keep + 1, dim=-1).values[..., None]
    mask = flat >= thresh
    return mask.reshape(m // m_tb, k // k_tb, m_tb, k_tb).permute(
        0, 2, 1, 3).reshape(m, k)


def prune(w: torch.Tensor, sparsity: float, *, method: str = "magnitude",
          grad: Optional[torch.Tensor] = None,
          balanced: bool = False) -> torch.Tensor:
    """The masked dense weight, scored by ``method`` (``"magnitude"``, or
    ``"taylor"`` with the loss gradient ``grad``); each matrix of a stack
    ``[E, M, K]`` on its own. An unknown method, or ``"taylor"`` without
    a gradient, raises ``ValueError``."""
    if method not in METHODS:
        raise ValueError(f"unknown pruning method {method!r}; expected one "
                         f"of {METHODS}")
    if method == "taylor" and grad is None:
        raise ValueError("taylor pruning needs the loss gradient (grad=)")
    if balanced and w.dim() == 3:
        return torch.stack([
            prune(x, sparsity, method=method, balanced=True,
                  grad=None if grad is None else grad[i])
            for i, x in enumerate(w)])
    scores = (magnitude_scores(w) if method == "magnitude"
              else taylor_scores(w, grad))
    mask = (tile_balanced_mask(scores, sparsity) if balanced
            else unstructured_mask(scores, sparsity))
    del scores
    return torch.where(mask, w, torch.zeros((), dtype=w.dtype,
                                            device=w.device))


# ---------------------------------------------------------------------------
# layerwise sparsity plans (paper §6.3.1: first/last quarter MLP kept dense)
# ---------------------------------------------------------------------------

def opt_style_plan(n_layers: int, sparsity: float) -> Dict[int, float]:
    """The paper's OPT-30B recipe: the feed-forward layers of the first
    and last quarter stay dense (0.0), the rest are pruned at
    ``sparsity``."""
    q = n_layers // 4
    return {layer: 0.0 if (layer < q or layer >= n_layers - q) else sparsity
            for layer in range(n_layers)}


# ---------------------------------------------------------------------------
# reformatting: dense params -> Tiled-CSL params
# ---------------------------------------------------------------------------

def _pad_to_tiles(w: torch.Tensor, m_tb: int, k_tb: int) -> torch.Tensor:
    m, k = w.shape[-2:]
    mp, kp = -(-m // m_tb) * m_tb, -(-k // k_tb) * k_tb
    return w if (mp, kp) == (m, k) else F.pad(w, (0, kp - k, 0, mp - m))


def sparsify_matrix(w: torch.Tensor, sparsity: float, *,
                    balanced: bool = False,
                    m_tb: int = tiled_csl.DEFAULT_M_TB,
                    k_tb: int = tiled_csl.DEFAULT_K_TB,
                    max_nnz: int | None = None) -> tiled_csl.TiledCSL:
    """Prune a dense [M, K] weight (in f32) by magnitude and encode it as
    Tiled-CSL; ``max_nnz`` re-pads the word streams to a shared target.
    An expert stack ``[E, M, K]`` is pruned and encoded per expert,
    padded to the stack's largest ``max_nnz`` (the reference's
    ``ndim == 3`` branch of ``sparsify_params``), into one stack
    (``tiled_csl.encode_stack``). Taylor pruning needs the loss gradient,
    which a reformatting call does not have: it is
    ``prune(w, s, method="taylor", grad=g)`` followed by
    ``tiled_csl.encode`` (the reference's ``method="taylor"`` here passes
    no gradient and fails: ROADMAP.md queue 3 item 17)."""
    wp = _pad_to_tiles(prune(w.to(torch.float32), sparsity,
                             balanced=balanced), m_tb, k_tb)
    encode = tiled_csl.encode_stack if wp.dim() == 3 else tiled_csl.encode
    t = encode(wp, m_tb=m_tb, k_tb=k_tb)
    return t if max_nnz is None else tiled_csl.pad_max_nnz(t, max_nnz)


# One step of a leaf path: a dict key ``['k']`` or a list index ``[3]``.
_PATH_PART = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def _walk(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs; paths spell dict keys like ``['attn']`` and list
    indices like ``[3]``."""
    if isinstance(tree, dict):
        return [pv for k, v in tree.items() for pv in _walk(v, f"{path}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [pv for i, v in enumerate(tree) for pv in _walk(v, f"{path}[{i}]")]
    return [(path, tree)]


def _replace(tree: Any, path: str, new: Any) -> Any:
    if path == "":
        return new
    m = _PATH_PART.match(path)
    rest = path[m.end():]
    if m.group(1) is not None:
        out = dict(tree)
        out[m.group(1)] = _replace(tree[m.group(1)], rest, new)
        return out
    i = int(m.group(2))
    out = list(tree)
    out[i] = _replace(tree[i], rest, new)
    return type(tree)(out)


def sparsify_params(params: Any, sparsity: float,
                    should_sparsify: Callable[[str], bool], *,
                    balanced: bool = False) -> Any:
    """Convert the selected weights of a params tree to Tiled-CSL: 2-D
    matrices, and 3-D MoE expert stacks ``[E, M, K]`` into stacked
    Tiled-CSL (``sparsify_matrix``).

    ``should_sparsify(path)`` decides per leaf. Leaves that differ only in
    list indices (one per layer) share the largest ``max_nnz`` among them,
    the reference's per-stack pad target."""
    picked: Dict[str, tiled_csl.TiledCSL] = {}
    for path, leaf in _walk(params):
        if isinstance(leaf, torch.Tensor) and leaf.dim() in (2, 3) \
                and should_sparsify(path):
            picked[path] = sparsify_matrix(leaf, sparsity, balanced=balanced)
    stack_max = stack_max_nnz(picked.items())
    out = params
    for path, t in picked.items():
        out = _replace(out, path,
                       tiled_csl.pad_max_nnz(t, stack_max[_stack_key(path)]))
    return out


def encode_in_place(tree: Any, sparsity: float,
                    should_sparsify: Callable[[str], bool], *,
                    balanced: bool = False, prefix: str = "") -> Any:
    """Replace each selected 2-D tensor leaf of ``tree`` (nested dicts and
    lists, changed in place), and each 3-D expert stack, by its own
    Tiled-CSL encoding, one leaf at a time, so that each dense source is
    freed as soon as it is encoded when the caller holds no other
    reference to it. ``should_sparsify`` sees the leaf's path with
    ``prefix`` in front. Each leaf keeps its own ``max_nnz``;
    :func:`pad_to_stack_max` evens out a stack afterwards."""
    paths = [p for p, leaf in _walk(tree)
             if isinstance(leaf, torch.Tensor) and leaf.dim() in (2, 3)
             and should_sparsify(prefix + p)]
    for path in paths:
        keys = [m.group(1) if m.group(1) is not None else int(m.group(2))
                for m in _PATH_PART.finditer(path)]
        parent = tree
        for key in keys[:-1]:
            parent = parent[key]
        parent[keys[-1]] = sparsify_matrix(parent[keys[-1]], sparsity,
                                           balanced=balanced)
    return tree


def _stack_key(path: str) -> str:
    return re.sub(r"\[\d+\]", "[*]", path)


def stack_max_nnz(leaves) -> Dict[str, int]:
    """The largest ``max_nnz`` among (path, TiledCSL) pairs whose paths
    differ only in list indices: each stack's shared pad target."""
    out: Dict[str, int] = {}
    for path, t in leaves:
        key = _stack_key(path)
        out[key] = max(out.get(key, 0), t.max_nnz)
    return out


def tiled_csl_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of every Tiled-CSL leaf of ``tree``, paths starting
    with ``prefix``."""
    return [(prefix + p, t) for p, t in _walk(tree)
            if isinstance(t, tiled_csl.TiledCSL)]


def pad_to_stack_max(tree: Any, stack_max: Dict[str, int],
                     prefix: str = "") -> Any:
    """Re-pad every Tiled-CSL leaf of ``tree`` (paths under ``prefix``) to
    its stack's target in ``stack_max``, as ``sparsify_params`` does."""
    out = tree
    for path, t in _walk(tree):
        if isinstance(t, tiled_csl.TiledCSL):
            out = _replace(out, path, tiled_csl.pad_max_nnz(
                t, stack_max[_stack_key(prefix + path)]))
    return out


def _pregroupable(ws) -> bool:
    """Same-shape plain TiledCSLs, balanced enough to share one max_nnz."""
    if not all(isinstance(w, tiled_csl.TiledCSL) for w in ws):
        return False
    key = (ws[0].shape, ws[0].m_tb, ws[0].k_tb, ws[0].words.dim())
    return all((w.shape, w.m_tb, w.k_tb, w.words.dim()) == key for w in ws) \
        and ws[0].words.dim() == 3 and sparse_linear.balanced_group(ws)


def group_projections(params: Any) -> Any:
    """Pre-group same-shape Tiled-CSL projections at reformat time:
    ``{gate, up}`` -> ``gate_up`` (G=2) and ``{wq, wk, wv}`` -> ``wqkv``
    (G=3); biases stay on the per-name dicts. MoE's bare expert stacks
    (``moe["gate"]``, not ``{"w": ...}`` dicts) are no projection group
    and stay as they are; its shared expert's ``gate``/``up`` group."""
    if not isinstance(params, dict):
        if isinstance(params, (list, tuple)):
            return type(params)(group_projections(p) for p in params)
        return params
    out = {k: group_projections(v) for k, v in params.items()}

    def w_of(name):
        sub = out.get(name)
        return sub.get("w") if isinstance(sub, dict) else None

    def take(names, new):
        out[new] = {"w": tiled_csl.group_stack([w_of(n) for n in names])}
        for name in names:
            out[name] = {k: v for k, v in out[name].items() if k != "w"}
            if not out[name]:
                del out[name]

    gate_up = [w_of("gate"), w_of("up")]
    if all(w is not None for w in gate_up) and _pregroupable(gate_up):
        take(("gate", "up"), "gate_up")
    qkv = [w_of(n) for n in ("wq", "wk", "wv")]
    if all(w is not None for w in qkv) and _pregroupable(qkv):
        take(("wq", "wk", "wv"), "wqkv")
    return out
